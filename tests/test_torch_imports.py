"""The port stands alone: no module of vipnerf_tpu_torch/, and not
chip_smoke.py, imports jax, flax, optax, msgpack or the JAX package
vipnerf_tpu, nor a library the GPU machine lacks (pandas, imageio, cv2,
simplejson, skimage, PIL); and every module of the port (the database
builders and the JAX-checkpoint bridge among them) imports with all of
those blocked, and without building or loading any library (K1, the ray
stream, nvJPEG's binding)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "vipnerf_tpu",
             "pandas", "imageio", "cv2", "simplejson", "skimage", "PIL")
PORT_FILES = sorted((ROOT / "vipnerf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


BLOCKER = """
import importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
import vipnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vipnerf_tpu_torch.__path__, "vipnerf_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
assert not any(m.split(".")[0] in {forbidden!r} for m in sys.modules), "a blocked module loaded"
from vipnerf_tpu_torch.kernels import build
assert "jpeg_decode" in build.SOURCES  # nvJPEG's binding is one of the libraries that must not build
assert not build._loaded and not build.build_seconds, "a library was built or loaded at import"
for new in ("db_builders.nerf_llff", "db_builders.dtu", "db_builders.real_estate", "utils.jax_ckpt", "utils.jpeg"):
    assert "vipnerf_tpu_torch." + new in names, new
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    code = BLOCKER.format(forbidden=set(FORBIDDEN), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    names = int(res.stdout.split()[-1])
    assert names >= 63  # every module of the port was imported, the builders and the bridge too

"""Build the sources under `csrc/` and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface, under `vipnerf_tpu_torch/build/` (ignored by git), named after a
hash of the source so an edited source rebuilds: CUDA sources (`.cu`) with
nvcc for sm_90a, host C++ sources (`.cpp`) with g++, those that call a
library of the CUDA toolkit (nvJPEG) against the toolkit's headers and
library, which must be there: a missing one raises, naming it. Nothing builds at
import: a wrapper calls `load` at its first use, and `build_all` starts one
compiler per source at once, so several libraries build in parallel. A
failed build raises with the compiler's output; nothing falls back. The
ranks of a multi-device run only load: the launching process builds every
library before it spawns them (`parallel.mesh.run_on_devices`), and a rank
that finds one missing raises instead of compiling its own copy.

Each compilation is a `kernels.build` span (`library`) of the tracer
(`utils/tracing.py`), so a build inside a measured stretch shows.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from vipnerf_tpu_torch.utils import tracing

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# library name -> source file under csrc/
SOURCES = {"fused_mlp": "fused_mlp.cu", "fused_mlp_bwd": "fused_mlp_bwd.cu",
           "fused_mlp_bwd_mma_sync": "fused_mlp_bwd_mma_sync.cu", "raystream": "raystream.cpp",
           "jpeg_decode": "jpeg_decode.cpp"}
# library name -> (header, library) of the CUDA toolkit it is built against
TOOLKIT_LIBS = {"jpeg_decode": ("nvjpeg.h", "nvjpeg")}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: Dict[str, ctypes.CDLL] = {}
_builds_forbidden = False
ptxas_reports: Dict[str, str] = {}


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _toolkit_flags(name: str) -> Tuple[List[str], List[str]]:
    """Include and link flags for a source that calls a toolkit library;
    raises naming what the toolkit lacks."""
    header, lib = TOOLKIT_LIBS[name]
    home = Path(_nvcc()).resolve().parent.parent
    includes = [d for d in (home / "include", home / "targets/x86_64-linux/include") if (d / header).exists()]
    libdirs = [d for d in (home / "lib64", home / "targets/x86_64-linux/lib") if list(d.glob(f"lib{lib}.so*"))]
    missing = ([header] if not includes else []) + ([f"lib{lib}.so"] if not libdirs else [])
    if missing:
        raise RuntimeError(f"{lib} not found: the CUDA toolkit at {home} has no {' and no '.join(missing)}, "
                           f"which {SOURCES[name]} needs")
    return [f"-I{includes[0]}", "-L" + str(libdirs[0]), f"-Wl,-rpath,{libdirs[0]}"], [f"-l{lib}"]


def _command(name: str, out: Path) -> List[str]:
    source = SOURCES[name]
    src = str(CSRC_DIR / source)
    if source.endswith(".cpp"):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host C++ sources cannot be built")
        if name in TOOLKIT_LIBS:
            flags, libs = _toolkit_flags(name)
            return [gxx, *GXX_FLAGS, *flags, "-o", str(out), src, *libs]
        return [gxx, *GXX_FLAGS, "-o", str(out), src]
    nvcc = _nvcc()
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return [nvcc, *NVCC_FLAGS, "-o", str(out), src]


def library_path(name: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile every named source that has no library yet, all compilers
    running at once, each a `kernels.build` span; raises with the
    compiler's output if one fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}  # every command first: a missing tool raises before any compiler starts
    for name in names:
        out = library_path(name)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            jobs[name] = (_command(name, tmp), tmp, out)
    procs = {
        name: (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out,
               time.perf_counter_ns())
        for name, (cmd, tmp, out) in jobs.items()
    }
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        tracing.add("kernels.build", t0, time.perf_counter_ns(), library=name)
        ptxas_reports[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}: {Path(proc.args[0]).name} exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("build failed:\n" + "\n".join(failures))


def forbid_builds():
    """From now on `load` raises for a library that is not built (a rank of
    a multi-device run, whose launcher built them all)."""
    global _builds_forbidden
    _builds_forbidden = True


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            if _builds_forbidden:
                raise RuntimeError(f"{path.name} is not built: the launching process builds every library "
                                   "before it spawns the ranks")
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]

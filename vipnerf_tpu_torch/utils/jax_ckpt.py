"""The bridge between the JAX package's checkpoints and the port's
(counterpart of vipnerf_tpu/utils/reference_ckpt.py, which bridges the JAX
package and the reference's `.tar`: in the port that `.tar` is the native
format, so this module bridges to the JAX package's `.ckpt`).

A JAX `Model_Iter{N:06}.ckpt` is flax's msgpack of {iteration_num,
model_state_dict, optimizer_state_dict} (vipnerf_tpu/train/checkpoints.py),
which this module reads and writes with a msgpack codec of its own, so
neither JAX nor flax nor msgpack need be installed:

- weights: the params tree (`coarse`/`fine`, list indices as "0", "1", ...,
  `w` (in, out) and `b`) <-> the port's state_dict (utils/convert.py);
- optimizer: the optax tree of vipnerf_tpu/train/step.py `make_optimizer`:
  `loss_guard` {inner, ema, count, skips} when `optimizer.loss_guard` is
  set, around `chain(clip_by_global_norm, adam)` {"0": {}, "1": adam} when
  `optimizer.grad_clip_norm` is set, around adam = {"0": ScaleByAdamState
  {count, mu, nu}, "1": ScaleByScheduleState {count}} <-> the port's Adam
  (moments, one count, which is both of optax's) and its guard. A tree that
  does not match the configs, or weights that do not match the model they
  build, raise.

    python -m vipnerf_tpu_torch.utils.jax_ckpt runs/training/train0001/scene/saved_models \\
        [--configs runs/training/train0001/Configs.json] [--to_jax] [--output_dir D]

imports every Model_Iter*.ckpt of a directory (or one file) as a `.tar`,
or with --to_jax exports every `.tar` as a `.ckpt`; Model_Latest ends on the
newest iteration and never moves back to an older one.
"""

import argparse
import json
import os
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF
from vipnerf_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint, update_latest_symlink
from vipnerf_tpu_torch.train.step import make_optimizer
from vipnerf_tpu_torch.utils.convert import jax_params_from_state_dict, state_dict_from_jax_params

# ----------------------------------------------------------------- msgpack
# Flax's encoding: msgpack with ndarrays as ext type 1 and numpy scalars as
# ext type 3, each holding the msgpack of [shape, dtype name, C-order
# bytes]; dicts written with their keys sorted (flax maps the tree through
# jax.tree_util first, which sorts them).

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_ARRAY_BYTES = 2 ** 30  # flax chunks larger arrays into a form this codec does not take


class MsgpackError(ValueError):
    pass


def _pack_int(n: int, out: bytearray):
    if 0 <= n < 0x80 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if n < top:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise MsgpackError(f"integer {n} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)), (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise MsgpackError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: Optional[int], fix_max: int, codes, out: bytearray):
    """A length header: the fix form below `fix_max`, else 8/16/32-bit."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} does not fit msgpack")


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise MsgpackError(f"dtype {arr.dtype} has no msgpack encoding")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise MsgpackError(f"an array of {arr.nbytes} bytes: flax writes it chunked, which this codec does not")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (np.ndarray, np.generic)):
        payload = _array_payload(np.asarray(obj))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
        out += struct.pack(">b", EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR) + payload
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif type(obj) is bytes:
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    else:
        raise MsgpackError(f"{type(obj).__name__} has no msgpack encoding in flax's checkpoints")


def packb(obj) -> bytes:
    """`obj` (dicts, lists, tuples, None, bool, int, float, str, bytes,
    numpy arrays and scalars) as flax.serialization.msgpack_serialize
    writes it."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    """`raw`: strings as bytes (an ndarray payload's dtype name, as flax
    reads it)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = data, 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated msgpack")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.read_str(self.unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        extlen = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in fixext or b in extlen:
            n = fixext[b] if b in fixext else self.unpack(extlen[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise MsgpackError(f"msgpack type byte 0x{b:02x} is not used by flax's checkpoints")

    def read_str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise MsgpackError("flax's chunked array form (arrays above 2^30 bytes) is not supported")
        return out


def _ext(code: int, payload: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise MsgpackError(f"msgpack ext type {code} is not an ndarray or a numpy scalar")
    reader = _Reader(payload, raw=True)
    header = reader.read()
    if reader.pos != len(payload) or not (isinstance(header, list) and len(header) == 3):
        raise MsgpackError("malformed ndarray payload")
    shape, name, buffer = header
    try:
        dtype = np.dtype(name.decode())
    except TypeError as e:
        raise MsgpackError(f"dtype {name!r} is not a numpy dtype") from e
    arr = np.frombuffer(buffer, dtype=dtype).reshape(shape)
    return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data: bytes):
    """What flax.serialization.msgpack_restore gives for `data` (arrays as
    read-only numpy views of the buffer, as flax gives them)."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(data):
        raise MsgpackError(f"{len(data) - reader.pos} bytes after the msgpack object")
    return obj


# ------------------------------------------------------------------ trees

def _lists_to_dicts(tree):
    """A pytree with lists -> flax's state-dict form (indices as "0", "1", ...)."""
    if isinstance(tree, dict):
        return {k: _lists_to_dicts(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _lists_to_dicts(v) for i, v in enumerate(tree)}
    return tree


def _params_tree(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return _lists_to_dicts(jax_params_from_state_dict(state_dict))


def _expect_keys(node, keys, where: str):
    if not isinstance(node, dict) or set(node) != set(keys):
        got = sorted(node) if isinstance(node, dict) else type(node).__name__
        raise ValueError(f"optimizer state does not match the configs at {where}: expected keys "
                         f"{sorted(keys)}, got {got}")
    return node


def _optimizer_tree(configs: Dict[str, Any], count: int, mu, nu, guard: Optional[Dict[str, Any]]):
    count = np.asarray(count, np.int32)
    tree = {"0": {"count": count, "mu": mu, "nu": nu}, "1": {"count": count}}
    opt = configs["optimizer"]
    if opt.get("grad_clip_norm"):
        tree = {"0": {}, "1": tree}
    if opt.get("loss_guard") is not None:
        tree = {"inner": tree, "ema": np.asarray(guard["ema"], np.float32),
                "count": np.asarray(guard["count"], np.int32), "skips": np.asarray(guard["skips"], np.int32)}
    return tree


def _read_optimizer_tree(configs: Dict[str, Any], tree) -> Dict[str, Any]:
    """(adam count, mu tree, nu tree, guard state or None) of a JAX
    optimizer state, checked against the configs' optimizer."""
    opt = configs["optimizer"]
    guard = None
    where = "optimizer_state_dict"
    if opt.get("loss_guard") is not None:
        _expect_keys(tree, ("inner", "ema", "count", "skips"), where)
        guard = {"ema": float(tree["ema"]), "count": int(tree["count"]), "skips": int(tree["skips"])}
        tree, where = tree["inner"], where + "/inner"
    if opt.get("grad_clip_norm"):
        _expect_keys(tree, ("0", "1"), where)
        _expect_keys(tree["0"], (), where + "/0")
        tree, where = tree["1"], where + "/1"
    _expect_keys(tree, ("0", "1"), where)
    adam = _expect_keys(tree["0"], ("count", "mu", "nu"), where + "/0")
    schedule = _expect_keys(tree["1"], ("count",), where + "/1")
    if int(adam["count"]) != int(schedule["count"]):
        raise ValueError(f"Adam's count {int(adam['count'])} differs from the schedule's {int(schedule['count'])}")
    return {"count": int(adam["count"]), "mu": adam["mu"], "nu": adam["nu"], "guard": guard}


def _checked_state_dict(tree, model: ViPNeRF, what: str) -> Dict[str, torch.Tensor]:
    """A params-shaped tree -> a state_dict in `model`'s key order, checked
    against the model's keys and shapes."""
    sd = state_dict_from_jax_params(tree)
    want = model.state_dict()
    if set(sd) != set(want):
        raise ValueError(f"{what} do not match the model built from the configs:\n"
                         f"  missing {sorted(set(want) - set(sd))}\n  unexpected {sorted(set(sd) - set(want))}")
    for key, value in want.items():
        if sd[key].shape != value.shape:
            raise ValueError(f"{what}: shape mismatch at {key}: configs {tuple(value.shape)} vs "
                             f"checkpoint {tuple(sd[key].shape)}")
    return {key: sd[key] for key in want}


def _model_and_optimizer(configs: Dict[str, Any]):
    model = ViPNeRF(configs)
    return model, make_optimizer(configs, model.parameters())


# ---------------------------------------------------------------- bridges

def import_checkpoint(ckpt_path: Path, configs: Dict[str, Any], output_dir: Optional[Path] = None) -> Path:
    """A JAX Model_Iter{N}.ckpt -> the port's Model_Iter{N}.tar in
    `output_dir` (default: beside it), with its weights, Adam moments and
    count and loss-guard state; Model_Latest.tar is refreshed."""
    ckpt_path = Path(ckpt_path)
    state = unpackb(ckpt_path.read_bytes())
    _expect_keys(state, ("iteration_num", "model_state_dict", "optimizer_state_dict"), ckpt_path.name)
    model, optimizer = _model_and_optimizer(configs)
    model.load_state_dict(_checked_state_dict(state["model_state_dict"], model, "the weights"))
    adam = _read_optimizer_tree(configs, state["optimizer_state_dict"])
    mu = _checked_state_dict(adam["mu"], model, "Adam's first moments")
    nu = _checked_state_dict(adam["nu"], model, "Adam's second moments")
    opt_state = {"state": {i: {"step": torch.tensor(float(adam["count"])), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
                           for i, k in enumerate(mu)}}
    if adam["guard"] is not None:
        opt_state["loss_guard"] = adam["guard"]
    optimizer.load_state_dict(opt_state)
    return save_checkpoint(Path(output_dir) if output_dir else ckpt_path.parent, int(state["iteration_num"]),
                           model, optimizer)


def export_checkpoint(tar_path: Path, configs: Dict[str, Any], output_dir: Optional[Path] = None) -> Path:
    """The port's (or the reference's) Model_Iter{N}.tar -> a JAX
    Model_Iter{N}.ckpt in `output_dir` (default: beside it), which the JAX
    package's `load_checkpoint` restores into its templates; the optimizer
    state is read as the port's `Adam` loads it. Model_Latest.ckpt is
    refreshed."""
    tar_path = Path(tar_path)
    model, optimizer = _model_and_optimizer(configs)
    iteration_num = load_checkpoint(tar_path, model, optimizer)
    sd = model.state_dict()
    moments = [dict(zip(sd, (m.reshape(s) for m, s in zip(flat[0].split(optimizer.sizes), optimizer.shapes))))
               for flat in (optimizer.exp_avg, optimizer.exp_avg_sq)]
    guard = optimizer.guard.state(0) if optimizer.guard is not None else None
    state = {
        "iteration_num": iteration_num,
        "model_state_dict": _params_tree(sd),
        "optimizer_state_dict": _optimizer_tree(configs, int(optimizer.count[0]), _params_tree(moments[0]),
                                                _params_tree(moments[1]), guard),
    }
    out_dir = Path(output_dir) if output_dir else tar_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"Model_Iter{iteration_num:06}.ckpt"
    tmp = path.with_suffix(".ckpt.tmp")
    tmp.write_bytes(packb(state))
    os.replace(tmp, path)
    update_latest_symlink(out_dir, path)
    return path


def _find_configs(path: Path) -> Dict[str, Any]:
    """The run's Configs.json beside or above a checkpoint path."""
    path = Path(path)
    for parent in ([path] if path.is_dir() else []) + list(path.parents):
        candidate = parent / "Configs.json"
        if candidate.exists():
            return json.loads(candidate.read_text())
    raise FileNotFoundError(f"no Configs.json found above {path}; pass --configs explicitly")


def _iteration_files(path: Path, suffix: str) -> List[Path]:
    if not path.is_dir():
        return [path]
    files = sorted((p for p in path.glob(f"Model_Iter*{suffix}") if not p.is_symlink()),
                   key=lambda p: int(p.stem.replace("Model_Iter", "")))
    if not files:
        raise FileNotFoundError(f"no Model_Iter*{suffix} under {path}")
    return files


def import_run(path: Path, configs: Optional[Dict[str, Any]] = None, output_dir: Optional[Path] = None) -> List[Path]:
    """Import one .ckpt, or every Model_Iter*.ckpt of a saved_models dir in
    ascending order, so Model_Latest.tar ends on the newest."""
    path = Path(path)
    configs = configs if configs is not None else _find_configs(path)
    return [import_checkpoint(p, configs, output_dir) for p in _iteration_files(path, ".ckpt")]


def export_run(path: Path, configs: Optional[Dict[str, Any]] = None, output_dir: Optional[Path] = None) -> List[Path]:
    """Export one .tar, or every Model_Iter*.tar of a saved_models dir in
    ascending order, so Model_Latest.ckpt ends on the newest."""
    path = Path(path)
    configs = configs if configs is not None else _find_configs(path)
    return [export_checkpoint(p, configs, output_dir) for p in _iteration_files(path, ".tar")]


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m vipnerf_tpu_torch.utils.jax_ckpt",
        description="Bring the JAX package's .ckpt checkpoints to the port's .tar, or back with --to_jax")
    parser.add_argument("path", help="a Model_Iter* checkpoint, or a saved_models directory (every iteration in it)")
    parser.add_argument("--configs", help="the run's Configs.json (default: found beside or above the path)")
    parser.add_argument("--output_dir", help="where to write (default: beside each checkpoint)")
    parser.add_argument("--to_jax", action="store_true", help="export the port's .tar files as JAX .ckpt files")
    args = parser.parse_args(argv)
    configs = json.loads(Path(args.configs).read_text()) if args.configs else None
    output_dir = Path(args.output_dir) if args.output_dir else None
    written = (export_run if args.to_jax else import_run)(Path(args.path), configs, output_dir)
    for p in written:
        print(p)


if __name__ == "__main__":
    main()

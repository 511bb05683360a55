"""The C++ ray-index stream (`csrc/raystream.cpp`), loaded with ctypes.

The counterpart of vipnerf_tpu/native: the same source and C ABI, so a
stream seeded alike gives the JAX package's native index streams index for
index. The library is built with g++ by `kernels.build` at the first stream
(never at import); a failed build raises with the compiler's output, where
the JAX package quietly falls back to its numpy streams.
"""

import ctypes
from typing import Optional

import numpy as np

from vipnerf_tpu_torch.kernels import build


def _lib() -> ctypes.CDLL:
    lib = build.load("raystream")
    if lib.raystream_create.restype is not ctypes.c_void_p:
        lib.raystream_create.restype = ctypes.c_void_p
        lib.raystream_create.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
        lib.raystream_destroy.argtypes = [ctypes.c_void_p]
        lib.raystream_size.restype = ctypes.c_int64
        lib.raystream_size.argtypes = [ctypes.c_void_p]
        lib.raystream_reset.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.raystream_next_block.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_void_p]
    return lib


def _candidates(candidates: Optional[np.ndarray], count: Optional[int]):
    """(array kept alive for the call, its pointer or None, count)."""
    if candidates is None:
        return None, None, int(count)
    arr = np.ascontiguousarray(candidates, dtype=np.int32)
    return arr, arr.ctypes.data_as(ctypes.c_void_p), len(arr)


class NativeRayStream:
    """Epoch-shuffled index stream: sequential slices of a permutation of the
    candidates (0..count-1 without them), a reshuffle at the epoch's end, a
    short tail wrapping into the fresh permutation."""

    def __init__(self, seed: int, candidates: Optional[np.ndarray] = None, count: Optional[int] = None):
        self._lib = _lib()
        _keep, ptr, count = _candidates(candidates, count)
        if count <= 0:
            raise ValueError("a ray stream needs at least one candidate index")
        self._handle = self._lib.raystream_create(ptr, count, int(seed) & (2**64 - 1))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.raystream_destroy(handle)
            self._handle = None

    @property
    def size(self) -> int:
        return int(self._lib.raystream_size(self._handle))

    def reset(self, candidates: Optional[np.ndarray] = None, count: Optional[int] = None):
        """A new candidate set (0..count-1 without candidates), reshuffled;
        the cursor goes back to 0."""
        _keep, ptr, count = _candidates(candidates, count)
        self._lib.raystream_reset(self._handle, ptr, count)

    def next_block(self, k: int, batch: int) -> np.ndarray:
        out = np.empty((k, batch), dtype=np.int32)
        self._lib.raystream_next_block(self._handle, k, batch, out.ctypes.data_as(ctypes.c_void_p))
        return out

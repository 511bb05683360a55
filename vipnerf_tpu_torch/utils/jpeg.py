"""JPEG decoding with nvJPEG on the card (binding: csrc/jpeg_decode.cpp).

The JAX package reads JPEGs with imageio on the host; the GPU machine has
no host JPEG decoder (no PIL, imageio, cv2 or torchvision), so the port
decodes on the card. There is no other path: a JPEG to be decoded on the
CPU, or where CUDA or the toolkit's nvJPEG is missing, raises, naming what
is missing. The binding builds at the first decode, never at import.

nvJPEG and libjpeg differ in the IDCT and the chroma upsampling, so a
decode agrees with imageio's to a PSNR, not bit for bit (chip_smoke.py
measures it on a 4:2:0 fixture). Each decode counts `jpeg.decodes` in the
tracer's table (`utils/tracing.py`).
"""

import ctypes

import torch

from vipnerf_tpu_torch.kernels import build
from vipnerf_tpu_torch.utils import tracing

JPEG_SIGNATURE = b"\xff\xd8\xff"
_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED",
           5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
           9: "IMPLEMENTATION_NOT_SUPPORTED"}


def _lib() -> ctypes.CDLL:
    lib = build.load("jpeg_decode")
    if not getattr(lib, "_typed", False):
        lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.jpeg_decode.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(status: int, what: str):
    if status:
        raise RuntimeError(f"nvJPEG failed {what}: NVJPEG_STATUS_{_STATUS.get(status, status)}")


def decode_jpeg(data: bytes, device="cuda") -> torch.Tensor:
    """The JPEG `data` as a uint8 tensor on the CUDA `device`: (h, w, 3) RGB,
    or (h, w) for a grayscale JPEG (as imageio reads it)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"JPEG decoding runs on nvJPEG on a CUDA device; asked for {device}. "
                           "The port has no host JPEG decoder: convert the frames to PNG to read them on the CPU")
    if not torch.cuda.is_available():
        raise RuntimeError("JPEG decoding needs nvJPEG on a CUDA device, and CUDA is not available")
    lib = _lib()
    components, subsampling, width, height = (ctypes.c_int() for _ in range(4))
    _check(lib.jpeg_info(data, len(data), ctypes.byref(components), ctypes.byref(subsampling),
                         ctypes.byref(width), ctypes.byref(height)), "reading the header")
    gray = components.value == 1
    h, w = height.value, width.value
    out = torch.empty((h, w) if gray else (h, w, 3), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib.jpeg_decode(data, len(data), int(gray), out.data_ptr(), w * (1 if gray else 3), stream),
               "decoding")
    tracing.count("jpeg.decodes")
    return out

"""Image and array output with the standard library and numpy only.

Semantics of vipnerf_tpu/utils/io.py `save_image` / `save_numpy_array`
(arrays saved as .npy, their PNG normalised by the array's max). PNGs are
written by `write_png`, an 8-bit grayscale/RGB/RGBA encoder on zlib.
"""

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def write_png(path, image: np.ndarray) -> None:
    """Write a uint8 (h, w) or (h, w, 1|3|4) array as a PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    if c not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    raw = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 on every row
    raw[:, 1:] = image.reshape(h, w * c)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    blob = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(blob)


def save_image(path, image: np.ndarray):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(image.flat[0], np.floating):
        image = np.round(image * 255).astype("uint8")
    if path.suffix == ".png":
        write_png(path, image)
    elif path.suffix == ".npy":
        np.save(path.as_posix(), image)
    else:
        raise RuntimeError(f"Unknown image format: {path.as_posix()}")


def save_numpy_array(path, data_array: np.ndarray, as_png: bool = False):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    max_val = data_array.max()
    denom = max_val if max_val > 0 else 1
    data_image = np.round(data_array / denom * 255).astype("uint8")
    if path.suffix == ".png":
        write_png(path, data_image)
    elif path.suffix == ".npy":
        np.save(path.as_posix(), data_array)
        if as_png:
            write_png(path.parent / f"{path.stem}.png", data_image)
    else:
        raise RuntimeError(f"Unknown data format: {path.as_posix()}")

"""Image, array, CSV and video I/O with the standard library and numpy only.

Semantics of vipnerf_tpu/utils/io.py `read_image` / `read_mask` /
`save_image` / `save_numpy_array` (arrays saved as .npy, their PNG
normalised by the array's max; a mask is a PNG == 255), `rescale_image`
(OpenCV's INTER_AREA / INTER_LINEAR downscale, as separable weight
matrices) and `save_video` (always its no-codec branch: a directory of
frames). PNGs are written by `write_png`, an 8-bit grayscale/RGB/RGBA
encoder on zlib, and read by `read_png`, which decodes 8-bit non-interlaced
grayscale, grey+alpha, RGB and RGBA with all five row filters. `read_image`
also reads JPEGs, through nvJPEG on the card (`utils/jpeg.py`). CSVs with a
header are read by `read_csv_columns` and written by `write_csv_columns`,
with pandas' number and NaN conventions.
"""

import csv
import math
import struct
import zlib
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from vipnerf_tpu_torch.utils.jpeg import JPEG_SIGNATURE, decode_jpeg

_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: np.ndarray, w: int, c: int) -> np.ndarray:
    """Undo the PNG row filters of `raw` (h, 1 + w * c) -> uint8 (h, w * c)."""
    types, rows = raw[:, 0], raw[:, 1:]
    if types.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {types.max()}")
    if (types <= 2).all():  # None, Sub and Up decode a row at once
        image = np.empty_like(rows)
        prev = np.zeros(w * c, np.uint8)
        for y, ftype in enumerate(types):
            row = rows[y]
            if ftype == 1:  # Sub: a running sum mod 256 along each byte of a pixel
                row = (np.cumsum(row.reshape(w, c), axis=0, dtype=np.int64) % 256).astype(np.uint8).ravel()
            elif ftype == 2:  # Up
                row = row + prev
            prev = image[y] = row
        return image
    # Average and Paeth predict a pixel from the decoded pixel to its left, so
    # a row decodes pixel by pixel. Pixel (y, x) needs only the pixels left of,
    # above and above-left of it, which lie on earlier anti-diagonals y + x:
    # each anti-diagonal decodes at once, every pixel under its row's filter.
    # The image is sheared so that anti-diagonal d is the slab skew[d + 2] and
    # pixel (y, x) is skew[y + x + 2, y + 1]; its left and upper neighbours are
    # then skew[d + 1, y + 1] and skew[d + 1, y], its upper-left skew[d, y],
    # and the slots outside the image stay 0, as the filters define them.
    h = rows.shape[0]
    ys, xs = np.divmod(np.arange(h * w), w)
    filt = np.zeros((h + w - 1, h, c), np.int32)
    filt[ys + xs, ys] = rows.reshape(h * w, c)
    skew = np.zeros((h + w + 1, h + 1, c), np.int32)
    kind = [(types == k)[:, None] for k in (1, 2, 3, 4)]
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a, b, cc = skew[d + 1, y0 + 1:y1 + 1], skew[d + 1, y0:y1], skew[d, y0:y1]
        pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        sub, up, avg, pae = (k[y0:y1] for k in kind)
        pred = sub * a + up * b + avg * ((a + b) >> 1) + pae * paeth
        skew[d + 2, y0 + 1:y1 + 1] = (filt[d, y0:y1] + pred) & 0xFF
    return skew[ys + xs + 2, ys + 1].astype(np.uint8).reshape(h, w * c)


def read_png(path) -> np.ndarray:
    """An 8-bit PNG as uint8 (h, w) (grayscale) or (h, w, c)."""
    blob = Path(path).read_bytes()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: read_png takes 8-bit non-interlaced gray/RGB/RGBA, got depth "
            f"{depth}, colour type {color}, interlace {interlace}"
        )
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    image = _unfilter(raw, w, c)
    return image.reshape(h, w) if c == 1 else image.reshape(h, w, c)


def read_image(path, device="cuda") -> np.ndarray:
    """A PNG (the port's own decoder, on the host) or a JPEG (nvJPEG on the
    CUDA `device`; on the CPU, or without CUDA or nvJPEG, it raises) as a
    uint8 array."""
    with open(path, "rb") as f:
        head = f.read(3)
    if head == JPEG_SIGNATURE:
        return decode_jpeg(Path(path).read_bytes(), device).cpu().numpy()
    return read_png(path)


def read_mask(path) -> np.ndarray:
    return read_image(path) == 255


def _parse_cell(kind, value: str):
    return math.nan if kind is float and value == "" else kind(value)


def read_csv_columns(path) -> Dict[str, np.ndarray]:
    """A CSV with a header row -> {column: numpy array}, numeric where every
    value of the column parses as a number (int if all are integers; an
    empty field is NaN, as pandas reads it). A CSV with no rows gives each
    column as an empty float array."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        rows = [r for r in reader if r]
    out = {}
    for i, name in enumerate(header):
        values = [r[i] for r in rows]
        for kind in (int, float):
            try:
                out[name] = np.array([_parse_cell(kind, v) for v in values])
                break
            except ValueError:
                continue
        else:
            out[name] = np.array(values)
    return out


def _csv_cell(value) -> str:
    if isinstance(value, (float, np.floating)) and math.isnan(value):
        return ""
    return str(value)  # numpy scalars print their shortest round-trip form in their own precision


def write_csv_columns(path, columns: Dict[str, Sequence]) -> None:
    """Write {column: values} as a CSV with a header row, as pandas'
    `to_csv(index=False)` writes it: numbers in their shortest round-trip
    form, NaN as an empty field."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(columns))
        for row in zip(*columns.values()):
            writer.writerow([_csv_cell(v) for v in row])


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


def _area_weights(src: int, dst: int, scale: float) -> np.ndarray:
    """(dst, src) weights of OpenCV's INTER_AREA downscale along one axis
    (its `computeResizeAreaTab`): an output cell of `scale` input pixels
    averages the pixels it overlaps, each by its overlap; a sliver of under
    1e-3 of a pixel is dropped. For an integer `scale` this is the block mean."""
    weights = np.zeros((dst, src), np.float32)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            weights[d, s1 - 1] += np.float32((s1 - f1) / cell)
        weights[d, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            weights[d, s2] += np.float32(min(f2 - s2, 1.0, cell) / cell)
    return weights


def _linear_weights(src: int, dst: int, scale: float) -> np.ndarray:
    """(dst, src) weights of OpenCV's INTER_LINEAR along one axis: output
    pixel d samples input position (d + 0.5) * scale - 0.5, clamped to the
    first and last pixel."""
    weights = np.zeros((dst, src), np.float32)
    for d in range(dst):
        pos = (d + 0.5) * scale - 0.5
        s = math.floor(pos)
        frac = pos - s
        if s < 0:
            s, frac = 0, 0.0
        if s >= src - 1:
            s, frac = src - 1, 0.0
        weights[d, s] += np.float32(1.0 - frac)
        if frac:
            weights[d, s + 1] += np.float32(frac)
    return weights


def rescale_image(
    image: np.ndarray, downsampling_factor: float, *, anti_aliasing: bool = True
) -> np.ndarray:
    """Downscale an (h, w) or (h, w, c) image by `downsampling_factor` to
    (int(h / f), int(w / f)) in f32: OpenCV's INTER_AREA when anti-aliasing
    (the JAX package's cv2.resize), else INTER_LINEAR, computed per channel
    as Ry @ image @ Rx^T with the exact one-axis weight matrices."""
    if downsampling_factor < 1:
        raise ValueError(f"rescale_image downscales; got factor {downsampling_factor}")
    h, w = image.shape[:2]
    return resize_image(image, (int(h / downsampling_factor), int(w / downsampling_factor)),
                        anti_aliasing=anti_aliasing)


def resize_image(image: np.ndarray, size, *, anti_aliasing: bool = True) -> np.ndarray:
    """Downscale an (h, w) or (h, w, c) image to `size` (new_h, new_w) in
    f32, as `cv2.resize(image, (new_w, new_h))` with INTER_AREA (or
    INTER_LINEAR without anti-aliasing) computes it before its rounding."""
    h, w = image.shape[:2]
    new_h, new_w = size
    if new_h > h or new_w > w:
        raise ValueError(f"resize_image downscales; asked for {size} from {(h, w)}")
    # OpenCV's scale: the inverse of dsize / ssize, in double precision
    scale_y, scale_x = 1.0 / (new_h / h), 1.0 / (new_w / w)
    one_axis = _area_weights if anti_aliasing else _linear_weights
    ry, rx = one_axis(h, new_h, scale_y), one_axis(w, new_w, scale_x)
    img = np.asarray(image, np.float32)
    rows = (ry @ img.reshape(h, -1)).reshape(new_h, w, -1)  # (new_h, w, c)
    out = rx @ rows.transpose(1, 0, 2).reshape(w, -1)  # (new_w, new_h * c)
    return out.reshape(new_w, new_h, -1).transpose(1, 0, 2).reshape(new_h, new_w, *image.shape[2:])


def save_video(path, frames: np.ndarray) -> None:
    """Write (t, h, w, 3) uint8 frames as {stem}_frames/{i:04}.png beside
    `path`: the no-codec branch of the JAX package's save_video, since the
    GPU machine has no video encoder. Returns None, as that branch does."""
    path = Path(path)
    frames_dir = path.parent / f"{path.stem}_frames"
    frames_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        write_png(frames_dir / f"{i:04}.png", np.asarray(frame))
    print(f"save_video: no video encoder; {len(frames)} frames written to {frames_dir}", flush=True)

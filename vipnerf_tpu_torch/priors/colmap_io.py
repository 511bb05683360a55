"""COLMAP model I/O (a copy of vipnerf_tpu/priors/colmap_io.py, which
imports no JAX): readers of the binary model formats (cameras, images,
points3D), quaternion <-> rotation, and the two SQLite operations the
sparse-depth pipeline needs (set a camera's parameters, look up an image id);
and writers of the cameras and images formats, which forge a raw scene for
the database builders' checks (`data/synthetic.py` `write_raw_llff_scene`).
"""

import sqlite3
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w, x, y, z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (n, 2)
    point3d_ids: np.ndarray  # (n,) -1 when unmatched

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) quaternion."""
    m = r
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z])


def _read(fh, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as fh:
        (num,) = _read(fh, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            model, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{n_params}d"))
            cameras[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return cameras


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as fh:
        (num,) = _read(fh, "<Q")
        for _ in range(num):
            image_id, qw, qx, qy, qz, tx, ty, tz, camera_id = _read(fh, "<idddddddi")
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(fh, "<Q")
            # per-point layout is x(double), y(double), point3D_id(INT64) —
            # 'ddq', not 'ddd' (reference colmap_read_model.py:191-192);
            # decoding the id as a double reinterprets its bits (-1 -> NaN)
            data = np.frombuffer(
                fh.read(24 * n_pts),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]),
                count=n_pts,
            )
            xys = np.stack([data["x"], data["y"]], axis=1)
            ids = data["id"].astype(np.int64)
            images[image_id] = ColmapImage(
                image_id,
                np.array([qw, qx, qy, qz]),
                np.array([tx, ty, tz]),
                camera_id,
                name.decode("utf-8"),
                xys,
                ids,
            )
    return images


def write_cameras_binary(path, cameras: Dict[int, ColmapCamera]):
    model_ids = {name: i for i, (name, _) in _CAMERA_MODELS.items()}
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            fh.write(struct.pack("<iiQQ", cam.id, model_ids[cam.model], cam.width, cam.height))
            fh.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(path, images: Dict[int, ColmapImage]):
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for im in images.values():
            fh.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            fh.write(im.name.encode("utf-8") + b"\x00")
            fh.write(struct.pack("<Q", len(im.xys)))
            points = np.zeros(len(im.xys), dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]))
            points["x"], points["y"], points["id"] = im.xys[:, 0], im.xys[:, 1], im.point3d_ids
            fh.write(points.tobytes())


def read_points3d_binary(path) -> Dict[int, ColmapPoint3D]:
    points = {}
    with open(path, "rb") as fh:
        (num,) = _read(fh, "<Q")
        for _ in range(num):
            pt_id, x, y, z, r, g, b, error = _read(fh, "<QdddBBBd")
            (track_len,) = _read(fh, "<Q")
            track = np.array(_read(fh, f"<{2 * track_len}i")).reshape(track_len, 2)
            points[pt_id] = ColmapPoint3D(
                pt_id,
                np.array([x, y, z]),
                np.array([r, g, b]),
                error,
                track[:, 0],
                track[:, 1],
            )
    return points


def update_camera_params(db_path, camera_id: int, params: np.ndarray, model: int = 6):
    """Overwrite the auto-detected intrinsics in a COLMAP database with known
    values (reference sparse_depth/Tester01.py:84-91)."""
    blob = np.asarray(params, np.float64).tobytes()
    db = sqlite3.connect(str(db_path))
    db.execute(
        "UPDATE cameras SET model=?, params=? WHERE camera_id=?",
        (model, blob, camera_id),
    )
    db.commit()
    db.close()


def get_image_id_by_name(db_path, name: str) -> int:
    db = sqlite3.connect(str(db_path))
    rows = db.execute(
        "SELECT image_id FROM images WHERE name=?", (name,)
    ).fetchall()
    db.close()
    assert len(rows) == 1, f"expected 1 image named {name}, found {len(rows)}"
    return rows[0][0]

"""The benchmark's synthetic scene, frozen here so that a change to the
program cannot move it: a copy of `vipnerf_tpu_torch/data/synthetic.py`'s
`SphereScene`, `make_dtu_scene`, `make_camera_ring` and
`write_synthetic_database`, with its own PNG writer.

Coloured spheres inside a textured shell, ray-traced exactly, on an arc of
cameras looking at the origin, written in the reference database layout
that the port's loaders read: frames, intrinsics, extrinsics, depth bounds,
split CSVs, sparse depths and visibility masks. Unlike the original, the
writer returns the sparse depths as the CSVs hold them (six decimals), so
that the plain reference reads the same numbers as the program without
reading a file back.
"""

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def write_png(path: Path, image: np.ndarray) -> None:
    """A uint8 (h, w) or (h, w, 1|3|4) array as a PNG (filter 0 on every row)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 1:] = image.reshape(h, w * c)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                     + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def look_at_w2c(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """World-to-camera extrinsic at `eye` looking at `target` (Colmap: +z forward)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd], axis=0)
    w2c = np.eye(4)
    w2c[:3, :3] = r
    w2c[:3, 3] = -r @ eye
    return w2c


class SphereScene:
    """A few emissive spheres inside an enclosing textured shell; every ray
    hits geometry."""

    def __init__(self, seed: int = 0, num_spheres: int = 4, shell_radius: float = 6.0):
        rng = np.random.default_rng(seed)
        self.centers = rng.uniform(-0.6, 0.6, size=(num_spheres, 3))
        self.centers[:, 2] = rng.uniform(-0.5, 0.5, size=num_spheres)
        self.radii = rng.uniform(0.15, 0.3, size=num_spheres)
        self.colors = rng.uniform(0.2, 1.0, size=(num_spheres, 3))
        self.shell_radius = shell_radius

    @staticmethod
    def _shell_color(points: np.ndarray) -> np.ndarray:
        px, py, pz = points[..., 0], points[..., 1], points[..., 2]
        r = 0.5 + 0.35 * np.sin(1.3 * px) * np.cos(0.9 * py)
        g = 0.45 + 0.35 * np.sin(1.1 * py + 1.0) * np.cos(0.7 * pz)
        b = 0.55 + 0.3 * np.sin(0.8 * pz + 2.0) * np.cos(1.2 * px)
        return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)

    def render(self, w2c: np.ndarray, intrinsic: np.ndarray, h: int, w: int):
        """Ray-traced rgb (h, w, 3) in [0, 1] and camera z-depth (h, w)."""
        c2w = np.linalg.inv(w2c)
        x, y = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64), indexing="xy")
        pix = np.stack([x, y, np.ones_like(x)], axis=-1)
        dirs_cam = pix @ np.linalg.inv(intrinsic).T
        dirs = dirs_cam @ c2w[:3, :3].T
        dirs = dirs / np.linalg.norm(dirs, axis=-1)[..., None]
        origin = c2w[:3, 3]

        b = np.sum(dirs * origin, axis=-1)  # the shell is centred at the origin
        disc = b ** 2 - (np.sum(origin ** 2) - self.shell_radius ** 2)
        t_best = -b + np.sqrt(np.maximum(disc, 0.0))
        color = self._shell_color(origin + dirs * t_best[..., None])
        for c, r, col in zip(self.centers, self.radii, self.colors):
            oc = origin - c
            b = np.sum(dirs * oc, axis=-1)
            disc = b ** 2 - (np.sum(oc ** 2) - r ** 2)
            hit = disc > 0
            t = -b - np.sqrt(np.where(hit, disc, 0.0))
            valid = hit & (t > 1e-3) & (t < t_best)
            t_best = np.where(valid, t, t_best)
            color = np.where(valid[..., None], col, color)
        return color, t_best / np.linalg.norm(dirs_cam, axis=-1)


def make_camera_ring(num_cameras: int, radius: float = 3.0, height: float = 0.4,
                     spread_deg: float = 40.0) -> np.ndarray:
    """w2c extrinsics on an arc looking at the origin (forward-facing rig)."""
    angles = np.deg2rad(np.linspace(-spread_deg / 2, spread_deg / 2, num_cameras))
    return np.stack([
        look_at_w2c(np.array([radius * np.sin(a), height, radius * np.cos(a)]), np.zeros(3),
                    np.array([0.0, 1.0, 0.0]))
        for a in angles
    ])


def intrinsic_matrix(height: int, width: int, focal_factor: float) -> np.ndarray:
    focal = focal_factor * width
    return np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1.0]])


def scene_dirname(scene_name: str, dataset: str) -> str:
    return scene_name if dataset == "NeRF_LLFF" else f"{int(scene_name):05}"


def write_synthetic_database(
    root: Path, *, dataset: str, scene_name: str, num_frames: int, set_num: int, train_frames,
    val_frames, height: int, width: int, seed: int, focal_factor: float = 0.9,
    resolution_suffix: str = "", shell_radius: float = 6.0, ring_radius: float = 3.0,
    ring_height: float = 0.4, sparse_depth_dirname: str = "DE02", visibility_dirname: str = "VW02",
    render_frames: Optional[list] = None,
) -> Dict[str, object]:
    """Write the scene under root/{dataset}/data. Frames outside
    `render_frames` (default: every frame) are written as flat grey images,
    since only their poses are read. Returns the ground truth: images,
    depths, extrinsics, intrinsic, the sparse depths {frame: (x, y, depth)}
    as written, and the visibility masks {(f1, f2): (h, w) bool}."""
    root = Path(root)
    scene = SphereScene(seed=seed, shell_radius=shell_radius)
    split_dir = {"NeRF_LLFF": "all", "DTU": "all"}[dataset]
    data_dir = root / dataset / "data"
    scene_key = "scene_name" if dataset == "NeRF_LLFF" else "scene_num"
    scene_dir_name = scene_dirname(scene_name, dataset)
    scene_dir = data_dir / f"{split_dir}/database_data/{scene_dir_name}"
    rgb_dir = scene_dir / f"rgb{resolution_suffix}"

    intrinsic = intrinsic_matrix(height, width, focal_factor)
    extrinsics = make_camera_ring(num_frames, radius=ring_radius, height=ring_height)
    render_frames = list(range(num_frames)) if render_frames is None else list(render_frames)
    images = np.full((num_frames, height, width, 3), 128, np.uint8)
    depths = np.ones((num_frames, height, width))
    for i in render_frames:
        rgb, depth = scene.render(extrinsics[i], intrinsic, height, width)
        images[i] = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        depths[i] = depth
    for i in range(num_frames):
        write_png(rgb_dir / f"{i:04}.png", images[i])

    np.savetxt(scene_dir / "CameraExtrinsics.csv", extrinsics.reshape(num_frames, 16), delimiter=",")
    np.savetxt(scene_dir / f"CameraIntrinsics{resolution_suffix}.csv",
               np.tile(intrinsic.reshape(1, 9), (num_frames, 1)), delimiter=",")
    pos = np.where(depths > 0, depths, np.inf)
    bounds = np.stack([np.minimum(pos.reshape(num_frames, -1).min(1), 1e3) * 0.8,
                       depths.reshape(num_frames, -1).max(1) * 1.2 + 1.0], axis=1)
    np.savetxt(scene_dir / "DepthBounds.csv", bounds, delimiter=",")

    sets_dir = data_dir / f"train_test_sets/set{set_num:02}"
    sets_dir.mkdir(parents=True, exist_ok=True)
    scene_val = scene_name if dataset == "NeRF_LLFF" else int(scene_name)
    test_frames = [f for f in range(num_frames) if f not in train_frames and f not in val_frames]
    for mode, frames in (("Train", train_frames), ("Validation", val_frames), ("Test", test_frames)):
        path = sets_dir / f"{mode}VideosData.csv"
        kept = [row for row in (path.read_text().splitlines()[1:] if path.exists() else [])
                if row and row.split(",")[0] != str(scene_val)]  # other scenes' rows stay
        lines = [f"{scene_key},pred_frame_num"] + kept + [f"{scene_val},{f}" for f in frames]
        path.write_text("\n".join(lines) + "\n")

    sparse = {}
    rng = np.random.default_rng(seed + 1)
    sd_dir = data_dir / (f"{split_dir}/estimated_depths/{sparse_depth_dirname}/{scene_dir_name}/"
                         f"estimated_depths{resolution_suffix}")
    sd_dir.mkdir(parents=True, exist_ok=True)
    for f in train_frames:
        ys, xs = np.where(depths[f] > 0)
        k = min(max(200, height * width // 25), len(xs))
        sel = rng.choice(len(xs), size=k, replace=False)
        rows, pts = ["x,y,depth,reprojection_error"], []
        for j in sel:
            d = f"{depths[f][ys[j], xs[j]]:.6f}"
            rows.append(f"{xs[j]},{ys[j]},{d},{rng.uniform(0.1, 1.0):.4f}")
            pts.append((xs[j], ys[j], float(d)))
        (sd_dir / f"{f:04}.csv").write_text("\n".join(rows) + "\n")
        sparse[f] = np.array(pts, dtype=np.float64)

    masks = {}
    vis_dir = data_dir / f"{split_dir}/visibility_prior/{visibility_dirname}/{scene_dir_name}"
    for f1 in train_frames:
        for f2 in train_frames:
            if f1 != f2:
                masks[f1, f2] = depths[f1] > 0
                write_png(vis_dir / f"visibility_masks/{f1:04}_{f2:04}.png", masks[f1, f2].astype(np.uint8) * 255)
    return {"images": images, "depths": depths, "extrinsics": extrinsics, "intrinsic": intrinsic,
            "bounds": bounds, "sparse": sparse, "masks": masks}

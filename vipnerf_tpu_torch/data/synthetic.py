"""A synthetic scene written in the reference database layout (a copy of
vipnerf_tpu/data/synthetic.py `SphereScene`, `make_dtu_scene`,
`make_camera_ring` and `write_synthetic_database` that writes its PNGs with the port's own
encoder): coloured spheres inside a textured shell, ray-traced exactly, on a
forward-facing arc of cameras, with sparse depths and visibility priors.
The output is byte for byte what the JAX package writes for the same
arguments, up to the PNG encoding, and both packages' loaders read it.

`write_raw_llff_scene` writes the same scene as a raw NeRF-LLFF download
(nerf_llff_data/<scene>/ with its COLMAP model), for the database builders.
"""

import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from vipnerf_tpu_torch.priors import colmap_io
from vipnerf_tpu_torch.utils.io import rescale_image, save_image
from vipnerf_tpu_torch.utils.naming import scene_dirname


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
    hits geometry, as in the forward-facing scenes the visibility losses
    were designed for."""

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
        x, y = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64),
                           indexing="xy")
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
        # ray length along unit dirs -> camera z-depth
        return color, t_best / np.linalg.norm(dirs_cam, axis=-1)


def make_dtu_scene(seed: int = 0):
    """A scene and camera ring inside the DTU loader's fixed depth bounds
    [0.1, 5]: cameras at radius 1.2 (height 0.25) inside a shell of radius
    2.2 see z-depths of about 0.4-3.5, where the default ring (radius 3, shell
    6) would put most of the scene beyond far = 5. Returns (scene,
    ring_kwargs) for `write_synthetic_database`."""
    return SphereScene(seed=seed, shell_radius=2.2), {"ring_radius": 1.2, "ring_height": 0.25}


def make_camera_ring(
    num_cameras: int, radius: float = 3.0, height: float = 0.4, spread_deg: float = 40.0,
) -> np.ndarray:
    """w2c extrinsics on an arc looking at the origin (forward-facing rig)."""
    angles = np.deg2rad(np.linspace(-spread_deg / 2, spread_deg / 2, num_cameras))
    return np.stack([
        look_at_w2c(np.array([radius * np.sin(a), height, radius * np.cos(a)]), np.zeros(3),
                    np.array([0.0, 1.0, 0.0]))
        for a in angles
    ])


def write_synthetic_database(
    root: Path,
    *,
    dataset: str = "NeRF_LLFF",
    scene_name: str = "synth01",
    num_frames: int = 6,
    set_num: int = 2,
    train_frames=(0, 5),
    val_frames=(2,),
    height: int = 48,
    width: int = 64,
    seed: int = 0,
    resolution_suffix: str = "",
    with_sparse_depth: bool = True,
    sparse_depth_dirname: str = "DE02",
    with_visibility_prior: bool = True,
    visibility_dirname: str = "VW02",
    scene: Optional[SphereScene] = None,
    ring_radius: float = 3.0,
    ring_height: float = 0.4,
) -> Dict[str, np.ndarray]:
    """Write the scene under root/{dataset}/data; returns the ground truth
    (images, depths, extrinsics, intrinsics, bounds, scene)."""
    root = Path(root)
    scene = scene or SphereScene(seed=seed)
    split_dir = {"NeRF_LLFF": "all", "RealEstate10K": "test", "DTU": "all"}[dataset]
    data_dir = root / dataset / "data"
    scene_key = "scene_name" if dataset == "NeRF_LLFF" else "scene_num"
    scene_dir_name = scene_dirname(scene_name, scene_key)
    scene_dir = data_dir / f"{split_dir}/database_data/{scene_dir_name}"
    rgb_dir = scene_dir / f"rgb{resolution_suffix}"
    rgb_dir.mkdir(parents=True, exist_ok=True)

    focal = 0.9 * width
    intrinsic = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1.0]])
    extrinsics = make_camera_ring(num_frames, radius=ring_radius, height=ring_height)
    images, depths = [], []
    for i in range(num_frames):
        rgb, depth = scene.render(extrinsics[i], intrinsic, height, width)
        img8 = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        save_image(rgb_dir / f"{i:04}.png", img8)
        images.append(img8)
        depths.append(depth)
    images, depths = np.stack(images), np.stack(depths)

    np.savetxt(scene_dir / "CameraExtrinsics.csv", extrinsics.reshape(num_frames, 16), delimiter=",")
    np.savetxt(scene_dir / f"CameraIntrinsics{resolution_suffix}.csv",
               np.tile(intrinsic.reshape(1, 9), (num_frames, 1)), delimiter=",")
    pos_depths = np.where(depths > 0, depths, np.inf)
    bounds = np.stack([
        np.minimum(pos_depths.reshape(num_frames, -1).min(1), 1e3) * 0.8,
        depths.reshape(num_frames, -1).max(1) * 1.2 + 1.0,
    ], axis=1)
    np.savetxt(scene_dir / "DepthBounds.csv", bounds, delimiter=",")

    sets_dir = data_dir / f"train_test_sets/set{set_num:02}"
    sets_dir.mkdir(parents=True, exist_ok=True)
    scene_val = scene_name if dataset == "NeRF_LLFF" else int(scene_name)

    def write_split(mode, frames):
        # other scenes' rows of an existing split CSV are kept
        path = sets_dir / f"{mode}VideosData.csv"
        lines = [f"{scene_key},pred_frame_num"]
        if path.exists():
            existing = path.read_text().splitlines()
            if existing and existing[0] != lines[0]:
                raise ValueError(f"{path} header {existing[0]!r} does not match {lines[0]!r}; "
                                 "refusing to overwrite a foreign split CSV")
            lines += [row for row in existing[1:] if row and row.split(",")[0] != str(scene_val)]
        lines += [f"{scene_val},{f}" for f in frames]
        path.write_text("\n".join(lines) + "\n")

    write_split("Train", train_frames)
    write_split("Validation", val_frames)
    write_split("Test", [f for f in range(num_frames) if f not in train_frames and f not in val_frames])

    if with_sparse_depth:
        write_sparse_depths(data_dir / (f"{split_dir}/estimated_depths/{sparse_depth_dirname}/"
                                        f"{scene_dir_name}/estimated_depths{resolution_suffix}"),
                            depths, train_frames, seed)

    if with_visibility_prior:
        vis_dir = data_dir / f"{split_dir}/visibility_prior/{visibility_dirname}/{scene_dir_name}"
        (vis_dir / "visibility_masks").mkdir(parents=True, exist_ok=True)
        (vis_dir / "visibility_weights").mkdir(parents=True, exist_ok=True)
        for f1 in train_frames:
            for f2 in train_frames:
                if f1 == f2:
                    continue
                visible = depths[f1] > 0
                save_image(vis_dir / f"visibility_masks/{f1:04}_{f2:04}.png",
                           visible.astype(np.uint8) * 255)
                np.save(vis_dir / f"visibility_weights/{f1:04}_{f2:04}.npy",
                        visible.astype(np.float32) * 0.9 + 0.05)

    return {
        "images": images,
        "depths": depths,
        "extrinsics": extrinsics,
        "intrinsics": np.tile(intrinsic[None], (num_frames, 1, 1)),
        "bounds": bounds,
        "scene": scene,
    }


def write_sparse_depths(sd_dir: Path, depths: np.ndarray, frames, seed: int = 0):
    """Sparse depths of `frames` drawn from the true depths (t, h, w), as the
    sparse-depth prior writes them: {frame:04}.csv of x, y, depth and a
    reprojection error."""
    rng = np.random.default_rng(seed + 1)
    sd_dir = Path(sd_dir)
    sd_dir.mkdir(parents=True, exist_ok=True)
    height, width = depths.shape[1:]
    for f in frames:
        ys, xs = np.where(depths[f] > 0)
        # a realistic feature count: a tiny pool repeats points in every batch
        k = min(max(200, height * width // 25), len(xs))
        sel = rng.choice(len(xs), size=k, replace=False)
        rows = ["x,y,depth,reprojection_error"]
        for j in sel:
            rows.append(f"{xs[j]},{ys[j]},{depths[f][ys[j], xs[j]]:.6f},{rng.uniform(0.1, 1.0):.4f}")
        (sd_dir / f"{f:04}.csv").write_text("\n".join(rows) + "\n")


def write_raw_llff_scene(
    root: Path,
    *,
    scene_name: str = "synth01",
    num_frames: int = 5,
    height: int = 48,
    width: int = 64,
    seed: int = 0,
    source_jpeg: Optional[Path] = None,
) -> Dict[str, np.ndarray]:
    """Write root/nerf_llff_data/<scene>/ as the published NeRF-LLFF archive
    lays a scene out, with the scene at `height` x `width` as its quarter
    resolution: sparse/0/{cameras,images}.bin (one SIMPLE_RADIAL camera of
    the full resolution, 4x, and each frame's w2c), poses_bounds.npy (LLFF's
    3x5 pose and the near/far bounds), images_4/*.png and images_8/*.png
    (INTER_AREA halves), and images/IMG_{i:04}: copies of `source_jpeg`
    when given (.JPG), else the quarter-resolution frames (.png). Returns
    the ground truth: images and depths (quarter resolution), extrinsics,
    intrinsics (quarter resolution), bounds."""
    scene_dir = Path(root) / "nerf_llff_data" / scene_name
    for sub in ("sparse/0", "images", "images_4", "images_8"):
        (scene_dir / sub).mkdir(parents=True, exist_ok=True)
    scene = SphereScene(seed=seed)
    focal = 0.9 * width
    intrinsic = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1.0]])
    extrinsics = make_camera_ring(num_frames)
    images, depths, bounds, images_meta = [], [], [], {}
    for i, w2c in enumerate(extrinsics):
        rgb, depth = scene.render(w2c, intrinsic, height, width)
        img8 = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        images.append(img8)
        depths.append(depth)
        name = f"IMG_{i:04}"
        save_image(scene_dir / f"images_4/{name}.png", img8)
        save_image(scene_dir / f"images_8/{name}.png",
                   np.clip(np.round(rescale_image(img8, 2)), 0, 255).astype(np.uint8))
        if source_jpeg is not None:
            shutil.copyfile(source_jpeg, scene_dir / f"images/{name}.JPG")
        else:
            save_image(scene_dir / f"images/{name}.png", img8)
        bounds.append([depth.min() * 0.8, depth.max() * 1.2 + 1.0])
        images_meta[i + 1] = colmap_io.ColmapImage(
            i + 1, colmap_io.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3].copy(), 1,
            f"{name}.JPG" if source_jpeg is not None else f"{name}.png", np.zeros((0, 2)), np.zeros(0, np.int64))
    camera = colmap_io.ColmapCamera(1, "SIMPLE_RADIAL", 4 * width, 4 * height,
                                    np.array([4 * focal, 2.0 * width, 2.0 * height, 0.0]))
    colmap_io.write_cameras_binary(scene_dir / "sparse/0/cameras.bin", {1: camera})
    colmap_io.write_images_binary(scene_dir / "sparse/0/images.bin", images_meta)
    c2w = np.linalg.inv(extrinsics)[:, :3, :4]
    hwf = np.tile(np.array([4 * height, 4 * width, 4 * focal])[None, :, None], (num_frames, 1, 1))
    llff = np.concatenate([c2w[:, :, 1:2], c2w[:, :, 0:1], -c2w[:, :, 2:3], c2w[:, :, 3:4], hwf], axis=2)
    bounds = np.asarray(bounds)
    np.save(scene_dir / "poses_bounds.npy", np.concatenate([llff.reshape(num_frames, 15), bounds], axis=1))
    return {"images": np.stack(images), "depths": np.stack(depths), "extrinsics": extrinsics,
            "intrinsics": np.tile(intrinsic[None], (num_frames, 1, 1)), "bounds": bounds}

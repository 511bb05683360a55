"""Dense visibility prior: plane-sweep photometric consistency (counterpart
of vipnerf_tpu/priors/visibility.py).

For each ordered pair of train views, frame2 is warped into frame1 through
each of `num_depth_planes` fronto-parallel depth planes (inverse-depth
spacing; linear for DTU) by a masked, zero-padded bilinear sampler; the
per-pixel minimum over the planes of the mean absolute colour error gives
weights = exp(-error / temperature), and mask = weights > 0.5. Each pair
uses its own extrinsics and intrinsics.

Outputs under {split}/visibility_prior/VW{gen_num:02}/{scene}/:
visibility_masks/{f1:04}_{f2:04}.npy + .png and
visibility_weights/{f1:04}_{f2:04}.npy + .png, beside a strict Configs.json.

The sweep runs on the device in f32 as torch ops, `planes_per_step` planes
at a time with a running minimum, which equals a one-plane-at-a-time scan
(each plane's error is elementwise). The warp's 3x3 transforms are written
out as fused multiply-adds in the order of the JAX package's CPU matmuls,
not as matmuls, so no TF32 setting reaches them (0.04 px of warp error is
enough to corrupt the photometric test) and the CPU result equals the JAX
package's bit for bit.

    python -m vipnerf_tpu_torch.priors.visibility --database NeRF_LLFF --gen_nums 2
"""

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import scipy.linalg
import torch

from vipnerf_tpu_torch.utils.device import resolve_device
from vipnerf_tpu_torch.utils.io import read_csv_columns, read_image, save_image, save_numpy_array
from vipnerf_tpu_torch.utils.naming import scene_dirname


def get_depth_planes(
    min_depth: float, max_depth: float, num_planes: int, linear: bool = False
) -> np.ndarray:
    if linear:
        return np.linspace(min_depth, max_depth, num_planes)
    return 1.0 / np.linspace(1.0 / min_depth, 1.0 / max_depth, num_planes)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 round(a * b + c) for f32 tensors a, c and an f32-valued scalar b:
    the product is exact in f64, so this is a fused multiply-add up to a
    double rounding, which needs an f64 result on an f32 tie."""
    return (a.double() * b + c.double()).float()


def _warp_coords_for_plane(
    depth: torch.Tensor,
    k1_inv: np.ndarray,
    k2: np.ndarray,
    t21: np.ndarray,
    h: int,
    w: int,
    device: torch.device,
) -> torch.Tensor:
    """Pixel coords (..., h, w, 2) in frame2 of every frame1 pixel at each
    depth of `depth` (a scalar or (g,) f32 tensor): x_2 ~ K2 (R21 d K1^-1 p +
    t21), for f32 host matrices. Each 3-term product is accumulated as the
    JAX package's matmuls are on the CPU: the first product rounded, then
    fused multiply-adds in order."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")

    def product(vec, mat, i):  # (vec . mat[i, :3])
        return _fma(vec[2], float(mat[i, 2]), _fma(vec[1], float(mat[i, 1]), vec[0] * float(mat[i, 0])))

    cam = [_fma(yy, float(k1_inv[i, 1]), xx * float(k1_inv[i, 0])) + float(k1_inv[i, 2]) for i in range(3)]
    d = depth.reshape(*depth.shape, 1, 1)
    pts = [d * c for c in cam]  # camera-1 coords at each plane
    pts2 = [product(pts, t21, i) + float(t21[i, 3]) for i in range(3)]
    proj = [product(pts2, k2, i) for i in range(3)]
    return torch.stack([proj[0] / proj[2], proj[1] / proj[2]], dim=-1)


def _bilinear_sample_masked(frame2: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Masked, zero-padded bilinear sampling of frame2 (h, w, 3) at coords
    (..., h, w, 2) -> (..., h, w, 3), term for term as the JAX package: frame
    and validity mask padded by 1; x clipped to [0, w + 1] and floor and ceil
    clipped apart; NW weighted (1 - (y - y0))(1 - (x - x0)) but SE
    (1 - (y1 - y))(1 - (x1 - x)), so at integer coordinates every corner
    weighs 1; the masked sum normalised by the masked weight, 0 where that is
    0. The padded frame and mask are one (h + 2) * (w + 2) x 4 table that each
    corner gathers from with flat indices."""
    h, w = frame2.shape[:2]
    table = torch.zeros((h + 2, w + 2, 4), dtype=frame2.dtype, device=frame2.device)
    table[1:-1, 1:-1, :3] = frame2
    table[1:-1, 1:-1, 3] = 1.0
    table = table.reshape(-1, 4)

    pos = coords + 1.0
    x = pos[..., 0].clamp(0.0, w + 1.0)
    y = pos[..., 1].clamp(0.0, h + 1.0)
    x0 = torch.floor(pos[..., 0]).clamp(0, w + 1)
    y0 = torch.floor(pos[..., 1]).clamp(0, h + 1)
    x1 = torch.ceil(pos[..., 0]).clamp(0, w + 1)
    y1 = torch.ceil(pos[..., 1]).clamp(0, h + 1)

    w_nw = (1 - (y - y0)) * (1 - (x - x0))
    w_sw = (1 - (y1 - y)) * (1 - (x - x0))
    w_ne = (1 - (y - y0)) * (1 - (x1 - x))
    w_se = (1 - (y1 - y)) * (1 - (x1 - x))

    def gather(yy, xx):
        # a NaN coordinate (a pixel whose ray meets the plane at the camera
        # centre) has NaN weights, so its value is 0 whichever entry it reads
        flat = torch.nan_to_num(yy * (w + 2) + xx).long()
        return table[flat]

    corners = [(w_nw, gather(y0, x0)), (w_sw, gather(y1, x0)), (w_ne, gather(y0, x1)), (w_se, gather(y1, x1))]
    nr = dr = None
    for wt, g in corners:
        term_n = wt[..., None] * g[..., :3] * g[..., 3:]
        term_d = wt * g[..., 3]
        nr = term_n if nr is None else nr + term_n
        dr = term_d if dr is None else dr + term_d
    dr = dr[..., None]
    return torch.where(dr > 0, nr / dr.clamp_min(1e-12), torch.zeros_like(nr))


def _pose_chain(extrinsic1, extrinsic2, intrinsic1):
    """K1^-1 and E2 E1^-1 as f32 host matrices, formed as the JAX package
    forms them on the CPU: an inverse is LAPACK's f32 LU solve against the
    identity (getrf + trsm, what jnp.linalg.inv runs), and the 4x4 product
    accumulates fused multiply-adds in order. One ulp of E2 E1^-1 moves the
    weights by up to ~5e-5 on a sharp-edged scene."""
    def inv(a):
        a = np.asarray(a, np.float32)
        return scipy.linalg.lu_solve(scipy.linalg.lu_factor(a), np.eye(len(a), dtype=np.float32))

    k1_inv = inv(intrinsic1)
    e1_inv = inv(extrinsic1).astype(np.float64)
    e2 = np.asarray(extrinsic2, np.float32).astype(np.float64)
    t21 = (e2[:, :1] * e1_inv[:1]).astype(np.float32)
    for k in (1, 2, 3):
        t21 = (e2[:, k:k + 1] * e1_inv[k:k + 1] + t21).astype(np.float32)
    return k1_inv, t21


def compute_visibility_weights(
    frame1: torch.Tensor,
    frame2: torch.Tensor,
    extrinsic1: np.ndarray,
    extrinsic2: np.ndarray,
    intrinsic1: np.ndarray,
    intrinsic2: np.ndarray,
    depth_planes: torch.Tensor,
    temperature: float,
    planes_per_step: int = 8,
) -> torch.Tensor:
    """Per-pixel visibility weights (h, w) of frame1 towards frame2. frames:
    (h, w, 3) f32 tensors in [0, 255] on the device; poses: host arrays (w2c
    4x4, 3x3 intrinsics), taken in f32 (see `_pose_chain`); depth_planes:
    (d,). The minimum colour error over the planes, `planes_per_step` planes
    at a time, gives exp(-min / temperature)."""
    h, w = frame1.shape[:2]
    dev = frame1.device
    k1_inv, t21 = _pose_chain(extrinsic1, extrinsic2, intrinsic1)
    k2 = np.asarray(intrinsic2, np.float32)
    planes = torch.as_tensor(depth_planes, dtype=torch.float32, device=dev)

    min_err = torch.full((h, w), float("inf"), dtype=torch.float32, device=dev)
    for start in range(0, planes.shape[0], planes_per_step):
        coords = _warp_coords_for_plane(planes[start:start + planes_per_step], k1_inv, k2, t21, h, w, dev)
        diff = (_bilinear_sample_masked(frame2, coords) - frame1).abs()
        err = (diff[..., 0] + diff[..., 1] + diff[..., 2]) / 3  # mean over colour
        min_err = torch.minimum(min_err, err.amin(dim=0))
    return torch.exp(-min_err / temperature)


def save_gen_configs(
    output_dirpath: Path, configs: Dict, *, backfill_new_keys: bool = False
):
    """Strict config persistence: keys of an existing Configs.json missing
    from `configs` are inherited, and any other difference raises, so a key
    newly added to the code raises on resume; `backfill_new_keys=True` also
    accepts keys the old file lacks (the database builders' semantics)."""
    configs_path = Path(output_dirpath) / "Configs.json"
    if configs_path.exists():
        with open(configs_path) as f:
            old = json.load(f)
        for key in old:
            if key not in configs:
                configs[key] = old[key]
        if backfill_new_keys:
            for key in configs:
                if key not in old:
                    old[key] = configs[key]
        if configs != old:
            raise RuntimeError("Configs mismatch while resuming generation")
    with open(configs_path, "w") as f:
        json.dump(configs, f, indent=4)


def start_generation(gen_configs: Dict, root_dirpath: Optional[Path] = None, device="all"):
    """Generate the visibility priors of every scene of a train set, on
    `device` ("all" or [i]: the GPU; "cpu": the CPU).

    gen_configs: {generator, gen_num, gen_set_num, database_name,
    database_dirpath, num_depth_planes, temperature[, scene_key][, split_dir]
    [, resolution_suffix][, depth_planes_linear][, fixed_bounds]}. A pair
    whose four .npy files exist is skipped; each frame is read once.
    """
    device = resolve_device(device)
    root_dirpath = Path(root_dirpath) if root_dirpath else Path(".")
    database_dirpath = root_dirpath / "data/databases" / gen_configs["database_dirpath"]

    scene_key = gen_configs.get("scene_key", "scene_name")
    split_dir = gen_configs.get("split_dir", "all")
    output_dirpath = database_dirpath / f"{split_dir}/visibility_prior/VW{gen_configs['gen_num']:02}"
    output_dirpath.mkdir(parents=True, exist_ok=True)
    save_gen_configs(output_dirpath, dict(gen_configs))

    set_num = gen_configs["gen_set_num"]
    video_data = read_csv_columns(database_dirpath / f"train_test_sets/set{set_num:02}/TrainVideosData.csv")
    suffix = gen_configs.get("resolution_suffix", "")
    linear = gen_configs.get("depth_planes_linear", False)
    fixed_bounds = gen_configs.get("fixed_bounds")
    temperature = gen_configs["temperature"]
    num_planes = gen_configs["num_depth_planes"]

    for scene_id in np.unique(video_data[scene_key]):
        scene_dir = scene_dirname(scene_id, scene_key)
        frame_nums = video_data["pred_frame_num"][video_data[scene_key] == scene_id].astype(int)
        base = database_dirpath / f"{split_dir}/database_data/{scene_dir}"
        extrinsics = np.loadtxt((base / "CameraExtrinsics.csv").as_posix(), delimiter=",").reshape((-1, 4, 4))[frame_nums]
        intrinsics = np.loadtxt((base / f"CameraIntrinsics{suffix}.csv").as_posix(), delimiter=",").reshape((-1, 3, 3))[frame_nums]
        if fixed_bounds is not None:
            min_depth, max_depth = fixed_bounds
        else:
            bds = np.loadtxt((base / "DepthBounds.csv").as_posix(), delimiter=",")[frame_nums]
            min_depth, max_depth = bds.min(), bds.max()
        depth_planes = torch.as_tensor(get_depth_planes(min_depth, max_depth, num_planes, linear),
                                       dtype=torch.float32, device=device)

        scene_out = output_dirpath / scene_dir
        frame_cache: Dict[int, torch.Tensor] = {}

        def load_frame(f: int) -> torch.Tensor:
            if f not in frame_cache:
                frame_cache[f] = torch.as_tensor(read_image(base / f"rgb{suffix}/{f:04}.png")[..., :3],
                                                 dtype=torch.float32, device=device)
            return frame_cache[f]

        for i1, f1 in enumerate(frame_nums):
            for i2, f2 in enumerate(frame_nums):
                if f2 <= f1:
                    continue
                paths = {
                    "m1": scene_out / f"visibility_masks/{f1:04}_{f2:04}.npy",
                    "m2": scene_out / f"visibility_masks/{f2:04}_{f1:04}.npy",
                    "w1": scene_out / f"visibility_weights/{f1:04}_{f2:04}.npy",
                    "w2": scene_out / f"visibility_weights/{f2:04}_{f1:04}.npy",
                }
                if all(p.exists() for p in paths.values()):
                    continue
                t_pair = time.perf_counter()
                frame1, frame2 = load_frame(f1), load_frame(f2)
                # the poses as the JAX package passes them: rounded to f32
                e1, e2, k1, k2 = (a.astype(np.float32) for a in
                                  (extrinsics[i1], extrinsics[i2], intrinsics[i1], intrinsics[i2]))
                seconds = []
                results = []
                for args in ((frame1, frame2, e1, e2, k1, k2), (frame2, frame1, e2, e1, k2, k1)):
                    t0 = time.perf_counter()
                    results.append(compute_visibility_weights(*args, depth_planes, temperature).cpu().numpy())
                    seconds.append(time.perf_counter() - t0)
                for w_arr, wp, mp in ((results[0], paths["w1"], paths["m1"]),
                                      (results[1], paths["w2"], paths["m2"])):
                    mask = w_arr > 0.5
                    mp.parent.mkdir(parents=True, exist_ok=True)
                    np.save(mp.as_posix(), mask)
                    save_image(mp.parent / f"{mp.stem}.png", mask.astype(np.uint8) * 255)
                    save_numpy_array(wp, w_arr, as_png=True)
                print(
                    f"  {scene_dir} pair {f1:04}<->{f2:04}: {num_planes} planes, "
                    f"{frame1.shape[0]}x{frame1.shape[1]}, {seconds[0]:.3f} s and {seconds[1]:.3f} s "
                    f"per direction on {device}; {time.perf_counter() - t_pair:.2f} s with reads and writes",
                    flush=True,
                )


if __name__ == "__main__":
    from vipnerf_tpu_torch.priors.cli import main_visibility

    main_visibility()

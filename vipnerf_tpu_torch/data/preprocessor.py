"""Data preprocessing: the ray cache, index streams and batch gather of
training, full-image batches of validation, and the test-mode ray batches
and output reshaping (counterpart of vipnerf_tpu/data/preprocessor.py).

- images: uint8 -> [0, 1], optional white-background composite;
- poses: scale, recentre, flip (core.poses), near/far policy;
- ray cache (train/validation), built on the preprocessor's device: rays,
  NDC rays, view dirs, pixel ids (image, x, y), target rgb, poses;
- sparse-depth, dense-depth and visibility-prior caches (train);
- index streams on the host: a shuffled NeRF-ray stream (precrop window
  while `precrop_iterations` lasts, the full stream after it, also on a
  resume past it) and a shuffled stream of the sparse-depth rays; an epoch
  tail wraps into the next permutation and consumes it. With
  `native_raystream` (default True, as in the JAX package) a train
  preprocessor's `get_index_chunk` draws from the C++ streams of
  `data/raystream.py` (seeded with `seed` and `seed + 1`, over the numpy
  streams' first permutations); with it False, and always in
  `get_next_batch`, from numpy. Either way they are the JAX package's
  streams index for index: same generators, same shuffles in the same
  order. Unlike the JAX package, a failed g++ build raises;
- `gather_batch`: [nerf rays; sparse-depth rays] with stream masks and -1
  fills off-stream, on the device; from several scenes' caches stacked
  along the ray axis (batched multi-scene training), every scene's batch
  in turn with its own near/far and its own poses.

`downsampling_factor > 1` rescales the frames, the dense depths and the
visibility priors with `utils.io.rescale_image` (OpenCV's INTER_AREA, as the
JAX package does with cv2) and divides the intrinsics and the sparse-depth
coordinates by the factor. Not ported: the mip-NeRF `radii` fields
(`render_rays` does not read them).
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vipnerf_tpu_torch.core import poses as pose_ops
from vipnerf_tpu_torch.core import rays as ray_ops
from vipnerf_tpu_torch.data.raystream import NativeRayStream
from vipnerf_tpu_torch.utils.io import rescale_image


def get_data_preprocessor(
    configs, mode, raw_data_dict=None, model_configs=None, device=None
):
    """Factory; the one implementation answers to 'DataPreprocessor01'."""
    name = configs["data_loader"]["data_preprocessor_name"]
    if name != "DataPreprocessor01":
        raise RuntimeError(f"Unknown data preprocessor: {name}")
    return DataPreprocessor(configs, mode, raw_data_dict, model_configs, device)


class DataPreprocessor:
    def __init__(
        self,
        configs: Dict[str, Any],
        mode: str,
        raw_data_dict: Optional[dict] = None,
        model_configs: Optional[dict] = None,
        device: Optional[torch.device] = None,
    ):
        self.mode = mode.lower()
        self.configs = configs
        dl = configs["data_loader"]
        self.ndc = dl["ndc"]
        self.mip_nerf_used = "mip_nerf" in dl
        self.model_configs = model_configs
        self.raw_data_dict = raw_data_dict
        self.device = torch.device("cpu") if device is None else torch.device(device)
        if self.mode == "test":
            return
        if self.mode not in ("train", "validation"):
            raise ValueError(f"unknown preprocessor mode {mode!r}")

        self.bd_factor = dl["bd_factor"]
        self.downsampling_factor = dl["downsampling_factor"]
        self.use_batching = dl.get("batching", True)
        self.num_rays = dl["num_rays"]
        self.sparse_depth_needed = "sparse_depth" in dl
        self.dense_depth_needed = "dense_depth" in dl
        self.visibility_prior_needed = "visibility_prior" in dl
        self.poses_needed = any(
            configs.get("model", {}).get(m, {}).get("predict_visibility", False)
            for m in ("coarse_mlp", "fine_mlp")
        )
        if self.sparse_depth_needed:
            self.num_rays_sparse_depth = dl["sparse_depth"]["num_rays"]

        seed = configs.get("seed", 0)
        self._rng = np.random.default_rng(seed)
        self._indices: Optional[np.ndarray] = None
        self._i_batch = 0
        self._indices_sd: Optional[np.ndarray] = None
        self._i_batch_sd = 0
        self.cache: Dict[str, torch.Tensor] = {}
        self._native_nerf: Optional[NativeRayStream] = None
        self._native_sd: Optional[NativeRayStream] = None
        self._preprocess_all()
        if self.mode == "train":
            self.model_configs = self._create_model_configs()
            if dl.get("native_raystream", True):
                self._init_native_streams(0 if seed is None else seed)

    def _init_native_streams(self, seed: int):
        """C++ streams over the numpy streams' first permutations (as the
        JAX package seeds its native streams)."""
        if self._indices is not None and len(self._indices):
            self._native_nerf = NativeRayStream(seed, candidates=self._indices)
        if self._indices_sd is not None and len(self._indices_sd):
            self._native_sd = NativeRayStream(seed + 1, candidates=self._indices_sd)

    # ------------------------------------------------------------ preprocess

    def _preprocess_all(self):
        raw = self.raw_data_dict
        nerf_raw = raw["nerf_data"]
        images = self._preprocess_images(np.asarray(nerf_raw["images"]))
        intrinsics = np.asarray(nerf_raw["intrinsics"], dtype=np.float64).copy()
        resolution = [int(x) for x in nerf_raw["resolution"]]
        if self.downsampling_factor > 1:
            images = np.stack([self._rescale(im) for im in images])
            resolution = [x // self.downsampling_factor for x in resolution]
            intrinsics[:, :2] /= self.downsampling_factor
        self.frame_nums = np.asarray(raw["frame_nums"])
        self.num_frames = len(self.frame_nums)
        self.resolution = resolution
        self.intrinsics = intrinsics.astype(np.float32)

        bounds = np.asarray(nerf_raw["bounds"], dtype=np.float64)
        if self.mode == "train":
            dl = self.configs["data_loader"]
            pp = pose_ops.preprocess_poses(
                np.asarray(nerf_raw["extrinsics"]), train_mode=True, bounds=bounds,
                bd_factor=self.bd_factor, recenter=dl["recenter_camera_poses"], spherify=dl["spherify"],
            )
            self.sc = float(pp.get("sc", 1.0))
            self.average_pose = pp["average_pose"]
        else:
            pp = pose_ops.preprocess_poses(
                np.asarray(nerf_raw["extrinsics"]), train_mode=False, bounds=bounds,
                translation_scale=self.model_configs["translation_scale"],
                average_pose=np.asarray(self.model_configs["average_pose"]),
            )
            self.sc = float(self.model_configs["translation_scale"])
            self.average_pose = np.asarray(self.model_configs["average_pose"])
        self.poses = pp["poses"]  # (n, 4, 4) c2w, float32
        self.bounds = pp["bounds"]

        if not self.ndc:
            self.near = float(self.bounds[0] * 0.9)
            self.far = float(self.bounds[1])
            self.near_ndc = self.far_ndc = None
        else:
            if self.bd_factor is None:
                # bd_factor scaling puts the train scene's NDC near at 1, the
                # value the NDC <-> metric depth conversions hard-code
                raise RuntimeError("ndc mode requires data_loader.bd_factor")
            self.near = float(self.bounds[0] * self.bd_factor)
            self.far = float(self.bounds[1])
            self.near_ndc, self.far_ndc = 0.0, 1.0

        self.images = images.astype(np.float32)
        if self.use_batching:
            self._build_ray_cache()
            if self.mode == "train":
                if self.sparse_depth_needed:
                    self._build_sparse_depth_cache(raw)
                if self.dense_depth_needed:
                    self._build_dense_depth_cache(raw)
                if self.visibility_prior_needed:
                    self._build_visibility_prior_cache(raw)
            self._indices = self._generate_indices(iter_num=0)

    def _preprocess_images(self, images: np.ndarray) -> np.ndarray:
        images = images.astype(np.float32) / 255.0
        if self.configs["model"]["white_bkgd"]:
            return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        return images[..., :3]

    def _rescale(self, image: np.ndarray) -> np.ndarray:
        return rescale_image(image, self.downsampling_factor, anti_aliasing=True)

    def _ray_intrinsic(self, intr: np.ndarray) -> np.ndarray:
        """mip-NeRF casts rays through pixel centres: a -0.5 principal-point
        shift, on every ray-generation path."""
        if not self.mip_nerf_used:
            return np.asarray(intr)
        intr = np.asarray(intr).copy()
        intr[..., 0, 2] -= 0.5
        intr[..., 1, 2] -= 0.5
        return intr

    def _tensor(self, array, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype, device=self.device)

    def _image_rays(self, img_i: int):
        """(h, w, 3) rays_o, rays_d of frame `img_i`, on the device."""
        return self._rays(*self.resolution, self.intrinsics[img_i], self.poses[img_i])

    def _ndc(self, rays_o, rays_d, img_i: int):
        h, w = self.resolution
        intr = self.intrinsics[img_i]
        return ray_ops.get_ndc_rays(rays_o, rays_d, h, w, float(intr[0, 0]), float(intr[1, 1]), self.near)

    def _build_ray_cache(self):
        h, w = self.resolution
        n = self.num_frames
        rays = [self._image_rays(i) for i in range(n)]
        rays_o = torch.stack([o for o, _ in rays])  # (n, h, w, 3)
        rays_d = torch.stack([d for _, d in rays])
        image_id = torch.arange(n, dtype=torch.int32, device=self.device)[:, None, None].expand(n, h, w)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.int32, device=self.device),
            torch.arange(w, dtype=torch.int32, device=self.device), indexing="ij",
        )
        pixel_id = torch.stack([image_id, gx.expand(n, h, w), gy.expand(n, h, w)], dim=-1)
        cache = {
            "rays_o": rays_o.reshape(-1, 3).contiguous(),
            "rays_d": rays_d.reshape(-1, 3).contiguous(),
            "view_dirs": ray_ops.get_view_dirs(rays_d).reshape(-1, 3),
            "pixel_id": pixel_id.reshape(-1, 3).contiguous(),
            "target_rgb": self._tensor(self.images.reshape(-1, 3)),
            "poses": self._tensor(self.poses),
        }
        if self.ndc:
            ndc = [self._ndc(rays_o[i], rays_d[i], i) for i in range(n)]
            cache["rays_o_ndc"] = torch.stack([o for o, _ in ndc]).reshape(-1, 3)
            cache["rays_d_ndc"] = torch.stack([d for _, d in ndc]).reshape(-1, 3)
        self.cache = cache

    def _depth_cache(self, flat_depths: np.ndarray, near: float) -> torch.Tensor:
        """NDC z' of (n*h*w, 1) metric depths along the cached rays; -1 stays -1."""
        d_ndc = ray_ops.depth_to_ndc(
            self._tensor(flat_depths), self.cache["rays_o"], self.cache["rays_d"], near=near,
        )
        return torch.where(self._tensor(flat_depths) == -1, torch.full_like(d_ndc, -1.0), d_ndc)

    def _build_sparse_depth_cache(self, raw: dict):
        """Scatter each frame's sparse points into (h, w) grids, flatten, and
        shuffle the indices of the valid ones into the sparse-depth stream."""
        h, w = self.resolution
        depths = -np.ones((self.num_frames, h, w), np.float32)
        errors = -np.ones((self.num_frames, h, w), np.float32)
        for i, frame_num in enumerate(self.frame_nums):
            fd = raw["sparse_depth_data"].get(int(frame_num))
            if fd is None:
                continue
            # an edge feature can round onto the downscaled grid's edge: dropped
            xi = np.round(np.asarray(fd["x"], np.float64) / self.downsampling_factor).astype(int)
            yi = np.round(np.asarray(fd["y"], np.float64) / self.downsampling_factor).astype(int)
            keep = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            depths[i, yi[keep], xi[keep]] = (np.asarray(fd["depth"], np.float64) * self.sc)[keep]
            errors[i, yi[keep], xi[keep]] = np.asarray(fd["reprojection_error"], np.float64)[keep]
        flat_depths = depths.reshape(-1, 1)
        valid = np.where(flat_depths[:, 0] > 0)[0]
        self._rng.shuffle(valid)
        self._indices_sd = valid
        self.cache["sparse_depth_values"] = self._tensor(flat_depths)
        self.cache["sparse_depth_errors"] = self._tensor(errors.reshape(-1, 1))
        if self.ndc:
            self.cache["sparse_depth_values_ndc"] = self._depth_cache(flat_depths, 1.0)

    def _build_dense_depth_cache(self, raw: dict):
        depths = np.asarray(raw["dense_depth_data"]["depth_values"], np.float32) * self.sc
        weights = np.asarray(raw["dense_depth_data"]["depth_weights"], np.float32)
        if self.downsampling_factor > 1:
            depths = np.stack([self._rescale(d) for d in depths])
            weights = np.stack([self._rescale(x) for x in weights])
        flat = depths.reshape(-1, 1)
        self.cache["dense_depth_values"] = self._tensor(flat)
        self.cache["dense_depth_weights"] = self._tensor(weights.reshape(-1, 1))
        if self.ndc:
            self.cache["dense_depth_values_ndc"] = self._depth_cache(flat, self.near)

    def _build_visibility_prior_cache(self, raw: dict):
        """(n, n-1, h, w) masks/weights -> (n*h*w, n-1) per pixel."""
        if self.num_frames < 2:
            return
        vp_cfg = self.configs["data_loader"]["visibility_prior"]
        for key, enabled in (("masks", vp_cfg.get("load_masks")),
                             ("weights", vp_cfg.get("load_weights"))):
            if not enabled:
                continue
            arr = np.asarray(raw["visibility_prior_data"][key], np.float32)  # (n, n-1, h, w)
            n, nm1, h, w = arr.shape
            if self.downsampling_factor > 1:
                flat = np.stack([self._rescale(m) for m in arr.reshape(n * nm1, h, w)])
                if key == "masks":  # a cell touching any visible pixel is visible
                    flat = flat.astype(bool).astype(np.float32)
                arr = flat.reshape(n, nm1, *flat.shape[1:])
            self.cache[f"visibility_prior_{key}"] = self._tensor(
                np.transpose(arr, (0, 2, 3, 1)).reshape(-1, nm1)
            )

    def _create_model_configs(self) -> dict:
        """Model configs saved beside the checkpoints."""
        mc = {
            "resolution": list(self.resolution),
            "bounds": np.asarray(self.bounds).tolist(),
            "translation_scale": self.sc,
            f"{self.mode}_frame_nums": np.asarray(self.frame_nums).tolist(),
            "intrinsic": np.mean(self.intrinsics, axis=0).tolist(),
            "average_pose": np.asarray(self.average_pose).tolist(),
            "near": self.near,
            "far": self.far,
        }
        if self.ndc:
            mc["near_ndc"] = self.near_ndc
            mc["far_ndc"] = self.far_ndc
        return mc

    def get_model_configs(self):
        return self.model_configs

    # -------------------------------------------------------- index streams

    def _generate_indices(self, iter_num: int) -> np.ndarray:
        """Shuffled global ray-index stream, inside the precrop window while
        it lasts."""
        n = self.num_frames
        h, w = self.resolution
        indices = np.arange(n * h * w)
        dl = self.configs["data_loader"]
        if (
            "precrop_fraction" in dl
            and dl["precrop_fraction"] < 1
            and iter_num < dl.get("precrop_iterations", -1)
        ):
            frac = dl["precrop_fraction"]
            h1, h2 = int(round(h / 2 * (1 - frac))), int(round(h / 2 * (1 + frac)))
            w1, w2 = int(round(w / 2 * (1 - frac))), int(round(w / 2 * (1 + frac)))
            indices = indices.reshape(n, h, w)[:, h1:h2, w1:w2].ravel().copy()
        self._rng.shuffle(indices)
        return indices

    def _next_nerf_indices(self, iter_num: int) -> np.ndarray:
        precrop_end = self.configs["data_loader"].get("precrop_iterations", -1)
        n_full = self.num_frames * self.resolution[0] * self.resolution[1]
        if precrop_end > 0 and iter_num >= precrop_end and self._indices.size < n_full:
            # the precrop window ended (or a resume lies past it): full stream
            self._indices = self._generate_indices(iter_num)
            self._i_batch = 0
        # a copy: the epoch reshuffle below permutes self._indices in place
        out = self._indices[self._i_batch:self._i_batch + self.num_rays].copy()
        self._i_batch += self.num_rays
        if self._i_batch >= self._indices.size:
            self._rng.shuffle(self._indices)
            self._i_batch = 0
        if out.size < self.num_rays:  # epoch tail: wrap, consuming the new head
            wrap = self.num_rays - out.size
            out = np.concatenate([out, self._indices[:wrap]])
            self._i_batch = wrap
        return out

    def _next_sd_indices(self) -> np.ndarray:
        k = self.num_rays_sparse_depth
        out = self._indices_sd[self._i_batch_sd:self._i_batch_sd + k].copy()
        self._i_batch_sd += k
        if self._i_batch_sd >= self._indices_sd.size:
            self._rng.shuffle(self._indices_sd)
            self._i_batch_sd = 0
        if out.size < k:
            wrap = k - out.size
            out = np.concatenate([out, self._indices_sd[:wrap]])
            self._i_batch_sd = wrap
        return out

    def get_index_chunk(self, start_iter: int, num_iters: int):
        """Index blocks of `num_iters` steps: (nerf (K, num_rays) int32,
        sparse-depth (K, num_rays_sd) int32 or None). The native NeRF stream
        leaves the precrop window at a chunk that starts at or past
        `precrop_iterations`: the trainer cuts its chunks there."""
        if self._native_nerf is not None:
            precrop_end = self.configs["data_loader"].get("precrop_iterations", -1)
            n_full = self.num_frames * self.resolution[0] * self.resolution[1]
            if start_iter >= precrop_end > 0 and self._native_nerf.size < n_full:
                self._native_nerf.reset(count=n_full)
            nerf = self._native_nerf.next_block(num_iters, self.num_rays)
            sd = None
            if self._native_sd is not None:
                sd = self._native_sd.next_block(num_iters, self.num_rays_sparse_depth)
            return nerf, sd
        nerf = np.stack(
            [self._next_nerf_indices(start_iter + i) for i in range(num_iters)]
        ).astype(np.int32)
        sd = None
        if self.sparse_depth_needed and self.mode == "train":
            sd = np.stack([self._next_sd_indices() for _ in range(num_iters)]).astype(np.int32)
        return nerf, sd

    # ----------------------------------------------------------- batch build

    def gather_batch(
        self, nerf_indices: torch.Tensor, sd_indices: Optional[torch.Tensor], iter_num: int,
        *, cache: Optional[Dict[str, torch.Tensor]] = None, near: Optional[torch.Tensor] = None,
        far: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """A training batch from the cache: [nerf rays; sparse-depth rays],
        boolean stream masks, -1 in the fields of the other stream.

        S scenes at once: `cache` holds their caches stacked along the ray
        axis (poses (S, nf, 4, 4)), the index rows are (S, R) flat indices
        into it, `near`/`far` (S,); the batch is the S scenes' batches one
        after the other, each [nerf; sparse-depth]."""
        cache = self.cache if cache is None else cache
        nerf_indices = nerf_indices.to(self.device, torch.int64)
        n_nerf = nerf_indices.shape[-1]
        if sd_indices is not None:
            indices = torch.cat([nerf_indices, sd_indices.to(self.device, torch.int64)], dim=-1)
        else:
            indices = nerf_indices
        per_scene = indices.shape[-1]
        mask_nerf = (torch.arange(per_scene, device=self.device) < n_nerf).repeat(indices.numel() // per_scene)
        indices = indices.reshape(-1)
        nr = indices.shape[0]
        mask_sd = ~mask_nerf if sd_indices is not None else None

        def take(key):
            return cache[key].index_select(0, indices)

        def on(mask, key):
            return torch.where(mask[:, None], take(key), torch.full((), -1.0, device=self.device))

        full = lambda v: torch.full((nr, 1), float(v), device=self.device)  # noqa: E731

        def per_ray(v, own):  # one value per scene, or this scene's
            return full(own) if v is None else v.to(self.device).repeat_interleave(per_scene)[:, None]

        batch: Dict[str, Any] = {
            "iter_num": iter_num,
            "num_frames": self.num_frames,
            "indices": indices,
            "indices_mask_nerf": mask_nerf,
            "rays_o": take("rays_o"),
            "rays_d": take("rays_d"),
            "view_dirs": take("view_dirs"),
            "pixel_id": take("pixel_id"),
            "target_rgb": on(mask_nerf, "target_rgb"),
            "near": per_ray(near, self.near),
            "far": per_ray(far, self.far),
        }
        if self.ndc:
            batch["rays_o_ndc"] = take("rays_o_ndc")
            batch["rays_d_ndc"] = take("rays_d_ndc")
            batch["near_ndc"] = full(self.near_ndc)
            batch["far_ndc"] = full(self.far_ndc)
        if mask_sd is not None:
            batch["indices_mask_sparse_depth"] = mask_sd
            batch["sparse_depth_values"] = on(mask_sd, "sparse_depth_values")
            batch["sparse_depth_errors"] = on(mask_sd, "sparse_depth_errors")
            if self.ndc:
                batch["sparse_depth_values_ndc"] = on(mask_sd, "sparse_depth_values_ndc")
        if self.mode == "train":
            if self.dense_depth_needed:
                batch["dense_depth_values"] = on(mask_nerf, "dense_depth_values")
                batch["dense_depth_weights"] = on(mask_nerf, "dense_depth_weights")
                if self.ndc:
                    batch["dense_depth_values_ndc"] = on(mask_nerf, "dense_depth_values_ndc")
            if self.poses_needed:
                batch["poses"] = cache["poses"]
            if self.visibility_prior_needed:
                for key in ("visibility_prior_masks", "visibility_prior_weights"):
                    if key in cache:
                        batch[key] = on(mask_nerf, key)
        return batch

    def load_uncached_next_batch(self, iter_num: int, image_num: Optional[int] = None) -> Dict[str, Any]:
        """Without batching: random rays of one random image, or all rays of
        `image_num`, generated on the fly."""
        h, w = self.resolution
        if image_num is None:
            img_i = int(self._rng.integers(0, self.num_frames))
        else:
            img_i = int(np.where(self.frame_nums == image_num)[0].item())
        rays_o_img, rays_d_img = self._image_rays(img_i)
        rays_o, rays_d = rays_o_img.reshape(-1, 3), rays_d_img.reshape(-1, 3)
        target = self._tensor(self.images[img_i].reshape(-1, 3))
        gx, gy = np.meshgrid(np.arange(w, dtype=np.int32), np.arange(h, dtype=np.int32), indexing="xy")
        pixel_id = self._tensor(
            np.stack([np.full((h, w), img_i, np.int32), gx, gy], axis=-1).reshape(-1, 3), torch.int32
        )
        if image_num is None:
            sel = self._tensor(np.sort(self._rng.choice(h * w, size=self.num_rays, replace=False)),
                               torch.int64)
            rays_o, rays_d, target, pixel_id = rays_o[sel], rays_d[sel], target[sel], pixel_id[sel]
        nr = rays_o.shape[0]
        full = lambda v: torch.full((nr, 1), float(v), device=self.device)  # noqa: E731
        batch = {
            "iter_num": iter_num,
            "num_frames": self.num_frames,
            "rays_o": rays_o,
            "rays_d": rays_d,
            "view_dirs": ray_ops.get_view_dirs(rays_d),
            "target_rgb": target,
            "pixel_id": pixel_id,
            "indices_mask_nerf": torch.ones(nr, dtype=torch.bool, device=self.device),
            "near": full(self.near),
            "far": full(self.far),
        }
        if self.ndc:
            batch["rays_o_ndc"], batch["rays_d_ndc"] = self._ndc(rays_o, rays_d, img_i)
            batch["near_ndc"] = full(self.near_ndc)
            batch["far_ndc"] = full(self.far_ndc)
        if self.poses_needed and self.mode == "train":
            batch["poses"] = self._tensor(self.poses)
        return batch

    def get_next_batch(self, iter_num: int, image_num: Optional[int] = None) -> Dict[str, Any]:
        """The next training batch, or with `image_num` all h*w rays of that
        frame in scanline order (validation; no sparse-depth stream)."""
        if not self.use_batching:
            return self.load_uncached_next_batch(iter_num, image_num)
        if image_num is None:
            nerf_idx = torch.as_tensor(self._next_nerf_indices(iter_num))
            sd_idx = None
            if self.sparse_depth_needed and self.mode == "train":
                sd_idx = torch.as_tensor(self._next_sd_indices())
            return self.gather_batch(nerf_idx, sd_idx, iter_num)
        h, w = self.resolution
        image_index = int(np.where(self.frame_nums == image_num)[0].item())
        indices = torch.arange(h * w, device=self.device) + image_index * h * w
        return self.gather_batch(indices, None, iter_num)

    # ------------------------------------------------------------- inference

    def _prep_pose(self, pose: np.ndarray, preprocess_pose: bool) -> np.ndarray:
        if not preprocess_pose:
            return pose.astype(np.float32)
        mc = self.model_configs
        return pose_ops.preprocess_poses(
            pose[None],
            train_mode=False,
            translation_scale=mc["translation_scale"],
            average_pose=np.asarray(mc["average_pose"]),
        )["poses"][0]

    def _rays(self, h, w, intrinsic, pose):
        return ray_ops.get_rays(
            h, w,
            torch.as_tensor(self._ray_intrinsic(intrinsic).astype(np.float32)),
            torch.as_tensor(pose, device=self.device),
        )

    def create_test_data(
        self,
        pose: np.ndarray,
        view_pose: Optional[np.ndarray] = None,
        secondary_poses: Optional[List[np.ndarray]] = None,
        preprocess_pose: bool = True,
        intrinsic: Optional[np.ndarray] = None,
        view_intrinsic: Optional[np.ndarray] = None,
        secondary_intrinsics: Optional[List[np.ndarray]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Full-image ray batch (h*w rays, scanline order) for a w2c pose, on
        the preprocessor's device. Secondary poses give `rays_o2`, the other
        cameras' centres per ray (their intrinsics do not move a centre)."""
        mc = self.model_configs
        h, w = mc["resolution"]
        if intrinsic is None:
            intrinsic = np.array(mc["intrinsic"])
        intrinsic = np.asarray(intrinsic, dtype=np.float32)

        rays_o, rays_d = self._rays(h, w, intrinsic, self._prep_pose(pose.copy(), preprocess_pose))
        if view_pose is not None:
            vi = np.array(mc["intrinsic"]) if view_intrinsic is None else view_intrinsic
            _, view_rays_d = self._rays(
                h, w, np.asarray(vi, np.float32), self._prep_pose(view_pose.copy(), preprocess_pose)
            )
            view_dirs = ray_ops.get_view_dirs(view_rays_d)
        else:
            view_dirs = ray_ops.get_view_dirs(rays_d)

        nr = h * w
        full = lambda v: torch.full((nr, 1), float(v), device=self.device)  # noqa: E731
        batch = {
            "rays_o": rays_o.reshape(-1, 3),
            "rays_d": rays_d.reshape(-1, 3),
            "view_dirs": view_dirs.reshape(-1, 3),
            "near": full(mc["near"]),
            "far": full(mc["far"]),
        }
        if self.ndc:
            o_ndc, d_ndc = ray_ops.get_ndc_rays(
                rays_o, rays_d, h, w, float(intrinsic[0, 0]), float(intrinsic[1, 1]),
                mc["near"],
            )
            batch["rays_o_ndc"] = o_ndc.reshape(-1, 3)
            batch["rays_d_ndc"] = d_ndc.reshape(-1, 3)
            batch["near_ndc"] = full(mc["near_ndc"])
            batch["far_ndc"] = full(mc["far_ndc"])

        if secondary_poses is not None:
            centres = [
                torch.as_tensor(self._prep_pose(p.copy(), preprocess_pose)[:3, 3],
                                device=self.device)
                for p in secondary_poses
            ]
            batch["rays_o2"] = torch.stack(centres)[None].expand(nr, -1, -1).contiguous()
        return batch

    def retrieve_inference_outputs(self, outputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Fine (else coarse) outputs reshaped to the image and post-processed."""
        h, w = self.model_configs["resolution"]
        if "fine_mlp" in self.configs["model"]:
            suffix = "_fine"
        elif "coarse_mlp" in self.configs["model"]:
            suffix = "_coarse"
        else:
            raise RuntimeError("no mlp configured")
        np_out = {
            k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in outputs.items()
        }
        result = {
            "image": self.post_process_image(np_out[f"rgb{suffix}"].reshape(h, w, 3)),
            "depth": self.post_process_depth(np_out[f"depth{suffix}"].reshape(h, w)),
            "depth_var": self.post_process_depth(np_out[f"depth_var{suffix}"].reshape(h, w)),
        }
        if self.ndc:
            result["depth_ndc"] = self.post_process_depth(
                np_out[f"depth_ndc{suffix}"].reshape(h, w)
            )
            result["depth_var_ndc"] = self.post_process_depth(
                np_out[f"depth_var_ndc{suffix}"].reshape(h, w)
            )
        if f"visibility2{suffix}" in np_out:
            vis2 = np_out[f"visibility2{suffix}"].reshape(h, w, -1)
            result["visibility2"] = vis2.transpose(2, 0, 1).astype(np.float32)
        return result

    @staticmethod
    def post_process_image(rgb: np.ndarray) -> np.ndarray:
        return np.round(np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)

    @staticmethod
    def post_process_depth(depth: np.ndarray) -> np.ndarray:
        return np.clip(depth, 0.0, np.inf).astype(np.float32)

"""Four input views (n_sec 3, ViP-NeRF's demo1c, the benchmark's `llff_4view`)
on the port's normal path against the benchmark's plain reference
(`benchmark/reference/`), on the CPU at the benchmark's tiny size with its
seeded random weights; K1's plain version stands in for the kernel here.

- One training batch, alone and as two scenes in lockstep (the stacked
  model, one render of both scenes' rays): its rays, each ray's three other
  cameras, the four loss terms and `TotalLoss`, the rendered colour and
  depth, and the first step's gradient by the reference's `leaf_norm_gaps`,
  each scene against the reference run on that scene alone; and each
  ray's three prior masks (random here), in the order of its other views.
- `_gather_secondary_origins` over stacked poses of 4 views.
- The span `rays.<level>.sec_dirs`: recorded in training, timed on the
  rays' device; elsewhere only under a profiler.
- The counter `vis.sec_view_points`: points x n_sec of a step at n_sec 1-3.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

_BENCH_TESTS = Path(__file__).resolve().parent.parent / "benchmark" / "tests"
if str(_BENCH_TESTS) not in sys.path:
    sys.path.insert(0, str(_BENCH_TESTS))
_TB_IMPORTED = "tensorboard" in sys.modules
import bench_support  # noqa: E402  (puts the benchmark and the repository on the import path)

if not _TB_IMPORTED and sys.modules.get("tensorboard", False) is None:
    del sys.modules["tensorboard"]  # bench_support keeps TensorBoard out; the other test files may want it

from harness import common, scene, train  # noqa: E402
from reference import driver, nerf  # noqa: E402

from vipnerf_tpu_torch.data.loaders import get_data_loader  # noqa: E402
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor  # noqa: E402
from vipnerf_tpu_torch.kernels import fused_mlp as k1  # noqa: E402
from vipnerf_tpu_torch.losses import LossComputer  # noqa: E402
from vipnerf_tpu_torch.models import vip_nerf  # noqa: E402
from vipnerf_tpu_torch.train.multi_scene import MultiSceneTrainer  # noqa: E402
from vipnerf_tpu_torch.utils import tracing  # noqa: E402

SEED = bench_support.SEED
CPU = torch.device("cpu")
TERMS = ("MSE01", "VisibilityLoss01", "VisibilityPriorLoss01", "SparseDepthMSE01", "TotalLoss")
# Both sides compute in f32 with the trunk's products rounded to bf16; they
# part only where an f32 sum lands on the other side of a bf16 rounding
# boundary (the reference rounds the f32 product of f32 matmuls, K1's plain
# version rounds torch's bf16 matmul). Measured here (alone and both scenes
# in lockstep): the colour, visibility and prior terms within 6e-7 of the
# reference, relatively, the sparse-depth term and the total within 3e-5
# (a depth moves with a fine sample, and the total carries it); colours
# within 3e-5 at the worst ray, depths 2e-4 relatively; the gradient's worst
# leaf 1.7e-3 off. The program with bf16 heads (a lower precision than the
# configuration states) reads 5e-5 to 1.4e-4 on the colour term, 2.5e-5 to
# 5e-5 on the visibility term and 1.6e-5 to 6e-5 on the prior: the first
# three limits, ~10x over the program, fail it.
LOSS_RTOL = {"MSE01": 5e-6, "VisibilityLoss01": 5e-6, "VisibilityPriorLoss01": 5e-6, "SparseDepthMSE01": 2e-4,
             "TotalLoss": 2e-4}
RGB_ATOL = 3e-4  # 10x the worst ray's colour gap: a bf16 step of the trunk's output moves it < 2^-8 / 4
DEPTH_RTOL = 2e-3  # 10x the worst ray's: a moved fine sample shifts its depth by part of a bin
GRAD_GAP = 1e-2  # the worst leaf's round-off through the backward, ~6x the worst measured


@pytest.fixture(scope="module")
def four_views(tmp_path_factory):
    return make_four_views(tmp_path_factory.mktemp("four_views"))


def make_four_views(root: Path):
    """Two tiny `llff_4view` scenes (8 frames, train 0, 2, 5, 7) under `root`
    with random prior masks, and the benchmark's seeded weights for both."""
    cfg = bench_support.tiny_config("llff_4view")
    mix = bench_support.tiny_mix("train_batched")
    mix["scenes"] = 2
    gts = [train.scene_inputs(cfg, root, SEED, i) for i in range(2)]
    rng = np.random.default_rng(7)
    for gt in gts:
        vis_dir = root / "data/databases/NeRF_LLFF/data/all/visibility_prior/VW04" / gt["scene_name"]
        for (f1, f2) in gt["masks"]:
            gt["masks"][f1, f2] = rng.random(gt["masks"][f1, f2].shape) < 0.5
            scene.write_png(vis_dir / f"visibility_masks/{f1:04}_{f2:04}.png",
                            gt["masks"][f1, f2].astype(np.uint8) * 255)
    names = [g["scene_name"] for g in gts]
    configs = train.program_configs(cfg, mix, root, SEED, CPU, names)
    weights = common.seeded_weights(cfg["train_configs"]["model"], SEED, CPU, scenes=2)
    return {"cfg": cfg, "mix": mix, "root": root, "gts": gts, "names": names, "configs": configs,
            "db": root / "data" / configs["database_dirpath"], "weights": weights}


def _single_scene_step(fv):
    """Scene 0 alone: its first training batch, rendered, its losses and
    the gradient of its total loss."""
    configs = dict(fv["configs"])
    configs["data_loader"] = dict(configs["data_loader"], scene_id=fv["names"][0])
    prep = get_data_preprocessor(configs, "train", device=CPU,
                                 raw_data_dict=get_data_loader(configs, fv["db"], "train").load_data())
    it = fv["mix"]["start_iter"]
    nerf_idx, sd_idx = prep.get_index_chunk(it, 1)
    batch = prep.gather_batch(torch.from_numpy(nerf_idx[0]), torch.from_numpy(sd_idx[0]), it)
    model = vip_nerf.ViPNeRF(configs, torch.Generator().manual_seed(0))
    common.load_weights(model, fv["weights"][:1])
    g = torch.Generator().manual_seed((SEED << 32) + it)  # the trainer's step seed
    out = vip_nerf.render_rays(model, configs, batch, train=True, generator=g)
    losses = LossComputer(configs).compute_losses(batch, out)
    terms = {k: (v["loss_value"] if isinstance(v, dict) else v) for k, v in losses.items()}
    terms["TotalLoss"].backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    terms = {k: v.detach() for k, v in terms.items()}
    o2 = vip_nerf._gather_secondary_origins(batch["poses"], batch["pixel_id"])
    return [{"batch": batch, "out": out, "terms": terms, "grads": grads, "indices": batch["indices"], "o2": o2}], it


def _lockstep_step(fv):
    """Both scenes as `MultiSceneTrainer` trains them: the stacked caches,
    one gather of both scenes' rows, one render of the stacked model, the
    per-scene losses and one backward of their sum. Returns each scene's
    share."""
    trainer = MultiSceneTrainer(fv["configs"], fv["names"], fv["db"], CPU, None, verbose_log=False)
    common.load_weights(trainer.model, fv["weights"])
    it = fv["mix"]["start_iter"]
    nerf_rows, sd_rows = trainer._index_rows(it, 1)
    prep0 = trainer.preprocessors[0]
    batch = prep0.gather_batch(torch.from_numpy(nerf_rows[:, 0]), torch.from_numpy(sd_rows[:, 0]), it,
                               cache=trainer.cache, near=trainer.near, far=trainer.far)
    g = torch.Generator().manual_seed((SEED << 32) + it)
    out = vip_nerf.render_rays(trainer.model, trainer.configs, batch, train=True, generator=g)
    losses = trainer.loss_computer.scene_losses(batch, out, 2)
    terms = {k: (v["loss_value"] if isinstance(v, dict) else v) for k, v in losses.items()}
    terms["TotalLoss"].sum().backward()
    nr = batch["rays_o"].shape[0]
    per = nr // 2
    o2 = vip_nerf._gather_secondary_origins(batch["poses"], batch["pixel_id"])  # over the stacked poses
    scenes = []
    for s in range(2):
        rows = slice(s * per, (s + 1) * per)
        scenes.append({
            "batch": {k: (v[rows] if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == nr else v)
                      for k, v in batch.items()},
            "out": {k: (v[rows] if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == nr else v)
                    for k, v in out.items()},
            "terms": {k: v[s].detach() for k, v in terms.items()},
            "grads": {k: p.grad[s] for k, p in trainer.model.named_parameters()},
            "indices": batch["indices"][rows] - s * trainer.rays_per_scene,
            "o2": o2[rows]})
    return scenes, it


@pytest.mark.parametrize("lockstep", [False, True], ids=["alone", "two_scenes_in_lockstep"])
def test_a_training_step_at_three_other_views_matches_the_reference(four_views, lockstep):
    fv = four_views
    cfg, h, w = fv["cfg"], fv["cfg"]["scene"]["height"], fv["cfg"]["scene"]["width"]
    scenes, it = (_lockstep_step if lockstep else _single_scene_step)(fv)
    for s, got in enumerate(scenes):
        gt = fv["gts"][s]
        ref = driver.train_steps(cfg, fv["mix"], gt, fv["weights"][s], [{"indices": got["indices"], "iter": it}],
                                 SEED, CPU, len(scenes), s)
        # the rays of the sampled pixels, and each ray's three other cameras
        idx = got["indices"].numpy().astype(np.int64)
        frame = driver.scene_frame(cfg, gt)
        fi = idx // (h * w)
        rays = driver._rays(cfg, frame, frame["poses"][fi], gt["intrinsic"], idx % (h * w) % w,
                            idx % (h * w) // w, frame["near"], frame["far"])
        batch = got["batch"]
        assert np.abs(rays["d"] - batch["rays_d"].numpy()).max() < 1e-6
        assert np.abs(rays["o_ndc"] - batch["rays_o_ndc"].numpy()).max() < 1e-5
        assert np.abs(rays["d_ndc"] - batch["rays_d_ndc"].numpy()).max() < 1e-5
        others = np.array([[j + (j >= i) for j in range(3)] for i in fi])
        assert got["o2"].shape == (len(idx), 3, 3)
        assert np.abs(frame["poses"][others][..., :3, 3] - got["o2"].numpy()).max() < 1e-5
        assert got["out"]["visibility2_coarse"].shape[-1] == 3 and got["out"]["visibility2_fine"].shape[-1] == 3
        # each NeRF ray's three prior masks, in the order of its other views
        train_frames = cfg["scene"]["train_frames"]
        nerf_rows = batch["indices_mask_nerf"].numpy()
        ys, xs = idx % (h * w) // w, idx % (h * w) % w
        want = np.array([[gt["masks"][train_frames[i], train_frames[j]][y, x] for j in row]
                         for i, row, y, x in zip(fi, others, ys, xs)], np.float32)
        masks = batch["visibility_prior_masks"].numpy()
        assert np.array_equal(masks[nerf_rows], want[nerf_rows])
        assert not np.array_equal(masks[nerf_rows], want[nerf_rows][:, [1, 2, 0]])
        # the four terms and their total
        for name in TERMS:
            assert float(got["terms"][name]) == pytest.approx(ref["losses"][0][name], rel=LOSS_RTOL[name]), name
        assert ref["losses"][0]["VisibilityPriorLoss01"] > 0
        # what each ray rendered
        for level in ("coarse", "fine"):
            assert (got["out"][f"rgb_{level}"] - ref["outputs"][0][f"rgb_{level}"]).abs().max() < RGB_ATOL
            want = ref["outputs"][0][f"depth_{level}"]
            gap = (got["out"][f"depth_{level}"] - want).abs() / want.abs().clamp(min=1e-6)
            assert gap.max() < DEPTH_RTOL
        # the first step's gradient, leaf by leaf
        worst, leaf, skipped = nerf.leaf_norm_gaps(got["grads"], ref["grad1"])
        assert worst < GRAD_GAP, (leaf, worst)


def test_secondary_origins_at_four_views_over_stacked_poses():
    """S = 2 scenes of 4 views, R = 5 rays each: ray r of scene s takes the
    three other cameras of scene s, in the order of the views, skipping its
    own (other_id = j + (j >= image_id))."""
    scenes, views, per = 2, 4, 5
    poses = torch.zeros(scenes, views, 4, 4)
    for s in range(scenes):
        for v in range(views):
            poses[s, v, :3, 3] = torch.tensor([10.0 * s + v, -v, s])
    image_id = torch.tensor([0, 1, 2, 3, 1, 3, 2, 0, 0, 1])
    pixel_id = torch.stack([image_id, torch.arange(10), torch.arange(10)], dim=1)
    o2 = vip_nerf._gather_secondary_origins(poses, pixel_id)
    assert o2.shape == (scenes * per, views - 1, 3)
    for r in range(scenes * per):
        s, own = r // per, int(image_id[r])
        expect = [v for v in range(views) if v != own]
        assert torch.equal(o2[r], poses[s, expect, :3, 3]), r
    single = vip_nerf._gather_secondary_origins(poses[1], pixel_id[per:])
    assert torch.equal(single, o2[per:])


def _flagship_configs(coarse=4, fine=4):
    mlp = {"netdepth": 8, "netwidth": 256, "points_positional_encoding_degree": 10,
           "views_positional_encoding_degree": 4, "use_view_dirs": True, "view_dependent_rgb": True,
           "predict_visibility": True}
    return {"data_loader": {"ndc": False},
            "model": {"coarse_mlp": dict(mlp, num_samples=coarse), "fine_mlp": dict(mlp, num_samples=fine),
                      "lindisp": False, "perturb": True, "raw_noise_std": 1.0, "white_bkgd": False,
                      "bf16_matmuls": True, "f32_heads": True}}


def _rays(nr, n_sec, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(nr, 3, generator=g) * 0.2 + torch.tensor([0.0, 0.0, -1.0])
    return {"rays_o": torch.randn(nr, 3, generator=g) * 0.2, "rays_d": d,
            "view_dirs": d / d.norm(dim=-1, keepdim=True), "near": torch.full((nr, 1), 1.0),
            "far": torch.full((nr, 1), 6.0), "rays_o2": torch.randn(nr, n_sec, 3, generator=g)}


def test_the_sec_dirs_span_is_timed_in_training_only(monkeypatch):
    cfg = _flagship_configs()
    model = vip_nerf.ViPNeRF(cfg)
    batch = _rays(6, 3)
    timed = []
    span = tracing.span

    def recording_span(name, device=None, *args, **kwargs):
        timed.append((name, device))
        return span(name, device, *args, **kwargs)

    monkeypatch.setattr(tracing, "span", recording_span)
    tracing.reset()
    with tracing.span("train.forward"):
        vip_nerf.render_rays(model, cfg, batch, train=True, generator=torch.Generator().manual_seed(1))
    records = tracing.snapshot()["spans"]
    forward = next(r for r in records if r["name"] == "train.forward")
    sec = [r for r in records if r["name"].endswith(".sec_dirs")]
    assert [r["name"] for r in sec] == ["rays.coarse.sec_dirs", "rays.fine.sec_dirs"]
    assert all(r["parent"] == forward["id"] and r["device_ms"] is None for r in sec)  # no events on the CPU
    assert ("rays.coarse.sec_dirs", CPU) in timed and ("rays.fine.sec_dirs", CPU) in timed
    # outside training: recorded only under a profiler, and never timed
    timed.clear()
    tracing.reset()
    with torch.no_grad():
        vip_nerf.render_rays(model, cfg, batch, train=False, sec_views_vis=True)
    assert tracing.snapshot()["spans"] == [] and timed == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        vip_nerf.render_rays(model, cfg, batch, train=False, sec_views_vis=True)
    names = [r["name"] for r in sorted(tracing.snapshot()["spans"], key=lambda r: r["start_ns"])]
    assert names == ["rays.sample", "rays.coarse.points", "rays.coarse.sec_dirs", "rays.coarse.mlp",
                     "rays.coarse.composite", "rays.resample", "rays.fine.points", "rays.fine.sec_dirs",
                     "rays.fine.mlp", "rays.fine.composite"]
    assert timed == []


@pytest.mark.parametrize("n_sec", [1, 2, 3])
def test_the_counter_holds_points_times_other_views_of_a_step(n_sec):
    """One training step (render and backward) of 6 rays at 4 coarse and
    4 + 4 fine samples: K1 runs 6 x 4 points, then 6 x 8, each with n_sec
    other views; the backward sends nothing through the forward."""
    cfg = _flagship_configs()
    model = vip_nerf.ViPNeRF(cfg)
    tracing.reset()
    out = vip_nerf.render_rays(model, cfg, _rays(6, n_sec), train=True, generator=torch.Generator().manual_seed(2))
    (out["rgb_fine"].sum() + out["visibility2_fine"].sum()).backward()
    assert tracing.counts() == {k1.SEC_VIEW_POINTS: (6 * 4 + 6 * 8) * n_sec}
    tracing.reset()
    with torch.no_grad():
        vip_nerf.render_rays(model, cfg, _rays(6, n_sec), train=False)  # no other view: nothing counted
    assert tracing.counts() == {}

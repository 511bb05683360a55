"""ViP-NeRF's ablation without the sparse-depth prior (demo1d: 2 views, 1024
NeRF rays a step, MSE, visibility and visibility prior; the benchmark's
`llff_2view_vp`) on the port's normal path against the benchmark's plain
reference of the listed losses (`benchmark/reference/listed_losses.py`), on
the CPU at the benchmark's tiny size with its seeded random weights; K1's
plain version stands in for the kernel here.

- One training batch, alone and as two scenes in lockstep (the stacked
  model, one render of both scenes' rays): every ray a NeRF ray and no
  sparse-depth field, the three loss terms and `TotalLoss`, the rendered
  colour and depth of both levels, and the first step's gradient by the
  reference's `leaf_norm_gaps`, each scene against the reference run on
  that scene alone; the same with bf16 heads (a lower precision than the
  configuration states) fails at least one tolerance.
- Graphed steps of such batches (a stand-in graph on the CPU) equal the
  eager steps bit for bit.
- The counters `train.rays.nerf` and `train.rays.sparse_depth` (0 here)
  and the `train.log` spans' `scalars`, steps x scenes x (terms + lr), in
  both trainers.
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
from reference import listed_losses, nerf  # noqa: E402

from tests.test_torch_step_graph import graphed  # noqa: E402
from vipnerf_tpu_torch.data.loaders import get_data_loader  # noqa: E402
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor  # noqa: E402
from vipnerf_tpu_torch.losses import LossComputer  # noqa: E402
from vipnerf_tpu_torch.models import vip_nerf  # noqa: E402
from vipnerf_tpu_torch.train.multi_scene import MultiSceneTrainer  # noqa: E402
from vipnerf_tpu_torch.utils import tracing  # noqa: E402

SEED = bench_support.SEED
CPU = torch.device("cpu")
TERMS = ("MSE01", "VisibilityLoss01", "VisibilityPriorLoss01", "TotalLoss")
SD_KEYS = ("indices_mask_sparse_depth", "sparse_depth_values", "sparse_depth_errors", "sparse_depth_values_ndc")
# Both sides compute in f32 with the trunk's products rounded to bf16; they
# part only where an f32 sum lands on the other side of a bf16 rounding
# boundary (the reference rounds the f32 product of f32 matmuls, K1's plain
# version rounds torch's bf16 matmul). Measured here, alone and both scenes
# in lockstep: every term within 1.8e-6 of the reference, relatively, the
# total within 1.3e-6; colours within 1.7e-5 at the worst ray, depths 1.1e-4
# relatively; the gradient's worst leaf 8.7e-4 off. With bf16 heads (a lower
# precision than the configuration states) the colour term reads 7e-5 to
# 2.5e-4 off, the visibility term 4e-5 to 1.4e-4, the prior 1.8e-5 to 5.6e-5
# and the total 5.5e-5 to 1.2e-4: the loss limit fails it on three terms and
# the total in every case.
LOSS_RTOL = 1e-5  # ~5x the worst term's gap: no sparse-depth term, whose depth moves with a fine sample
RGB_ATOL = 3e-4  # 10x the worst ray's colour gap: a bf16 step of the trunk's output moves it < 2^-8 / 4
DEPTH_RTOL = 2e-3  # 10x the worst ray's: a moved fine sample shifts its depth by part of a bin
GRAD_GAP = 1e-2  # the worst leaf's round-off through the backward, ~10x the worst measured


@pytest.fixture(scope="module")
def no_sd(tmp_path_factory):
    return make_scenes(tmp_path_factory.mktemp("no_sparse_depth"))


def make_scenes(root: Path):
    """Two tiny `llff_2view_vp` scenes (6 frames, train 0 and 5) under `root`
    with random prior masks, and the benchmark's seeded weights for both."""
    cfg = bench_support.tiny_config("llff_2view_vp")
    mix = bench_support.tiny_mix("train_s8")
    mix.update(scenes=2, scan_steps=2)
    gts = [train.scene_inputs(cfg, root, SEED, i) for i in range(2)]
    rng = np.random.default_rng(11)
    for gt in gts:
        vis_dir = root / "data/databases/NeRF_LLFF/data/all/visibility_prior/VW02" / gt["scene_name"]
        for (f1, f2) in gt["masks"]:
            gt["masks"][f1, f2] = rng.random(gt["masks"][f1, f2].shape) < 0.5
            scene.write_png(vis_dir / f"visibility_masks/{f1:04}_{f2:04}.png",
                            gt["masks"][f1, f2].astype(np.uint8) * 255)
    names = [g["scene_name"] for g in gts]
    configs = train.program_configs(cfg, mix, root, SEED, CPU, names)
    weights = common.seeded_weights(cfg["train_configs"]["model"], SEED, CPU, scenes=2)
    return {"cfg": cfg, "mix": mix, "root": root, "gts": gts, "names": names, "configs": configs,
            "db": root / "data" / configs["database_dirpath"], "weights": weights}


def _program_configs(fv, overrides):
    return dict(fv["configs"], model=dict(fv["configs"]["model"], **overrides))


def _single_scene_step(fv, overrides):
    """Scene 0 alone: its first training batch, rendered, its losses and
    the gradient of its total loss."""
    configs = _program_configs(fv, overrides)
    configs["data_loader"] = dict(configs["data_loader"], scene_id=fv["names"][0])
    prep = get_data_preprocessor(configs, "train", device=CPU,
                                 raw_data_dict=get_data_loader(configs, fv["db"], "train").load_data())
    it = fv["mix"]["start_iter"]
    nerf_idx, sd_idx = prep.get_index_chunk(it, 1)
    assert sd_idx is None
    batch = prep.gather_batch(torch.from_numpy(nerf_idx[0]), None, it)
    model = vip_nerf.ViPNeRF(configs, torch.Generator().manual_seed(0))
    common.load_weights(model, fv["weights"][:1])
    g = torch.Generator().manual_seed((SEED << 32) + it)  # the trainer's step seed
    out = vip_nerf.render_rays(model, configs, batch, train=True, generator=g)
    losses = LossComputer(configs).compute_losses(batch, out)
    terms = {k: (v["loss_value"] if isinstance(v, dict) else v) for k, v in losses.items()}
    terms["TotalLoss"].backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    terms = {k: v.detach() for k, v in terms.items()}
    return [{"batch": batch, "out": out, "terms": terms, "grads": grads, "indices": batch["indices"]}], it


def _lockstep_step(fv, overrides):
    """Both scenes as `MultiSceneTrainer` trains them: the stacked caches,
    one gather of both scenes' rows, one render of the stacked model, the
    per-scene losses and one backward of their sum. Returns each scene's
    share."""
    trainer = MultiSceneTrainer(_program_configs(fv, overrides), fv["names"], fv["db"], CPU, None,
                                verbose_log=False)
    common.load_weights(trainer.model, fv["weights"])
    it = fv["mix"]["start_iter"]
    nerf_rows, sd_rows = trainer._index_rows(it, 1)
    assert sd_rows is None and not trainer.with_sd
    batch = trainer.preprocessors[0].gather_batch(torch.from_numpy(nerf_rows[:, 0]), None, it, cache=trainer.cache,
                                                  near=trainer.near, far=trainer.far)
    g = torch.Generator().manual_seed((SEED << 32) + it)
    out = vip_nerf.render_rays(trainer.model, trainer.configs, batch, train=True, generator=g)
    losses = trainer.loss_computer.scene_losses(batch, out, 2)
    terms = {k: (v["loss_value"] if isinstance(v, dict) else v) for k, v in losses.items()}
    terms["TotalLoss"].sum().backward()
    nr = batch["rays_o"].shape[0]
    per = nr // 2

    def rows(tree, s):
        return {k: (v[s * per:(s + 1) * per] if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == nr else v)
                for k, v in tree.items()}

    return [{"batch": rows(batch, s), "out": rows(out, s), "terms": {k: v[s].detach() for k, v in terms.items()},
             "grads": {k: p.grad[s] for k, p in trainer.model.named_parameters()},
             "indices": batch["indices"][s * per:(s + 1) * per] - s * trainer.rays_per_scene} for s in range(2)], it


def _gaps(fv, lockstep, overrides):
    """Each scene's batch layout checked, and its gaps to the reference:
    each term's relative gap, the worst ray's colour and relative depth
    gap over both levels, the gradient's worst leaf."""
    cfg = fv["cfg"]
    scenes, it = (_lockstep_step if lockstep else _single_scene_step)(fv, overrides)
    out = []
    for s, got in enumerate(scenes):
        batch = got["batch"]
        assert not set(SD_KEYS) & set(batch)
        assert bool(batch["indices_mask_nerf"].all()) and batch["indices"].numel() == cfg["train_configs"][
            "data_loader"]["num_rays"]
        assert tuple(got["terms"]) == TERMS
        ref = listed_losses.train_steps(cfg, fv["mix"], fv["gts"][s], fv["weights"][s],
                                        [{"indices": got["indices"], "iter": it}], SEED, CPU, len(scenes), s)
        assert tuple(ref["losses"][0]) == TERMS and ref["losses"][0]["VisibilityPriorLoss01"] > 0
        gaps = {name: abs(float(got["terms"][name]) - ref["losses"][0][name]) / abs(ref["losses"][0][name])
                for name in TERMS}
        want = ref["outputs"][0]
        rendered = {k: v.detach() for k, v in got["out"].items() if torch.is_tensor(v)}
        gaps["rgb"] = max(float((rendered[f"rgb_{lv}"] - want[f"rgb_{lv}"]).abs().max()) for lv in ("coarse", "fine"))
        gaps["depth"] = max(float(((rendered[f"depth_{lv}"] - want[f"depth_{lv}"]).abs()
                                   / want[f"depth_{lv}"].abs().clamp(min=1e-6)).max()) for lv in ("coarse", "fine"))
        gaps["grad"] = nerf.leaf_norm_gaps(got["grads"], ref["grad1"])[0]
        out.append(gaps)
    return out


def _within(gaps):
    """The names of the gaps over their tolerance."""
    limits = dict({name: LOSS_RTOL for name in TERMS}, rgb=RGB_ATOL, depth=DEPTH_RTOL, grad=GRAD_GAP)
    return [name for name, limit in limits.items() if not gaps[name] < limit]


@pytest.mark.parametrize("lockstep", [False, True], ids=["alone", "two_scenes_in_lockstep"])
def test_a_training_step_without_sparse_depth_matches_the_reference(no_sd, lockstep):
    for gaps in _gaps(no_sd, lockstep, {}):
        assert _within(gaps) == [], gaps


@pytest.mark.parametrize("lockstep", [False, True], ids=["alone", "two_scenes_in_lockstep"])
def test_bf16_heads_fail_a_tolerance(no_sd, lockstep):
    """The program in a lower precision than the configuration states (bf16
    heads) is told apart from it by the tolerances."""
    for gaps in _gaps(no_sd, lockstep, {"f32_heads": False}):
        assert _within(gaps), gaps


def _lockstep_trainer(fv):
    trainer = MultiSceneTrainer(fv["configs"], fv["names"], fv["db"], CPU, None, verbose_log=False)
    common.load_weights(trainer.model, fv["weights"])
    return trainer


def test_graphed_steps_without_sparse_depth_equal_the_eager_steps(no_sd):
    """Four lockstep steps through `GraphedStep` (a stand-in graph that
    reruns the step at each replay): a warm-up, one capture of a batch with
    no sparse-depth field, then replays; the losses, the parameters and
    Adam's state are the eager steps' bit for bit."""
    it0 = no_sd["mix"]["start_iter"]
    runs = []
    for graph in (False, True):
        trainer = _lockstep_trainer(no_sd)
        step = graphed(trainer.train_step, trainer.optimizer, trainer.configs) if graph else trainer.train_step
        nerf_rows, _ = trainer._index_rows(it0, 4)
        losses = []
        for j in range(4):
            batch = trainer.preprocessors[0].gather_batch(torch.from_numpy(nerf_rows[:, j]), None, it0 + j,
                                                          cache=trainer.cache, near=trainer.near, far=trainer.far)
            trainer.generator.manual_seed((SEED << 32) + it0 + j)
            losses.append({k: v.clone() for k, v in step(trainer.model, batch, trainer.generator).items()})
        opt = trainer.optimizer
        runs.append((losses, [p.detach().clone() for p in trainer.model.parameters()]
                     + [opt.exp_avg.clone(), opt.exp_avg_sq.clone(), opt.count.clone()], step))
    (eager, eager_state, _), (replayed, replayed_state, step) = runs
    assert step.graph.captures == 1 and step.graph.replays == 3
    assert not {k for k, *_ in step.key[1]} & set(SD_KEYS)  # the captured batch's layout
    for a, b in zip(eager, replayed, strict=True):
        assert tuple(a) == tuple(b) == TERMS
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(eager_state, replayed_state, strict=True))


@pytest.mark.parametrize("scenes", [1, 2])
def test_a_run_counts_its_rays_and_logged_scalars(no_sd, scenes, tmp_path):
    """Two chunks of two steps through the trainer's own loop (`Trainer` for
    one scene, `MultiSceneTrainer` for two): each step counts its scenes'
    NeRF rays and no sparse-depth ray, and each chunk's `train.log` logs
    steps x scenes x (three terms, TotalLoss and the learning rate)."""
    fv = no_sd
    start, k = fv["mix"]["start_iter"], fv["mix"]["scan_steps"]
    configs = dict(fv["configs"], num_iterations=start + 2 * k)
    tracing.reset()
    if scenes == 1:
        trainer = train.single_scene(configs, fv["mix"], fv["db"], tmp_path, CPU, fv["weights"][:1],
                                     fv["names"][0])[0]
        trainer.train()
        trainer.logger.close()
    else:
        trainer = MultiSceneTrainer(configs, fv["names"], fv["db"], CPU, tmp_path / "runs", verbose_log=False)
        common.load_weights(trainer.model, fv["weights"])
        trainer.save_checkpoints(start)
        trainer.train(start + 2 * k)
        trainer.close()
    per_chunk = k * scenes * (len(TERMS) + 1)
    logs = [s for s in tracing.snapshot()["spans"] if s["name"] == "train.log"]
    assert [(s["attrs"]["it"], s["attrs"]["scalars"]) for s in logs] == [(start, per_chunk), (start + k, per_chunk)]
    counts = tracing.counts("train.")
    assert counts["train.log.scalars"] == 2 * per_chunk
    assert counts["train.rays.nerf"] == 2 * k * scenes * fv["cfg"]["train_configs"]["data_loader"]["num_rays"]
    assert counts["train.rays.sparse_depth"] == 0
    lines = (tmp_path / "runs" / fv["names"][0] / "logs" / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 2 * k * (len(TERMS) + 1)  # the first scene's scalars, as written

"""The loss guard (`train/guards.py`, applied by `train/step.py` `Adam`)
against the JAX package's optax `loss_guard`, and the trainers' `profiler`
hook.

The guard: both optimizers take the same parameters, gradients and loss
sequence (spikes during warmup, rejected spikes, a run of rejections that
fails open, recovery), with a learning-rate schedule steep enough that a
count that moved on a rejected step would change the next update. The same
steps are accepted (the guards' `skips` agree after every step), the EMA
and Adam's count agree, and the parameters agree within 1e-6 (f32 Adam
steps of ~1e-2 in different summation orders). With a scene axis, each
scene's guard against `vmap` of the optax wrapper.

The profiler hook: `profiler: {start_iter, num_iters}` traces exactly the
chunks that overlap the window (the JAX trainer's rule) into
logs/profile as Chrome traces.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_e2e_training import small_train_configs
from vipnerf_tpu.train.guards import LossGuardState
from vipnerf_tpu.train.step import make_optimizer as j_make_optimizer
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
from vipnerf_tpu_torch.train.guards import LossGuard
from vipnerf_tpu_torch.train.step import make_optimizer
from vipnerf_tpu_torch.train.trainer import start_training

GUARD = {"factor": 3.0, "ema_decay": 0.8, "warmup": 3, "max_consecutive_skips": 2}
# warmup takes the spike at 2; 40 and 45 are rejected, 50 is forced through
# (fail-open after 2 skips) and seeds a high EMA; 20 then passes under it
LOSSES = [1.0, 1.2, 30.0, 1.1, 40.0, 45.0, 50.0, 1.0, 20.0, 0.9, 1.0, 500.0, 0.8]
SHAPES = [(5, 3), (4,)]


def guard_configs():
    return {"optimizer": {"lr_decayer_name": "NeRFLearningRateDecayer01", "lr_initial": 1e-2,
                          "lr_decay": 0.005, "beta1": 0.9, "beta2": 0.99, "loss_guard": dict(GUARD)}}


def jax_guard_state(state):
    return [x for x in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, LossGuardState))
            if isinstance(x, LossGuardState)][0]


def run_both(scenes, losses):
    """Step both optimizers through `losses` ((T,) or (T, S)); returns the
    per-step skips of each side and the final parameters and guard states."""
    rng = np.random.default_rng(0)
    lead = () if scenes is None else (scenes,)
    init = [rng.normal(size=lead + s).astype(np.float32) for s in SHAPES]
    params_t = [torch.from_numpy(p.copy()) for p in init]
    opt = make_optimizer(guard_configs(), params_t, scenes=scenes)
    tx = j_make_optimizer(guard_configs())
    params_j = [jnp.asarray(p) for p in init]

    def update(g, s, p, loss):
        u, s = tx.update(g, s, p, loss=loss)
        return optax.apply_updates(p, u), s

    if scenes is None:
        state, j_update = tx.init(params_j), jax.jit(update)
    else:
        state, j_update = jax.vmap(tx.init)(params_j), jax.jit(jax.vmap(update))
    skips_t, skips_j = [], []
    for loss in losses:
        grads = [rng.normal(size=lead + s).astype(np.float32) for s in SHAPES]
        for p, g in zip(params_t, grads):
            p.grad = torch.from_numpy(g)
        opt.step(loss=torch.as_tensor(loss, dtype=torch.float32))
        params_j, state = j_update([jnp.asarray(g) for g in grads], state, params_j, jnp.asarray(loss, jnp.float32))
        skips_t.append(opt.guard.skips.numpy().copy())
        skips_j.append(np.asarray(jax_guard_state(state).skips).reshape(-1))
    return params_t, params_j, opt, jax_guard_state(state), np.array(skips_t), np.array(skips_j)


def test_guard_matches_optax():
    params_t, params_j, opt, jstate, skips_t, skips_j = run_both(None, LOSSES)
    np.testing.assert_array_equal(skips_t, skips_j)
    accepted = skips_t[:, 0] == 0
    # warmup, rejected spikes, fail-open after two skips, recovery
    np.testing.assert_array_equal(accepted, [1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 1])
    assert int(opt.count[0]) == accepted.sum() and int(opt.guard.count[0]) == len(LOSSES)
    np.testing.assert_allclose(float(opt.guard.ema[0]), float(jstate.ema), rtol=1e-6)
    for t, j in zip(params_t, params_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-5)


def test_rejected_step_holds_parameters_moments_and_count():
    cfg = guard_configs()
    params = [torch.zeros(3)]
    opt = make_optimizer(cfg, params)
    for loss in (1.0, 1.0, 1.0):
        params[0].grad = torch.ones(3)
        opt.step(loss=torch.tensor(loss))
    held = [params[0].clone(), opt.exp_avg.clone(), opt.exp_avg_sq.clone(), opt.count.clone()]
    params[0].grad = torch.full((3,), 7.0)
    opt.step(loss=torch.tensor(100.0))
    for a, b in zip(held, [params[0], opt.exp_avg, opt.exp_avg_sq, opt.count]):
        assert torch.equal(a, b)
    # the guard's state travels with the optimizer's checkpoint state
    restored = make_optimizer(cfg, [torch.zeros(3)])
    restored.load_state_dict(opt.state_dict())
    assert restored.guard.state(0) == opt.guard.state(0) == {
        "ema": pytest.approx(1.0), "count": 4, "skips": 1}


def test_one_guard_per_scene_matches_vmapped_optax():
    """Two scenes with different loss sequences: each scene's guard decides
    alone (scene 1 rejects where scene 0 accepts), as vmap of the optax
    wrapper gives; parameters within 1e-6."""
    losses = np.stack([LOSSES, [1.0] * 5 + [9.0] + [1.0] * 7], axis=1).astype(np.float32)
    params_t, params_j, opt, jstate, skips_t, skips_j = run_both(2, losses)
    np.testing.assert_array_equal(skips_t, skips_j)
    assert (skips_t[:, 0] != skips_t[:, 1]).any()
    np.testing.assert_array_equal(opt.count.numpy(), (skips_t == 0).sum(0))
    np.testing.assert_allclose(opt.guard.ema.numpy(), np.asarray(jstate.ema), rtol=1e-6)
    for t, j in zip(params_t, params_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-5)


def test_guard_decides_on_the_device_without_reading_back():
    guard = LossGuard(2, "cpu", warmup=0)
    accept = guard(torch.tensor([1.0, 2.0]))
    assert accept.dtype == torch.bool and accept.all()
    assert torch.equal(guard(torch.tensor([50.0, 2.0])), torch.tensor([False, True]))


def test_profiler_traces_the_chunks_overlapping_the_window(tmp_path):
    """6 steps in chunks of 2 with the window [3, 5): the chunks [2, 4) and
    [4, 6) are traced, [0, 2) is not; each file is a Chrome trace."""
    torch.set_num_threads(2)
    write_synthetic_database(tmp_path / "data/databases", scene_name="synth01", num_frames=6,
                             train_frames=(0, 5), val_frames=(2,), height=16, width=20)
    cfg = small_train_configs(tmp_path, num_iterations=6)
    cfg.update(device="cpu", seed=1, scan_steps=2, profiler={"start_iter": 3, "num_iters": 2})
    cfg["data_loader"].update(num_rays=32, sparse_depth={"dirname": "DE02", "num_rays": 16})
    start_training(copy.deepcopy(cfg))
    profile = tmp_path / "runs/training/train0001/synth01/logs/profile"
    traces = sorted(p.name for p in profile.iterdir())
    assert traces == ["chunk_000002-000004.json", "chunk_000004-000006.json"]
    events = json.loads((profile / traces[0]).read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)

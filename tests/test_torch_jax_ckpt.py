"""The JAX-checkpoint bridge (vipnerf_tpu_torch/utils/jax_ckpt.py) and the
port's checkpoint repairs, against the JAX package.

- Codec: the port's msgpack writer gives flax.serialization's bytes for a
  params tree, an optax state with the loss guard and clipping, and a whole
  checkpoint; its reader restores what flax wrote; flax's chunked form and
  foreign ext types raise.
- JAX -> port: the JAX package takes K Adam steps of the small e2e model
  (tests/test_e2e_training.py's 6x32 MLPs, perturbation off) on seeded
  batches and saves; the port imports the .ckpt and resumes for K steps,
  the JAX package resumes for K steps. Parameters within 1e-4 absolute, the
  tolerance tests/test_torch_losses.py holds K steps of the two optimizers
  to (f32, summation order compounded over the steps); Adam's count and the
  learning rate equal; the guard's count and skips equal, its EMA within
  1e-6 relative.
- Port -> JAX: the port takes the K steps and saves a .tar; the exported
  .ckpt resumes through vipnerf_tpu.train.checkpoints.load_checkpoint; the
  same checks. A .tar -> .ckpt -> .tar round trip is bit for bit.
- Repairs: the port's .tar loads into a DataParallel-wrapped model with
  strict=True; a reference Adam state (torch.optim.Adam over the port's own
  module: the reference's keys and parameter order) with string indices, a
  missing index, a smaller count in entry 0 or no entries loads as
  vipnerf_tpu.utils.reference_ckpt.convert_checkpoint migrates it:
  moments, count and learning rate equal.
"""

import copy
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_e2e_training import small_train_configs
from tests.test_torch_losses import step_batch, torch_tree
from vipnerf_tpu.losses import LossComputer as JLossComputer
from vipnerf_tpu.models import vip_nerf as j_vn
from vipnerf_tpu.train import checkpoints as j_ckpt
from vipnerf_tpu.train.lr_schedules import get_lr_schedule
from vipnerf_tpu.train.step import make_optimizer as j_make_optimizer
from vipnerf_tpu.train.step import make_train_step as j_make_train_step
from vipnerf_tpu.utils import reference_ckpt
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models import vip_nerf as t_vn
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step
from vipnerf_tpu_torch.utils import jax_ckpt
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params

K = 3
GUARD = {"factor": 10.0, "ema_decay": 0.9, "warmup": 1, "max_consecutive_skips": 100}


def bridge_configs(guard: bool, clip: bool = True):
    cfg = small_train_configs("/nonexistent")
    cfg["model"]["perturb"] = False
    cfg["optimizer"]["lr_initial"] = 5e-3
    cfg["optimizer"]["lr_decay"] = 1  # a steep schedule: a count off by one changes the next update
    if clip:
        cfg["optimizer"]["grad_clip_norm"] = 0.05
    if guard:
        cfg["optimizer"]["loss_guard"] = dict(GUARD)
    return cfg


def jax_batch(it):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in step_batch(it).items()}


class JaxSide:
    def __init__(self, cfg):
        self.cfg = cfg
        self.tx = j_make_optimizer(cfg)
        self.step = jax.jit(j_make_train_step(cfg, j_vn.render_rays, JLossComputer(cfg), self.tx))
        self.template = j_vn.init_params(jax.random.PRNGKey(0), cfg)

    def run(self, params, opt_state, its):
        for it in its:
            params, opt_state, _ = self.step(params, opt_state, jax_batch(it), jax.random.PRNGKey(0))
        return params, opt_state

    def load(self, path):
        return j_ckpt.load_checkpoint(path, self.template, self.tx.init(self.template))


def port_run(cfg, model, optimizer, its):
    step = make_train_step(cfg, t_vn.render_rays, LossComputer(cfg), optimizer)
    for it in its:
        step(model, torch_tree(step_batch(it)), None)


def adam_state(opt_state):
    return next(x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))


def guard_state(opt_state):
    return next((x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "skips"))
                 if hasattr(x, "skips")), None)


def assert_same_run(cfg, model, optimizer, params, opt_state):
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
    count = int(adam_state(opt_state).count)
    assert int(optimizer.count[0]) == count == 2 * K
    assert optimizer.state_dict()["param_groups"][0]["lr"] == float(get_lr_schedule(cfg)(count))
    g = guard_state(opt_state)
    assert (optimizer.guard is None) == (g is None)
    if g is not None:
        assert optimizer.guard.state(0)["count"] == int(g.count) == 2 * K
        assert optimizer.guard.state(0)["skips"] == int(g.skips)
        np.testing.assert_allclose(optimizer.guard.state(0)["ema"], float(g.ema), rtol=1e-6)


# ------------------------------------------------------------------ codec

def jax_trees(guard):
    cfg = bridge_configs(guard)
    side = JaxSide(cfg)
    params, opt_state = side.run(side.template, side.tx.init(side.template), range(2))
    np_tree = lambda t: flax.serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return {"params": np_tree(params), "optimizer": np_tree(opt_state),
            "checkpoint": {"iteration_num": 2, "model_state_dict": np_tree(params),
                           "optimizer_state_dict": np_tree(opt_state)}}


@pytest.fixture(scope="module")
def trees():
    return jax_trees(guard=True)


@pytest.mark.parametrize("which", ["params", "optimizer", "checkpoint"])
def test_msgpack_writer_gives_flax_bytes(trees, which):
    want = flax.serialization.msgpack_serialize(trees[which])
    assert jax_ckpt.packb(trees[which]) == want
    restored = jax_ckpt.unpackb(want)
    flat_a, tree_a = jax.tree_util.tree_flatten(restored)
    flat_b, tree_b = jax.tree_util.tree_flatten(flax.serialization.msgpack_restore(want))
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def test_msgpack_scalars_and_unknown_forms():
    tree = {"f": 0.1, "i": [0, 127, 128, -32, -33, 70000, -70000, 2 ** 40], "n": None, "b": [True, False],
            "s": "x" * 40, "g": np.float32(2.5), "e": np.zeros((0, 3), np.int32), "by": b"\x00\x01"}
    assert jax_ckpt.packb(tree) == flax.serialization.msgpack_serialize(tree)
    chunked = flax.serialization.msgpack_serialize({"a": {"__msgpack_chunked_array__": True}})
    with pytest.raises(jax_ckpt.MsgpackError, match="chunked"):
        jax_ckpt.unpackb(chunked)
    with pytest.raises(jax_ckpt.MsgpackError, match="ext type 2"):
        jax_ckpt.unpackb(flax.serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(jax_ckpt.MsgpackError):
        jax_ckpt.packb({"o": object()})


# ---------------------------------------------------------------- bridges

@pytest.mark.parametrize("guard", [False, True], ids=["adam", "adam_clip_guard"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, guard):
    cfg = bridge_configs(guard, clip=guard)
    side = JaxSide(cfg)
    params, opt_state = side.run(side.template, side.tx.init(side.template), range(K))
    ckpt = j_ckpt.save_checkpoint(tmp_path / "saved_models", K, params, opt_state)

    tar = jax_ckpt.import_checkpoint(ckpt, cfg)
    assert tar == tmp_path / "saved_models/Model_Iter000003.tar"
    assert os.readlink(tmp_path / "saved_models/Model_Latest.tar") == tar.name
    model = t_vn.ViPNeRF(cfg)
    optimizer = make_optimizer(cfg, model.parameters())
    assert checkpoints.load_checkpoint(tar, model, optimizer) == K
    port_run(cfg, model, optimizer, range(K, 2 * K))

    it, params, opt_state = side.load(ckpt)
    assert it == K
    params, opt_state = side.run(params, opt_state, range(K, 2 * K))
    assert_same_run(cfg, model, optimizer, params, opt_state)


@pytest.mark.parametrize("guard", [False, True], ids=["adam", "adam_clip_guard"])
def test_port_checkpoint_resumes_in_jax(tmp_path, guard):
    cfg = bridge_configs(guard, clip=guard)
    side = JaxSide(cfg)
    model = t_vn.ViPNeRF(cfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, side.template)))
    optimizer = make_optimizer(cfg, model.parameters())
    port_run(cfg, model, optimizer, range(K))
    tar = checkpoints.save_checkpoint(tmp_path / "saved_models", K, model, optimizer)

    ckpt = jax_ckpt.export_checkpoint(tar, cfg)
    assert os.readlink(tmp_path / "saved_models/Model_Latest.ckpt") == ckpt.name
    it, params, opt_state = side.load(ckpt)
    assert it == K and int(adam_state(opt_state).count) == K
    params, opt_state = side.run(params, opt_state, range(K, 2 * K))
    port_run(cfg, model, optimizer, range(K, 2 * K))
    assert_same_run(cfg, model, optimizer, params, opt_state)

    # .tar -> .ckpt -> .tar is bit for bit: weights, moments, count, LR, guard
    back = jax_ckpt.import_checkpoint(ckpt, cfg, tmp_path / "back")
    a, b = (torch.load(p, weights_only=True) for p in (tar, back))
    assert a["iteration_num"] == b["iteration_num"] == K
    assert a["model_state_dict"].keys() == b["model_state_dict"].keys()
    for k in a["model_state_dict"]:
        assert torch.equal(a["model_state_dict"][k], b["model_state_dict"][k]), k
    sa, sb = a["optimizer_state_dict"], b["optimizer_state_dict"]
    assert sa["param_groups"] == sb["param_groups"] and sa.get("loss_guard") == sb.get("loss_guard")
    for i, entry in sa["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(entry[key], sb["state"][i][key]), (i, key)


def test_runs_keep_model_latest_and_mismatched_configs_raise(tmp_path):
    cfg = bridge_configs(guard=False)
    side = JaxSide(cfg)
    saved = tmp_path / "saved_models"
    params, opt_state = side.template, side.tx.init(side.template)
    for it in (1, 2):
        params, opt_state = side.run(params, opt_state, [it])
        j_ckpt.save_checkpoint(saved, it, params, opt_state)
    (tmp_path / "Configs.json").write_text(__import__("json").dumps(cfg))
    written = jax_ckpt.import_run(saved)  # configs found above the directory
    assert [p.name for p in written] == ["Model_Iter000001.tar", "Model_Iter000002.tar"]
    assert os.readlink(saved / "Model_Latest.tar") == "Model_Iter000002.tar"
    out = tmp_path / "exported"
    jax_ckpt.export_run(saved, cfg, out)
    assert os.readlink(out / "Model_Latest.ckpt") == "Model_Iter000002.ckpt"
    jax_ckpt.export_run(saved / "Model_Iter000001.tar", cfg, out)  # an older one: Latest stays
    assert os.readlink(out / "Model_Latest.ckpt") == "Model_Iter000002.ckpt"

    guarded = bridge_configs(guard=True)
    with pytest.raises(ValueError, match="optimizer state does not match"):
        jax_ckpt.import_checkpoint(saved / "Model_Iter000002.ckpt", guarded, tmp_path / "x")
    wider = copy.deepcopy(cfg)
    wider["model"]["fine_mlp"]["netwidth"] = 64
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_ckpt.import_checkpoint(saved / "Model_Iter000002.ckpt", wider, tmp_path / "x")
    jax_ckpt.main([str(saved / "Model_Iter000002.tar"), "--to_jax", "--output_dir", str(tmp_path / "cli")])
    assert (tmp_path / "cli/Model_Iter000002.ckpt").read_bytes() == (out / "Model_Iter000002.ckpt").read_bytes()


# ---------------------------------------------------------------- repairs

def test_dataparallel_model_loads_the_port_tar_strictly(tmp_path):
    cfg = bridge_configs(guard=False)
    model = t_vn.ViPNeRF(cfg, torch.Generator().manual_seed(3))
    path = checkpoints.save_checkpoint(tmp_path, 5, model)
    state = torch.load(path, weights_only=True)
    wrapped = torch.nn.DataParallel(t_vn.ViPNeRF(cfg))
    wrapped.load_state_dict(state["model_state_dict"], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(wrapped.module.state_dict()[k], v)


def forge_reference_tar(path, cfg, variant):
    """A reference-style .tar: torch.optim.Adam over the port's module, with
    entry 0 one step behind the others (its first gradient was None)."""
    model = t_vn.ViPNeRF(cfg, torch.Generator().manual_seed(1))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    rng = np.random.default_rng(0)
    params = list(model.parameters())
    for step in range(3):
        for i, p in enumerate(params):
            p.grad = None if (step == 0 and i == 0) else torch.from_numpy(
                rng.normal(size=tuple(p.shape)).astype(np.float32))
        opt.step()
    sd = opt.state_dict()
    if variant == "string_indices":
        sd["state"] = {str(k): v for k, v in sd["state"].items()}
    elif variant == "missing_index":
        del sd["state"][3]
    elif variant == "empty_state":
        sd["state"] = {}
    torch.save({"iteration_num": 7, "model_state_dict": {f"module.{k}": v for k, v in model.state_dict().items()},
                "optimizer_state_dict": sd}, path)
    return model


@pytest.mark.parametrize("variant", ["string_indices", "missing_index", "empty_state", "counts_differ"])
def test_reference_adam_state_loads_as_the_jax_migration(tmp_path, variant):
    cfg = bridge_configs(guard=False, clip=False)
    tar = tmp_path / "Model_Iter000007.tar"
    forge_reference_tar(tar, cfg, variant)

    model = t_vn.ViPNeRF(cfg)
    optimizer = make_optimizer(cfg, model.parameters())
    assert checkpoints.load_checkpoint(tar, model, optimizer) == 7

    ckpt = reference_ckpt.convert_checkpoint(tar, cfg, tmp_path / "jax")
    _, params, opt_state = JaxSide(cfg).load(ckpt)
    adam = adam_state(opt_state)
    count = int(adam.count)
    assert count == {"empty_state": 7}.get(variant, 3)  # the largest step, not entry 0's 2
    assert int(optimizer.count[0]) == count
    assert optimizer.state_dict()["param_groups"][0]["lr"] == float(get_lr_schedule(cfg)(count))
    port = optimizer.state_dict()["state"]
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
        for i, key in enumerate(model.state_dict()):
            assert torch.equal(port[i][name], want[key]), (name, key)
    if variant == "missing_index":
        assert not port[3]["exp_avg"].any()

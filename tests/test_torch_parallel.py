"""The port's data parallelism over devices (vipnerf_tpu_torch/parallel/)
on the CPU: two gloo ranks, spawned once for the module by the port's own
launcher (`run_on_devices` with device ["cpu", "cpu"]), run every sharded
path of tests/torch_parallel_ranks.py; each test holds one path against
the JAX package's 2-device mesh or against the port's one process.

Tolerances, the JAX package's own for its mesh (tests/test_parallel.py):
TotalLoss within rtol 1e-5 per step, parameters within atol 2e-6 / rtol
1e-5 after 10 steps (sharding changes only the order of the sums). The two
ranks' parameters are bit for bit equal: the reduced gradient is the same
on both, and so is each Adam update. Renders: each rank renders whole rays,
so outputs are compared exactly (the gather adds zeros only); losses merged
over tiles within rtol 1e-6. Gradients on the unequal-mask batch within
rtol 1e-5 / atol 1e-8 of one process's.

Everything runs one intra-op thread: a sum split over more threads rounds
differently.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.test_torch_losses import narrow_configs, step_batch
from tests.test_torch_multi_scene import SCENES, configs_for
from tests.test_train_step import make_cache, make_gather, small_configs
from vipnerf_tpu.losses import LossComputer as JLossComputer
from vipnerf_tpu.models import get_model as j_get_model
from vipnerf_tpu.models import vip_nerf as j_vn
from vipnerf_tpu.parallel.mesh import make_mesh, ray_sharding, replicate
from vipnerf_tpu.train.step import make_optimizer as j_make_optimizer
from vipnerf_tpu.train.step import make_scan_train_nosd, make_train_step as j_make_train_step
from vipnerf_tpu_torch.data.synthetic import SphereScene, write_synthetic_database
from vipnerf_tpu_torch.parallel.mesh import ray_shard, run_on_devices, select_devices
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.train.multi_scene import scene_devices, start_training_batched
from vipnerf_tpu_torch.train.trainer import start_training
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params
from vipnerf_tpu_torch.utils.io import read_image

ROOT = Path(__file__).resolve().parent.parent
TWO = ["cpu", "cpu"]
K, B = 10, 64  # steps, rays per step of the step runs (tests/test_parallel.py's index stream, 10 rows)
RENDER_N = 301  # not a multiple of the world size
RENDER_CHUNKS = (64, RENDER_N)


def jax_mesh_run(configs, params, idx):
    """tests/test_parallel.py's run on a mesh of 2 virtual CPU devices: after
    K steps from `params`, the parameters and TotalLoss."""
    _, render_fn = j_get_model(configs)
    tx = j_make_optimizer(configs)
    step = j_make_train_step(configs, render_fn, JLossComputer(configs), tx)
    scan = make_scan_train_nosd(configs, make_gather(make_cache()), step, donate=False)
    mesh = make_mesh(jax.devices()[:2])
    rep = replicate(mesh)
    final, _, scalars = scan(jax.device_put(params, rep), jax.device_put(tx.init(params), rep),
                             jax.random.PRNGKey(3), 0, jax.device_put(idx, ray_sharding(mesh, axis=1)))
    return final, np.asarray(scalars["TotalLoss"])


def numpy_state(params):
    return {k: v.numpy() for k, v in state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)).items()}


def render_batch(n=RENDER_N, nf=3, seed=0):
    """tests/test_parallel.py's render batch, with the fields losses read."""
    rng = np.random.default_rng(seed)
    rays_d = (rng.normal(size=(n, 3)) - [0, 0, 3.0]).astype(np.float32)
    return {
        "rays_o": rng.normal(size=(n, 3)).astype(np.float32), "rays_d": rays_d,
        "view_dirs": rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True),
        "near": np.full((n, 1), 1.0, np.float32), "far": np.full((n, 1), 4.0, np.float32),
        "rays_o2": rng.normal(size=(n, nf - 1, 3)).astype(np.float32),
        "target_rgb": np.random.default_rng(9).uniform(size=(n, 3)).astype(np.float32),
        "indices_mask_nerf": np.ones(n, bool), "num_frames": nf, "iter_num": 0,
    }


def masks_batch():
    """A batch whose sparse-depth rays and valid rays all lie in rank 0's
    half: per-rank means differ from the batch's."""
    b = step_batch(3, nr=32)
    sd = np.arange(32) < 6
    b.update(indices_mask_sparse_depth=sd, indices_mask_nerf=~sd, ray_valid=np.arange(32) < 10)
    return b


def run_configs(root, **extra):
    """Single-scene training of the two-scene database's first scene with a
    fine level and the perturbation on (the ranks draw the step's randoms)."""
    cfg = configs_for(root, scene_names=["synth01"], **extra)
    cfg["model"]["perturb"] = True
    cfg["model"]["fine_mlp"] = dict(cfg["model"]["coarse_mlp"])
    return cfg


SUB = 48  # of 128 + 64 rays per scene


def train_runs(root):
    return [
        run_configs(root, train_num=1, num_iterations=6, resume_training=False),
        run_configs(root, train_num=1, num_iterations=9),  # resumed from 6
        run_configs(root, train_num=2, num_iterations=6,  # 127 + 63 rays: replicated on both ranks
                    data_loader=dict(configs_for(root)["data_loader"], scene_names=["synth01"], num_rays=127,
                                     sparse_depth={"dirname": "DE02", "num_rays": 63})),
    ]


def batched_runs(root):
    return [configs_for(root, train_num=3, num_iterations=6),
            configs_for(root, train_num=5, num_iterations=6, sub_batch_size=SUB)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both sides of every comparison: the ranks' results (one spawn of two
    CPU ranks, in a thread that waits for them) and, meanwhile, the
    references (the JAX mesh, the port's one process). One intra-op thread
    everywhere: a sum split over more threads rounds differently, and the
    replicated run is compared bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("parallel")
    one, two = base / "one", base / "two"
    for i, name in enumerate(SCENES):
        write_synthetic_database(one / "data/databases", scene_name=name, num_frames=6, train_frames=(0, 5),
                                 val_frames=(2,), height=24, width=32, scene=SphereScene(seed=10 + i))
    shutil.copytree(one, two)

    idx = np.random.default_rng(1).integers(0, 512, (K, B)).astype(np.int32)
    cache = {k: np.asarray(v) for k, v in make_cache().items()}
    det = small_configs(model=dict(small_configs()["model"], perturb=False))
    j_params = j_get_model(det)[0](jax.random.PRNGKey(0), det)
    state = numpy_state(j_params)
    ncfg = narrow_configs()
    nstate = numpy_state(j_vn.init_params(jax.random.PRNGKey(1), ncfg))
    det_sub = dict(det, sub_batch_size=B // 4)
    steps = {"steps_det": (det, state, cache, idx), "steps_perturb": (small_configs(), state, cache, idx),
             "steps_sub": (small_configs(sub_batch_size=B // 4), state, cache, idx),
             "steps_sub_det": (det_sub, state, cache, idx),
             # 40 NeRF rays then 24 of a second stream, in sub-batches of 16: the third holds 8 and 8
             "steps_sub_streams": (small_configs(sub_batch_size=B // 4), state, cache, idx, [40, 24])}
    cfg = {"device": TWO, "workdir": str(base), "steps": steps, "masks": (ncfg, nstate, masks_batch()),
           "render": (small_configs(), state, render_batch()), "render_chunks": RENDER_CHUNKS,
           "train_runs": train_runs(two), "batched_runs": batched_runs(two)}
    session = threading.Thread(target=run_on_devices, args=(ranks.session, cfg))
    session.start()

    jax_runs = {"steps_det": jax_mesh_run(det, j_params, idx), "steps_sub_det": jax_mesh_run(det_sub, j_params, idx)}
    refs = {name: ranks.run_steps(*args) for name, args in steps.items()}
    refs["masks"] = ranks.run_loss_grads(*cfg["masks"])
    for chunk in RENDER_CHUNKS:
        for with_losses in (False, True):
            refs[f"render_{chunk}_{with_losses}"] = ranks.run_render(*cfg["render"], chunk, with_losses)
    for run in train_runs(one):
        start_training(run)
    for run in batched_runs(one):
        start_training_batched(run)
    session.join(timeout=600)
    assert not session.is_alive()
    torch.set_num_threads(threads)
    return {"base": base, "one": one, "two": two, "refs": refs, "jax": jax_runs, "cfg": cfg}


def ranks_result(world, name):
    return [ranks.load(world["base"], name, r) for r in (0, 1)]


def assert_params_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("name", ["steps_det", "steps_sub_det"])
def test_two_ranks_match_the_jax_mesh_of_two_devices(world, name):
    """perturb off, sigma noise 0: the two ranks against the JAX package's
    2-device mesh after 10 steps from the same weights, with and without
    sub-batches of B/4 rays (the mesh's are global: each rank takes its half
    of each)."""
    j_final, j_loss = world["jax"][name]
    for loss, params in ranks_result(world, name):
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
        assert_params_close(params, numpy_state(j_final), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["steps_det", "steps_perturb", "steps_sub", "steps_sub_det", "steps_sub_streams"])
def test_two_ranks_match_one_process_and_each_other(world, name):
    """With the perturbation on, each rank draws the whole (sub-)batch's
    randoms and keeps its rows (`ShardGenerator`), so two ranks still
    compute what one process does. At the same `sub_batch_size` (B/4) each
    rank takes half of each stream's piece of each global sub-batch: the
    ranks' i-th sub-batches together are one process's i-th sub-batch, with
    its randoms and its masked means (steps_sub_streams: a sub-batch that
    holds NeRF rays and rays that MSE01 leaves out)."""
    (l0, p0), (l1, p1) = ranks_result(world, name)
    ref_loss, ref_params = world["refs"][name]
    np.testing.assert_array_equal(l0, l1)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    np.testing.assert_allclose(l0, ref_loss, rtol=1e-5)
    assert_params_close(p0, ref_params, atol=2e-6, rtol=1e-5)


def test_masked_means_are_global_over_the_ranks(world):
    """Sparse-depth and valid rays all on rank 0: every loss and gradient of
    the two ranks equals one process's on the whole batch, while a mean of
    the per-rank means (what averaging gradients over ranks computes) is far
    off."""
    ref_scalars, ref_grads = world["refs"]["masks"]
    for scalars, grads in ranks_result(world, "masks"):
        assert set(scalars) == set(ref_scalars)
        for k, v in ref_scalars.items():
            np.testing.assert_allclose(scalars[k], v, rtol=1e-5, err_msg=k)
        assert_params_close(grads, ref_grads, rtol=1e-5, atol=1e-8)
    ncfg, nstate, batch = world["cfg"]["masks"]
    halves = [ranks.run_loss_grads(ncfg, nstate, {k: v[s] if isinstance(v, np.ndarray) and v.shape[:1] == (32,)
                                                  else v for k, v in batch.items()})[0]
              for s in (slice(0, 16), slice(16, 32))]
    for name in ("SparseDepthMSE01", "VisibilityLoss01"):
        per_rank_mean = 0.5 * (halves[0][name] + halves[1][name])
        assert abs(per_rank_mean - ref_scalars[name]) > 0.1 * abs(ref_scalars[name]), name


@pytest.mark.parametrize("with_losses", [False, True])
@pytest.mark.parametrize("chunk", RENDER_CHUNKS)
def test_sharded_tile_render_matches_one_rank(world, chunk, with_losses):
    """301 rays, tiles of 64 or the whole batch (rounded down to 300 for two
    ranks, then padded): the outputs of both ranks equal one rank's, and so
    do the merged losses and their maps."""
    ref_out, ref_losses = world["refs"][f"render_{chunk}_{with_losses}"]
    for out, losses in ranks_result(world, f"render_{chunk}_{with_losses}"):
        assert set(out) == set(ref_out)
        for k in ref_out:
            np.testing.assert_array_equal(out[k], ref_out[k], err_msg=k)
        assert (losses is None) == (not with_losses)
        for name, val in (ref_losses or {}).items():
            got = losses[name]
            if not isinstance(val, dict):
                np.testing.assert_allclose(got, val, rtol=1e-6, err_msg=name)
                continue
            np.testing.assert_allclose(got["loss_value"], val["loss_value"], rtol=1e-6, err_msg=name)
            for mk, mv in val.get("loss_maps", {}).items():
                np.testing.assert_array_equal(got["loss_maps"][mk], mv, err_msg=mk)


def tree_files(run: Path):
    """Relative paths of a run tree, TensorBoard's event files (named after
    the host, the clock and the process) by their directory only."""
    return sorted(str(p.relative_to(run)) if "tfevents" not in p.name else f"{p.parent.relative_to(run)}/tfevents"
                  for p in run.rglob("*") if p.is_file())


def scalars_of(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def assert_same_tree(one: Path, two: Path, exact_params: bool = False):
    """The same files: configs equal but for the device, scalars and
    checkpoints within the step tolerances (the training's bit for bit where
    the ranks replicate the batch: validation renders are sharded even then,
    and a product over half a tile's rays may round apart), images within
    one grey level."""
    assert tree_files(one) == tree_files(two)
    for a in sorted(p for p in one.rglob("*") if p.is_file() and "tfevents" not in p.name and not p.is_symlink()):
        b = two / a.relative_to(one)
        if a.name == "Configs.json":
            ja, jb = (json.loads(x.read_text()) for x in (a, b))
            assert ja.pop("device") == "cpu" and jb.pop("device") == TWO
            assert ja == jb
        elif a.suffix == ".json":
            assert json.loads(a.read_text()) == json.loads(b.read_text()), a
        elif a.suffix == ".jsonl":
            ra, rb = scalars_of(a), scalars_of(b)
            assert [(r["tag"], r["step"]) for r in ra] == [(r["tag"], r["step"]) for r in rb]
            for x, y in zip(ra, rb):
                exact = exact_params and x["tag"].startswith("train/")
                np.testing.assert_allclose(y["value"], x["value"], rtol=0 if exact else 1e-5,
                                           atol=0 if exact else 1e-7, err_msg=f"{a} {x['tag']} {x['step']}")
        elif a.suffix == ".tar":
            sa, sb = (torch.load(x, weights_only=True) for x in (a, b))
            for k, v in sa["model_state_dict"].items():
                tol = dict(rtol=0, atol=0) if exact_params else dict(atol=2e-6, rtol=1e-5)
                np.testing.assert_allclose(sb["model_state_dict"][k].numpy(), v.numpy(), err_msg=f"{a} {k}", **tol)
            assert sa["optimizer_state_dict"]["state"][0]["step"] == sb["optimizer_state_dict"]["state"][0]["step"]
        elif a.suffix == ".png":
            diff = np.abs(read_image(a).astype(int) - read_image(b).astype(int))
            assert diff.max() <= 1, a


def test_two_rank_run_tree_equals_the_one_rank_tree_and_resumes(world):
    """start_training over two CPU ranks, 6 steps then resumed to 9: rank 0
    wrote the same files as one rank, with both scalars at every step."""
    run = "runs/training/train0001"
    assert_same_tree(world["one"] / run, world["two"] / run)
    steps = [r["step"] for r in scalars_of(world["two"] / run / "synth01/logs/scalars.jsonl")
             if r["tag"] == "train/TotalLoss"]
    assert steps == list(range(1, 10))
    assert checkpoints.checkpoint_iteration(
        checkpoints.latest_checkpoint(world["two"] / run / "synth01/saved_models")) == 9


def test_a_batch_that_does_not_divide_is_replicated(world):
    """127 + 63 rays on two ranks: every rank computes the whole batch with
    no collective, so the training is the one-rank training bit for bit."""
    run = "runs/training/train0002"
    assert_same_tree(world["one"] / run, world["two"] / run, exact_params=True)


@pytest.mark.parametrize("train_num", [3, 5])
def test_batched_scenes_over_two_ranks_equal_one_process(world, train_num):
    """batch_scenes' trainer, S = 2 over two ranks (one scene each, the
    losses gathered for rank 0's logs and the weights for its checkpoints and
    validation) against S = 2 in one process; train0005 in sub-batches of 48
    rays per scene (each rank draws its scene's rows of every sub-batch)."""
    run = f"runs/training/train{train_num:04}"
    assert_same_tree(world["one"] / run, world["two"] / run)


class FakeRank:
    def __init__(self, rank, world):
        self.rank, self.world, self.device = rank, world, torch.device("cpu")


@pytest.mark.parametrize("sub", [None, 48, 64])
def test_ray_shard_splits_each_global_sub_batch(sub):
    """Over two ranks, 128 + 64 rays: the ranks' rows of each global
    sub-batch are its halves by stream, their columns of each stream are
    the stream's, disjoint, and a rank's local sub-batches are its rows of
    the global ones, in order."""
    streams, total = [128, 64], 192
    shards = [ray_shard(FakeRank(r, 2), streams, sub) for r in (0, 1)]
    size = sub or total
    for i in range(total // size):
        rows = [s.draws[i][0].numpy() for s in shards]
        assert all(s.draws[i][1] == size for s in shards)
        assert sorted(np.concatenate(rows).tolist()) == list(range(size))
    for k, n in enumerate(streams):
        cols = [s.columns[k] for s in shards]
        assert sorted(np.concatenate(cols).tolist()) == list(range(n))
    for r, s in enumerate(shards):
        batch_pos = np.concatenate([s.columns[0], 128 + s.columns[1]])  # this rank's batch, in global positions
        assert list(batch_pos) == sorted(batch_pos)
        local = total // 2 if sub is None else s.sub_batch_size
        assert local == size // 2
        for i in range(total // size):
            np.testing.assert_array_equal(batch_pos[i * local:(i + 1) * local], i * size + s.draws[i][0].numpy())
    assert ray_shard(FakeRank(0, 2), [127, 63]) is None
    assert ray_shard(FakeRank(0, 2), [128, 64], 24) is not None
    assert ray_shard(FakeRank(0, 32), streams, 48) is None  # the third sub-batch's 16 sparse-depth rays
    with pytest.raises(ValueError, match="does not divide"):
        ray_shard(FakeRank(0, 2), streams, 50)


def test_the_ranks_inputs_are_the_jax_tests():
    """The JAX-free copies that the card's test of two ranks runs."""
    assert ranks.step_configs() == small_configs()
    for k, v in make_cache().items():
        np.testing.assert_array_equal(ranks.step_cache()[k], np.asarray(v), err_msg=k)


def test_scene_devices_take_the_first_s_and_must_divide():
    assert scene_devices(["cpu"] * 3, 2) == ["cpu", "cpu"]
    assert scene_devices("cpu", 3) == "cpu"
    assert scene_devices(TWO, 4) == TWO
    with pytest.raises(ValueError, match="must divide"):
        scene_devices(TWO, 3)
    assert select_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="mixed"):
        select_devices(["cpu", 0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_torchrun_style_group_is_joined(world, tmp_path):
    """Two processes started as torchrun starts them (the rendezvous in
    their environment): `run_on_devices` joins their group, and the steps
    match one process's."""
    import pickle

    job = tmp_path / "job.pkl"
    det = world["cfg"]["steps"]["steps_det"]
    job.write_bytes(pickle.dumps({"device": TWO, "workdir": str(tmp_path), "steps": det}))
    port = str(_free_port())
    procs = []
    for rank in (0, 1):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen([sys.executable, str(ROOT / "tests/torch_parallel_ranks.py"), str(job)],
                                      env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ref_loss, ref_params = world["refs"]["steps_det"]
    for rank in (0, 1):
        loss, params = ranks.load(tmp_path, "joined", rank)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        assert_params_close(params, ref_params, atol=2e-6, rtol=1e-5)

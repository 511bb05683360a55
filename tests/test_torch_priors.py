"""The port's prior generators against the JAX package: the plane-sweep
visibility prior (sampler, weights, the CLI end to end on LLFF with three
train views and on DTU, skip-if-exists and strict resume), the COLMAP model
readers and the sparse-depth tables.

The port runs on the CPU. Tolerances: visibility weights 1e-5 absolute
(the port writes the warp's 3x3 transforms as f32 fused multiply-adds in
the order of XLA's CPU matmuls and its inverses as LAPACK's f32 LU solve,
so most weights agree bit for bit); masks equal wherever |w - 0.5| >= 1e-5;
sparse depths 1e-6.
"""

import json
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
from vipnerf_tpu.data.synthetic import make_camera_ring as j_make_camera_ring
from vipnerf_tpu.data.synthetic import write_synthetic_database as j_write_database
from vipnerf_tpu.priors import colmap_io as j_colmap_io
from vipnerf_tpu.priors import sparse_depth as j_sparse_depth
from vipnerf_tpu.priors import visibility as j_vis
from vipnerf_tpu.priors.cli import main_sparse_depth as j_main_sparse_depth
from vipnerf_tpu.priors.cli import main_visibility as j_main_visibility
from vipnerf_tpu_torch.data.synthetic import make_dtu_scene, write_synthetic_database
from vipnerf_tpu_torch.priors import colmap_io, sparse_depth
from vipnerf_tpu_torch.priors import visibility as vis
from vipnerf_tpu_torch.priors.cli import build_visibility_configs, main_sparse_depth, main_visibility
from vipnerf_tpu_torch.utils.io import read_csv_columns, read_image, read_mask

H, W = 24, 32
TOL_W = 1e-5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: idle ones spin on the cores of other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def intrinsic(h=H, w=W):
    f = 0.9 * w
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def frames(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (H, W, 3)).astype(np.float32) for _ in range(2)]


def jax_weights(f1, f2, e1, e2, k1, k2, planes, temperature=10.0):
    return np.asarray(j_vis.compute_visibility_weights(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(e1), jnp.asarray(e2), jnp.asarray(k1),
        jnp.asarray(k2), jnp.asarray(planes, jnp.float32), temperature))


def port_weights(f1, f2, e1, e2, k1, k2, planes, temperature=10.0, **kw):
    return vis.compute_visibility_weights(
        torch.from_numpy(f1), torch.from_numpy(f2), e1, e2, k1, k2,
        torch.as_tensor(planes, dtype=torch.float32), temperature, **kw).numpy()


# --------------------------------------------------------------- sampler

def test_depth_planes_match_jax():
    for linear in (False, True):
        np.testing.assert_array_equal(vis.get_depth_planes(0.7, 9.0, 16, linear),
                                      j_vis.get_depth_planes(0.7, 9.0, 16, linear))


def test_bilinear_sampler_corners_match_jax():
    """Integer coordinates (every corner weighs 1, normalised by the mask),
    the pad border (-1 and w / h), beyond it (clipped), and fractions."""
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    xs = np.array([0, 1, W - 1, -1, W, -1.5, W + 0.5, -7, W + 9, 3.25, 0.5, W - 0.5], np.float32)
    ys = np.array([0, H - 1, 2, -1, H, H + 0.25, -0.75, H + 5, -9, 7.5, -0.5, H - 0.5], np.float32)
    xx, yy = np.meshgrid(xs, ys, indexing="xy")
    coords = np.stack([xx, yy], -1)  # (12, 12, 2)
    coords = np.tile(coords, (2, 3, 1))[:H, :W]
    ref = np.asarray(j_vis._bilinear_sample_masked(jnp.asarray(frame), jnp.asarray(coords)))
    out = vis._bilinear_sample_masked(torch.from_numpy(frame), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL_W, rtol=0)
    assert (ref == 0).any() and (ref > 0).any()  # both in-view and out-of-view samples
    np.testing.assert_allclose(out[0, 0], frame[0, 0], rtol=1e-6)  # (0, 0): itself


@pytest.mark.parametrize("linear", [False, True], ids=["inverse", "linear"])
def test_compute_visibility_weights_match_jax(linear):
    """16 planes; the second camera turned away so that part of frame 1 warps
    out of frame 2."""
    f1, f2 = frames(1)
    ring = j_make_camera_ring(2, spread_deg=70.0)
    e1, e2 = ring[0].astype(np.float32), ring[1].astype(np.float32)
    k = intrinsic()
    planes = j_vis.get_depth_planes(1.5, 9.0, 16, linear)
    ref = jax_weights(f1, f2, e1, e2, k, k, planes)
    for per_step in (1, 8, 16):  # a one-plane scan, and planes in groups
        out = port_weights(f1, f2, e1, e2, k, k, planes, planes_per_step=per_step)
        np.testing.assert_allclose(out, ref, atol=TOL_W, rtol=0, err_msg=f"planes_per_step {per_step}")
    # part of frame 1 warps outside frame 2 and its padding
    k1_inv, t21 = vis._pose_chain(e1, e2, k)
    coords = vis._warp_coords_for_plane(torch.tensor(float(planes[0])), k1_inv, k, t21, H, W,
                                        torch.device("cpu")).numpy()
    outside = (coords[..., 0] < -1) | (coords[..., 0] > W) | (coords[..., 1] < -1) | (coords[..., 1] > H)
    assert outside.any() and not outside.all()


# --------------------------------------------------------------- generation

def llff_roots(tmp_path_factory):
    """One synthetic LLFF database (3 train views, _down4 frames, no priors)
    copied for each package."""
    src = tmp_path_factory.mktemp("llff_src")
    j_write_database(src / "data/databases", scene_name="synth01", num_frames=6, train_frames=(0, 2, 5),
                     val_frames=(1,), height=H, width=W, resolution_suffix="_down4",
                     with_visibility_prior=False, with_sparse_depth=False)
    roots = {}
    for name in ("jax", "torch"):
        roots[name] = tmp_path_factory.mktemp(f"llff_{name}")
        shutil.copytree(src / "data", roots[name] / "data")
    return roots


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Both CLIs on copies of one LLFF database and of one DTU database."""
    out = {}
    roots = llff_roots(tmp_path_factory)
    j_main_visibility(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(roots["jax"])])
    main_visibility(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(roots["torch"]),
                     "--device", "cpu"])
    out["NeRF_LLFF"] = {k: r / "data/databases/NeRF_LLFF/data/all/visibility_prior/VW02" for k, r in roots.items()}

    dtu_src = tmp_path_factory.mktemp("dtu_src")
    scene, ring = make_dtu_scene()
    write_synthetic_database(dtu_src / "data/databases", dataset="DTU", scene_name="00021", num_frames=4,
                             train_frames=(0, 3), val_frames=(1,), height=H, width=W, scene=scene,
                             with_visibility_prior=False, with_sparse_depth=False, **ring)
    dtu = {}
    for name in ("jax", "torch"):
        dtu[name] = tmp_path_factory.mktemp(f"dtu_{name}")
        shutil.copytree(dtu_src / "data", dtu[name] / "data")
    j_main_visibility(["--database", "DTU", "--gen_nums", "2", "--root_dirpath", str(dtu["jax"])])
    main_visibility(["--database", "DTU", "--gen_nums", "2", "--root_dirpath", str(dtu["torch"]),
                     "--device", "cpu"])
    out["DTU"] = {k: r / "data/databases/DTU/data/all/visibility_prior/VW02" for k, r in dtu.items()}
    out["roots"] = roots
    return out


@pytest.mark.parametrize("database,scene,pairs", [
    ("NeRF_LLFF", "synth01", [(0, 2), (0, 5), (2, 5)]),
    ("DTU", "00021", [(0, 3)]),
])
def test_generated_priors_match_jax(generated, database, scene, pairs):
    j_dir, t_dir = generated[database]["jax"], generated[database]["torch"]
    j_cfg = json.loads((j_dir / "Configs.json").read_text())
    t_cfg = json.loads((t_dir / "Configs.json").read_text())
    assert j_cfg.pop("generator") == "vipnerf_tpu.priors.visibility"
    assert t_cfg.pop("generator") == "vipnerf_tpu_torch.priors.visibility"
    assert t_cfg == j_cfg
    j_files = sorted(p.relative_to(j_dir) for p in j_dir.rglob("*") if p.is_file())
    assert j_files == sorted(p.relative_to(t_dir) for p in t_dir.rglob("*") if p.is_file())
    assert len(j_files) == 1 + 8 * len(pairs)  # both directions: mask and weights, .npy and .png
    for a, b in pairs:
        for f1, f2 in ((a, b), (b, a)):
            name = f"{f1:04}_{f2:04}"
            jw = np.load(j_dir / f"{scene}/visibility_weights/{name}.npy")
            tw = np.load(t_dir / f"{scene}/visibility_weights/{name}.npy")
            assert tw.dtype == jw.dtype == np.float32 and tw.shape == (H, W)
            np.testing.assert_allclose(tw, jw, atol=TOL_W, rtol=0, err_msg=name)
            tm = np.load(t_dir / f"{scene}/visibility_masks/{name}.npy")
            jm = np.load(j_dir / f"{scene}/visibility_masks/{name}.npy")
            assert tm.dtype == bool
            np.testing.assert_array_equal(tm, tw > 0.5)
            clear = np.abs(jw - 0.5) >= TOL_W
            np.testing.assert_array_equal(tm[clear], jm[clear], err_msg=name)
            np.testing.assert_array_equal(read_mask(t_dir / f"{scene}/visibility_masks/{name}.png"), tm)
            assert 0.05 < tw.mean() <= 1.0


def test_each_pair_uses_its_own_poses(generated):
    """With 3 train views the pair (2, 5) is warped through frames 2 and 5's
    poses; through frames 0 and 2's (the pair the reference used for every
    pair) it gives other weights."""
    root = generated["roots"]["torch"]
    base = root / "data/databases/NeRF_LLFF/data/all/database_data/synth01"
    extr = np.loadtxt(base / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4).astype(np.float32)
    intr = np.loadtxt(base / "CameraIntrinsics_down4.csv", delimiter=",").reshape(-1, 3, 3).astype(np.float32)
    bounds = np.loadtxt(base / "DepthBounds.csv", delimiter=",")[[0, 2, 5]]
    planes = vis.get_depth_planes(bounds.min(), bounds.max(), 64)
    f2, f5 = (read_image(base / f"rgb_down4/{f:04}.png")[..., :3].astype(np.float32) for f in (2, 5))
    saved = np.load(generated["NeRF_LLFF"]["torch"] / "synth01/visibility_weights/0002_0005.npy")
    own = port_weights(f2, f5, extr[2], extr[5], intr[2], intr[5], planes)
    first_two = port_weights(f2, f5, extr[0], extr[2], intr[0], intr[2], planes)
    np.testing.assert_array_equal(own, saved)
    assert np.abs(first_two - saved).max() > 0.1


def test_generation_skips_existing_pairs_and_resumes_strictly(generated, capsys):
    root = generated["roots"]["torch"]
    out = generated["NeRF_LLFF"]["torch"]
    weights = out / "synth01/visibility_weights/0000_0002.npy"
    before = weights.stat().st_mtime_ns
    capsys.readouterr()
    main_visibility(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(root), "--device", "cpu"])
    assert weights.stat().st_mtime_ns == before
    assert "pair" not in capsys.readouterr().out  # every pair skipped

    configs_path = out / "Configs.json"
    saved = configs_path.read_text()
    try:
        changed = json.loads(saved)
        changed["temperature"] = 5
        configs_path.write_text(json.dumps(changed))
        with pytest.raises(RuntimeError, match="Configs mismatch"):
            main_visibility(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(root),
                             "--device", "cpu"])
    finally:
        configs_path.write_text(saved)


def test_visibility_runs_as_a_module(tmp_path):
    """`python -m vipnerf_tpu_torch.priors.visibility` with the JAX CLI's
    flags (and --device cpu) writes the prior's layout."""
    write_synthetic_database(tmp_path / "data/databases", scene_name="synth01", num_frames=3, train_frames=(0, 2),
                             val_frames=(1,), height=12, width=16, resolution_suffix="_down4",
                             with_visibility_prior=False, with_sparse_depth=False)
    res = subprocess.run([sys.executable, "-m", "vipnerf_tpu_torch.priors.visibility", "--database", "NeRF_LLFF",
                          "--gen_nums", "2", "--root_dirpath", str(tmp_path), "--device", "cpu"],
                         capture_output=True, text=True, cwd=Path(__file__).resolve().parents[1], timeout=300)
    assert res.returncode == 0, res.stderr
    out = tmp_path / "data/databases/NeRF_LLFF/data/all/visibility_prior/VW02"
    assert sorted(p.relative_to(out).as_posix() for p in out.rglob("*.npy")) == [
        "synth01/visibility_masks/0000_0002.npy", "synth01/visibility_masks/0002_0000.npy",
        "synth01/visibility_weights/0000_0002.npy", "synth01/visibility_weights/0002_0000.npy"]
    assert "pair 0000<->0002" in res.stdout


@pytest.mark.parametrize("backfill", [False, True])
def test_save_gen_configs_matches_jax(tmp_path, backfill):
    """A key of the old file missing from the new configs is inherited; a
    key new to the code raises unless back-filled; a changed value raises."""
    old = {"gen_num": 2, "temperature": 10, "old_key": "x"}
    cases = [({"gen_num": 2, "temperature": 10}, None),
             ({"gen_num": 2, "temperature": 10, "new_key": 1}, None if backfill else RuntimeError),
             ({"gen_num": 2, "temperature": 11}, RuntimeError)]
    for i, (new, error) in enumerate(cases):
        results = []
        for name, fn in (("jax", j_vis.save_gen_configs), ("torch", vis.save_gen_configs)):
            d = tmp_path / f"{name}{i}"
            d.mkdir()
            (d / "Configs.json").write_text(json.dumps(old))
            if error:
                with pytest.raises(error):
                    fn(d, dict(new), backfill_new_keys=backfill)
            else:
                fn(d, dict(new), backfill_new_keys=backfill)
            results.append(json.loads((d / "Configs.json").read_text()))
        assert results[0] == results[1]


# ------------------------------------------------------------- sparse depth

def write_colmap_model(sparse_dir, num_images=3, num_points=40, seed=0):
    """A binary COLMAP model: `num_images` posed images that all observe
    `num_points` points in front of them (plus one feature with no point)."""
    rng = np.random.default_rng(seed)
    sparse_dir.mkdir(parents=True, exist_ok=True)
    point_ids = np.arange(100, 100 + num_points)
    with open(sparse_dir / "images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", num_images))
        for image_id in range(1, num_images + 1):
            q = np.array([1.0, *rng.normal(0, 0.05, 3)])
            q /= np.linalg.norm(q)
            t = rng.normal(0, 0.2, 3)
            fh.write(struct.pack("<idddddddi", image_id, *q, *t, 1))
            fh.write(f"{image_id - 1:04}.png".encode() + b"\x00")
            fh.write(struct.pack("<Q", num_points + 1))
            for pid in point_ids:
                fh.write(struct.pack("<ddq", *rng.uniform(0, [W, H]), int(pid)))
            fh.write(struct.pack("<ddq", 1.5, 2.5, -1))
    with open(sparse_dir / "points3D.bin", "wb") as fh:
        fh.write(struct.pack("<Q", num_points))
        for pid in point_ids:
            xyz = [*rng.uniform(-1, 1, 2), rng.uniform(2, 6)]
            fh.write(struct.pack("<QdddBBBd", int(pid), *xyz, 128, 128, 128, rng.uniform(0.1, 2.0)))
            fh.write(struct.pack("<Q", num_images))
            for image_id in range(1, num_images + 1):
                fh.write(struct.pack("<ii", image_id, 0))


def test_colmap_readers_match_jax(tmp_path):
    write_colmap_model(tmp_path)
    with open(tmp_path / "cameras.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 1, 640, 480))
        fh.write(struct.pack("<4d", 500.0, 500.0, 320.0, 240.0))
    for reader, filename in (("read_images_binary", "images.bin"), ("read_points3d_binary", "points3D.bin"),
                             ("read_cameras_binary", "cameras.bin")):
        ours = getattr(colmap_io, reader)(tmp_path / filename)
        ref = getattr(j_colmap_io, reader)(tmp_path / filename)
        assert list(ours) == list(ref) and ref
        for key in ref:
            assert vars(ours[key]).keys() == vars(ref[key]).keys()
            for field, value in vars(ref[key]).items():
                np.testing.assert_array_equal(np.asarray(getattr(ours[key], field)), np.asarray(value),
                                              err_msg=field)
    assert ours[1].model == "PINHOLE"
    rng = np.random.default_rng(5)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = colmap_io.qvec2rotmat(q)
        np.testing.assert_array_equal(r, j_colmap_io.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap_io.rotmat2qvec(r), j_colmap_io.rotmat2qvec(r))


def test_compute_colmap_depth_matches_jax(tmp_path):
    write_colmap_model(tmp_path / "sparse/0")
    t_depths, t_bounds = sparse_depth.ColmapTester(tmp_path).compute_colmap_depth()
    j_depths, j_bounds = j_sparse_depth.ColmapTester(tmp_path).compute_colmap_depth()
    assert len(t_depths) == len(j_depths) == 3
    for t, j in zip(t_depths, j_depths):
        assert list(t) == list(j.columns) == ["x", "y", "depth", "reprojection_error", "weight"]
        assert 0 < len(j) < 40  # the percentile bounds drop a few points
        for col in j.columns:
            np.testing.assert_allclose(t[col], j[col].to_numpy(), atol=1e-6, rtol=0, err_msg=col)
    for col in ("near", "far"):
        np.testing.assert_array_equal(t_bounds[col], j_bounds[col].to_numpy())


def test_sparse_depth_generation_writes_what_jax_writes(tmp_path, monkeypatch):
    """start_generation of both packages with COLMAP's run replaced by the
    model above: the CSVs parse, with pandas and with the port's reader, to
    the same numbers."""
    def fake_run(self, camera_data, extrinsics):
        write_colmap_model(self.sparse_dirpath, num_images=len(extrinsics))

    monkeypatch.setattr(sparse_depth.ColmapTester, "run_colmap", fake_run)
    monkeypatch.setattr(j_sparse_depth.ColmapTester, "run_colmap", fake_run)
    out = {}
    for name, main in (("jax", j_main_sparse_depth), ("torch", main_sparse_depth)):
        root = tmp_path / name
        j_write_database(root / "data/databases", scene_name="synth01", num_frames=6, train_frames=(0, 2, 5),
                         val_frames=(1,), height=H, width=W, resolution_suffix="_down4",
                         with_visibility_prior=False, with_sparse_depth=False)
        main(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(root)])
        out[name] = root / "data/databases/NeRF_LLFF/data/all/estimated_depths/DE02"
    rels = sorted(p.relative_to(out["jax"]) for p in out["jax"].rglob("*.csv"))
    assert [str(r) for r in rels] == ["synth01/EstimatedBounds.csv"] + [
        f"synth01/estimated_depths_down4/{f:04}.csv" for f in (0, 2, 5)]
    for rel in rels:
        j_table = pd.read_csv(out["jax"] / rel)
        t_table = pd.read_csv(out["torch"] / rel)
        pd.testing.assert_frame_equal(t_table, j_table, check_exact=False, atol=1e-6, rtol=0)
        ours = read_csv_columns(out["torch"] / rel)
        assert list(ours) == list(j_table.columns)
        for col in j_table.columns:
            np.testing.assert_allclose(ours[col], j_table[col].to_numpy(), atol=1e-6, rtol=0)
    t_cfg = json.loads((out["torch"] / "Configs.json").read_text())
    j_cfg = json.loads((out["jax"] / "Configs.json").read_text())
    assert t_cfg.pop("generator") == "vipnerf_tpu_torch.priors.sparse_depth"
    j_cfg.pop("generator")
    assert t_cfg == j_cfg


def test_sparse_depth_raises_without_colmap(tmp_path, monkeypatch):
    monkeypatch.setattr(sparse_depth.shutil, "which", lambda name: None)
    write_synthetic_database(tmp_path / "data/databases", scene_name="synth01", num_frames=4,
                             train_frames=(0, 3), val_frames=(1,), height=H, width=W,
                             resolution_suffix="_down4", with_visibility_prior=False, with_sparse_depth=False)
    with pytest.raises(sparse_depth.ColmapNotFoundError, match="COLMAP binary"):
        main_sparse_depth(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(tmp_path)])


def test_policies_match_jax():
    from vipnerf_tpu.priors import cli as j_cli
    from vipnerf_tpu_torch.priors import cli

    assert cli.DATASET_POLICIES == j_cli.DATASET_POLICIES
    for database in cli.DATASET_POLICIES:
        for build in ("build_visibility_configs", "build_sparse_depth_configs"):
            ours, ref = getattr(cli, build)(database, 3), getattr(j_cli, build)(database, 3)
            assert ours.pop("generator").startswith("vipnerf_tpu_torch.priors.")
            ref.pop("generator")
            assert ours == ref
    assert build_visibility_configs("DTU", 2)["num_depth_planes"] == 128

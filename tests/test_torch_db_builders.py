"""The port's database builders (vipnerf_tpu_torch/db_builders/) against the
JAX package's (vipnerf_tpu/db_builders/), each on its own copy of the same
seeded sources.

- NeRF-LLFF: a forged raw scene in the published layout (COLMAP model,
  poses_bounds.npy, image pyramids; PNG sources, since the JPEG path needs
  nvJPEG on the card and raises here), zipped and built by each package's
  CLI. The CSVs are equal as numbers (np.loadtxt) or as tables, the PNGs
  pixel for pixel, Configs.json once parsed; the spiral poses within 1e-12.
- DTU: `decompose_world_mat` against the JAX version (cv2's
  decomposeProjectionMatrix) on 50 seeded K, R, t, near-axis and exact-axis
  rotations among them, within 1e-9 of the values' scale; a forged rs_dtu_4
  archive and RegNeRF masks through both CLIs; the splits.
- RealEstate-10K: camera files, splits, the CLI, `select_scenes` with its
  shortfall case, and `extract_scene` on frames passed in (the JAX
  package's video decoder patched to return the same frames): equal where
  no resize happens, within 1 grey level where INTER_AREA halves the frames
  (the two round a tie apart); ffmpeg is absent here, and decoding a video
  raises FfmpegNotFoundError.
"""

import json
import shutil
import sys
import zipfile
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pandas as pd
import pytest

from tests.test_db_builders import REF_DATA
from vipnerf_tpu.db_builders import dtu as j_dtu
from vipnerf_tpu.db_builders import nerf_llff as j_llff
from vipnerf_tpu.db_builders import real_estate as j_re
from vipnerf_tpu_torch.data.synthetic import write_raw_llff_scene
from vipnerf_tpu_torch.db_builders import dtu as t_dtu
from vipnerf_tpu_torch.db_builders import nerf_llff as t_llff
from vipnerf_tpu_torch.db_builders import real_estate as t_re
from vipnerf_tpu_torch.utils.io import read_png

FIXTURE_JPEG = Path(__file__).resolve().parent / "data/synth_1008x756.jpg"


def run_jax_main(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["builder", *argv])
    main()


def assert_trees_equal(t_dir: Path, j_dir: Path, atol=0.0):
    """Every file of the JAX tree in the port's: CSVs as numbers (a header
    row as a table), PNGs as pixels, JSON parsed, the rest as bytes."""
    j_files = sorted(p.relative_to(j_dir) for p in j_dir.rglob("*") if p.is_file())
    assert j_files == sorted(p.relative_to(t_dir) for p in t_dir.rglob("*") if p.is_file())
    for rel in j_files:
        a, b = t_dir / rel, j_dir / rel
        if rel.suffix == ".png":
            np.testing.assert_array_equal(read_png(a), imageio.imread(b), str(rel))
        elif rel.suffix == ".json":
            assert json.loads(a.read_text()) == json.loads(b.read_text()), str(rel)
        elif rel.suffix == ".csv" and not b.read_text()[:1].isdigit() and b.read_text()[:1] != "-":
            pd.testing.assert_frame_equal(pd.read_csv(a), pd.read_csv(b), obj=str(rel))
        elif rel.suffix == ".csv":
            np.testing.assert_allclose(np.loadtxt(a, delimiter=","), np.loadtxt(b, delimiter=","),
                                       rtol=0, atol=atol, err_msg=str(rel))
        else:
            assert a.read_bytes() == b.read_bytes(), str(rel)


# ------------------------------------------------------------------ LLFF

@pytest.fixture(scope="module")
def llff_zip(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    for i, name in enumerate(("fern", "trex")):
        write_raw_llff_scene(root, scene_name=name, num_frames=10, height=24, width=32, seed=i)
    zip_path = root / "nerf_llff_data.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for p in sorted((root / "nerf_llff_data").rglob("*")):
            zf.write(p, p.relative_to(root))
    return zip_path


@pytest.fixture(scope="module")
def llff_dbs(llff_zip, tmp_path_factory):
    root = tmp_path_factory.mktemp("llff")
    argv = ["--zip_filepath", str(llff_zip), "--set_nums", "1", "2", "3", "--num_train_frames", "-1", "2", "3",
            "--video_poses"]
    mp = pytest.MonkeyPatch()
    try:
        run_jax_main(mp, j_llff.main, ["--database_dirpath", str(root / "jax"), *argv])
    finally:
        mp.undo()
    t_llff.main(["--database_dirpath", str(root / "torch"), *argv, "--device", "cpu"])
    return root / "torch", root / "jax"


def test_llff_cli_builds_the_jax_database(llff_dbs):
    t_dir, j_dir = llff_dbs
    assert_trees_equal(t_dir, j_dir, atol=1e-12)
    scene = t_dir / "all/database_data/fern"
    assert sorted(p.name for p in (scene / "rgb_down4").iterdir()) == [f"{i:04}.png" for i in range(10)]
    train = pd.read_csv(t_dir / "train_test_sets/set02/TrainVideosData.csv")
    assert set(pd.read_csv(t_dir / "train_test_sets/set02/TestVideosData.csv")["pred_frame_num"]) == {0, 8}
    assert len(train) == 4 and set(train["scene_name"]) == {"fern", "trex"}


def test_llff_spiral_poses_match_jax(llff_dbs):
    t_dir, j_dir = llff_dbs
    for name in ("fern", "trex"):
        rel = f"train_test_sets/set02/video_poses01/{name}.csv"
        t = np.loadtxt(t_dir / rel, delimiter=",").reshape(-1, 4, 4)
        j = np.loadtxt(j_dir / rel, delimiter=",").reshape(-1, 4, 4)
        assert t.shape == (121, 4, 4)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(t[:, :3, :3]), 1.0, atol=1e-6)  # rigid transforms
    w2c = np.loadtxt(t_dir / "all/database_data/fern/CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
    bds = np.loadtxt(t_dir / "all/database_data/fern/DepthBounds.csv", delimiter=",")
    for factor in (None, 0.75):
        np.testing.assert_allclose(t_llff.create_video_poses(w2c, 30, 3, bds, factor),
                                   j_llff.create_video_poses(w2c, 30, 3, bds, factor), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [-1, 1, 2, 4])
def test_llff_sparse_sampling_matches_jax(n):
    frames = list(range(1, 38, 2))
    np.testing.assert_array_equal(t_llff.sample_sparse_train_frames(frames, n),
                                  j_llff.sample_sparse_train_frames(frames, n))


def test_llff_jpeg_sources_raise_off_the_card(tmp_path):
    write_raw_llff_scene(tmp_path, num_frames=2, height=24, width=32, source_jpeg=FIXTURE_JPEG)
    scene = tmp_path / "nerf_llff_data/synth01"
    with pytest.raises(RuntimeError, match="nvJPEG"):
        t_llff.extract_scene_data(scene, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):  # no card here: the default device raises
        t_llff.extract_scene_data(scene)


# ------------------------------------------------------------------- DTU

def rotation(axis, angle):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def seeded_cameras(n, seed=0):
    """(world_mat 4x4, scale_mat) pairs: every 5th rotation about an exact
    axis (angles 0, pi/2, pi among them), every 5th one 1e-7 off an axis."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        axis = np.eye(3)[i % 3]
        if i % 5 == 0:
            r = rotation(axis, [0.0, np.pi / 2, np.pi, -np.pi / 2, 0.3][(i // 5) % 5])
        elif i % 5 == 1:
            r = rotation(axis + rng.normal(size=3) * 1e-7, rng.uniform(-np.pi, np.pi))
        else:
            r = rotation(rng.normal(size=3), rng.uniform(-np.pi, np.pi))
        k = np.array([[rng.uniform(300, 3000), rng.uniform(-1, 1), rng.uniform(100, 800)],
                      [0, rng.uniform(300, 3000), rng.uniform(100, 600)], [0, 0, 1]])
        world = np.eye(4)
        world[:3] = rng.uniform(0.5, 2.0) * k @ np.hstack([r, rng.normal(0, 2, (3, 1))])
        scale = np.eye(4)
        scale[:3, :3] *= rng.uniform(0.2, 5)
        scale[:3, 3] = rng.normal(size=3)
        out.append((world, scale))
    return out


def test_decompose_world_mat_matches_cv2():
    for world, scale in seeded_cameras(50):
        for sm in (None, scale):
            want = j_dtu.decompose_world_mat(world.copy(), (300, 400), sm)
            got = t_dtu.decompose_world_mat(world.copy(), (300, 400), sm)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def dtu_dbs(tmp_path_factory):
    src = tmp_path_factory.mktemp("dtu_src")
    rng = np.random.default_rng(3)
    for scan in (8, 21):
        d = src / f"rs_dtu_4/scan{scan}"
        (d / "image").mkdir(parents=True)
        cams = {}
        for f, (world, scale) in enumerate(seeded_cameras(6, seed=scan)):
            imageio.imwrite(d / f"image/{f:06}.png", rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
            cams[f"world_mat_{f}"] = world
            if f % 2 == 0:  # scale_mat is optional
                cams[f"scale_mat_{f}"] = scale
        np.savez(d / "cameras.npz", **cams)
        m = src / f"idrmasks/scan{scan}" / ("mask" if scan == 21 else "")
        m.mkdir(parents=True, exist_ok=True)
        for f in range(3):
            imageio.imwrite(m / f"{f:03}.png", (rng.uniform(size=(32, 40, 3)) > 0.5).astype(np.uint8) * 255)
    root = tmp_path_factory.mktemp("dtu")
    argv = ["--rs_dtu_4_dirpath", str(src / "rs_dtu_4"), "--idrmasks_dirpath", str(src / "idrmasks")]
    mp = pytest.MonkeyPatch()
    try:
        run_jax_main(mp, j_dtu.main, ["--database_dirpath", str(root / "jax"), *argv])
    finally:
        mp.undo()
    t_dtu.main(["--database_dirpath", str(root / "torch"), *argv])
    return root / "torch", root / "jax"


def test_dtu_cli_builds_the_jax_database(dtu_dbs):
    t_dir, j_dir = dtu_dbs
    assert_trees_equal(t_dir, j_dir, atol=1e-9)
    assert sorted(p.name for p in (t_dir / "all/database_data/00021/ObjectMasks").iterdir()) == [
        "0000.png", "0001.png", "0002.png"]


def test_dtu_splits(tmp_path):
    """tests/test_db_builders.py's expectations, and the JAX tables, for
    both protocols."""
    for protocol, n in (("sparse", 3), ("dense", -1)):
        t_dtu.create_train_test_set(tmp_path / "t", 2, n, protocol=protocol, scene_nums=[8, 21])
        j_dtu.create_train_test_set(tmp_path / "j", 2, n, protocol=protocol, scene_nums=[8, 21])
        assert_trees_equal(tmp_path / "t", tmp_path / "j")
    t_dtu.create_train_test_set(tmp_path / "s", 2, 3, scene_nums=[8, 21])
    sets = tmp_path / "s/train_test_sets/set02"
    assert set(pd.read_csv(sets / "TrainVideosData.csv")["pred_frame_num"]) == {25, 22, 28}
    assert len(pd.read_csv(sets / "TestVideosData.csv")) == 2 * 40
    assert set(pd.read_csv(sets / "ValidationVideosData.csv")["pred_frame_num"]) == {24, 26}
    with pytest.raises(RuntimeError, match="protocol"):
        t_dtu.create_train_test_set(tmp_path, 2, 3, protocol="other")


# ------------------------------------------------------------ RealEstate

def write_camera_file(path, translations, timestamps=None, seed=0):
    """A camera file with seeded intrinsics, rotations near identity and the
    given camera positions."""
    rng = np.random.default_rng(seed)
    lines = ["https://example.com/video"]
    ts_list = timestamps or [1000 * (i + 1) for i in range(len(translations))]
    for ts, t in zip(ts_list, translations):
        r = rotation(rng.normal(size=3), rng.uniform(0, 0.05))
        pose = np.hstack([r, -(r @ np.asarray(t, float))[:, None]])
        vals = [str(ts)] + [f"{v:.6f}" for v in rng.uniform(0.4, 0.6, 4)] + ["0", "0"] + [
            f"{v:.6f}" for v in pose.reshape(-1)]
        lines.append(" ".join(vals))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines))


def test_camera_file_parsing_matches_jax(tmp_path):
    path = tmp_path / "abc123.txt"
    write_camera_file(path, [(0.1 * i, 0.0, 0.02 * i) for i in range(7)])
    t, j = t_re.parse_camera_file(path), j_re.parse_camera_file(path)
    assert t["url"] == j["url"]
    for key in ("timestamps", "intrinsics_norm", "poses_3x4"):
        np.testing.assert_array_equal(t[key], j[key], key)
    np.testing.assert_array_equal(t_re.compute_intrinsic_matrices(t["intrinsics_norm"], (360, 640)),
                                  j_re.compute_intrinsic_matrices(j["intrinsics_norm"], (360, 640)))
    np.testing.assert_array_equal(t_re.compute_extrinsic_matrices(t["poses_3x4"]),
                                  j_re.compute_extrinsic_matrices(j["poses_3x4"]))


def test_realestate_cli_and_splits_match_jax(tmp_path, monkeypatch):
    cams = tmp_path / "cameras"
    for i, name in enumerate(("b2", "a1", "c3")):
        write_camera_file(cams / f"{name}.txt", [(0.05 * k, 0.01 * k, 0.0) for k in range(60)], seed=i)
    argv = ["--camera_files_dirpath", str(cams), "--scene_nums", "0", "2", "--num_frames_per_scene", "50"]
    for side in ("jax", "torch"):
        (tmp_path / side / "test").mkdir(parents=True)  # both CLIs write the name mapping into it first
    run_jax_main(monkeypatch, j_re.main, ["--database_dirpath", str(tmp_path / "jax"), *argv])
    t_re.main(["--database_dirpath", str(tmp_path / "torch"), *argv])
    assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    sets = tmp_path / "torch/train_test_sets"
    train = pd.read_csv(sets / "set02/TrainVideosData.csv")
    test = pd.read_csv(sets / "set02/TestVideosData.csv")
    assert set(train["pred_frame_num"]) == {10, 20} and set(train["scene_num"]) == {0, 2}
    assert len(test) == 2 * 45 and {0, 40}.isdisjoint(set(test["pred_frame_num"]))
    assert (tmp_path / "torch/test/database_data/00002/CameraExtrinsics.csv").exists()
    with pytest.raises(RuntimeError, match="density"):
        t_re.create_train_test_set(tmp_path, 2, [0], 2, train_views_density="other")


def motion_scenes(ext, kinds, n):
    moves = {"x": lambda i: (0.2 * i, 0.0, 0.0), "z": lambda i: (0.0, 0.0, 0.2 * i),
             "still": lambda i: (1e-5 * i, 0.0, 0.0)}
    for name, kind in kinds.items():
        write_camera_file(ext / f"{name}/CameraData.txt", [moves[kind](i) for i in range(n)])


@pytest.mark.parametrize("case", ["filter", "shortfall"])
def test_select_scenes_matches_jax(tmp_path, case):
    """tests/test_db_builders.py's two selections: xy motion passes the
    filter, dolly-z and sub-threshold scenes only the random bucket; with
    fewer passing scenes than asked for, the selection comes out short."""
    if case == "filter":
        kinds, n, kw, total = {"sceneA": "x", "sceneB": "z", "sceneC": "still"}, 8, dict(
            num_scenes=2, num_frames_per_scene=4), 2
    else:
        kinds, n, kw, total = {"sceneA": "x", "sceneB": "z", "sceneC": "z", "sceneD": "z"}, 6, dict(
            num_scenes=4, num_frames_per_scene=3), 3
    motion_scenes(tmp_path / "ext", kinds, n)
    kw.update(percentage_xy_motion_scenes=50, start_offset=0, translation_threshold=0.01, seed=0)
    j_all = j_re.select_scenes(tmp_path / "ext", tmp_path / "jax", **kw)
    t_all = t_re.select_scenes(tmp_path / "ext", tmp_path / "torch", **kw)
    assert len(t_all["scene_name"]) == len(j_all) == total
    assert t_all["scene_name"] == j_all["scene_name"].tolist()
    assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    t_re.select_scenes(tmp_path / "ext", tmp_path / "torch", **kw)  # an identical re-run resumes
    with pytest.raises(RuntimeError, match="Configs mismatch"):
        t_re.select_scenes(tmp_path / "ext", tmp_path / "torch", **dict(kw, seed=1))
    t_re.select_scenes(tmp_path / "ext", tmp_path / "jax", **kw)  # the JAX package's selection resumes too


@pytest.mark.parametrize("scale", [1, 2], ids=["as_saved", "halved"])
def test_extract_scene_on_frames_passed_in(tmp_path, monkeypatch, scale):
    cam_file = tmp_path / "abc123.txt"
    write_camera_file(cam_file, [(float(i), 0.0, 0.0) for i in range(8)],
                      timestamps=[i * 100_000 for i in range(8)])
    rng = np.random.default_rng(scale)
    frames = rng.integers(0, 256, (8, 24 * scale, 32 * scale, 3), dtype=np.uint8)
    window = [3, 5]  # from the frame at 300000 us, strided by 2
    calls = []

    def fake_decoder(video_path, timestamps_us):
        calls.append(list(timestamps_us))
        return frames[[int(t) // 100_000 for t in timestamps_us]]

    monkeypatch.setattr(j_re, "extract_frames_from_video", fake_decoder)
    kw = dict(num_frames=2, step_size=2, start_timestamp=300_000, resolution=(24, 32))
    j_re.extract_scene(cam_file, 3, tmp_path / "jax", video_path=tmp_path / "abc123.mp4", **kw)
    t_re.extract_scene(cam_file, 3, tmp_path / "torch", frames=frames[window], **kw)
    assert calls == [[300_000, 500_000]]
    for name in ("CameraIntrinsics.csv", "CameraExtrinsics.csv"):
        assert (tmp_path / "torch/00003" / name).read_bytes() == (tmp_path / "jax/00003" / name).read_bytes()
    for i in range(2):
        t = read_png(tmp_path / f"torch/00003/rgb/{i:04}.png").astype(int)
        j = imageio.imread(tmp_path / f"jax/00003/rgb/{i:04}.png").astype(int)
        assert t.shape == j.shape == (24, 32, 3)
        assert np.abs(t - j).max() <= (0 if scale == 1 else 1)
    with pytest.raises(RuntimeError, match="start_timestamp"):
        t_re.extract_scene(cam_file, 0, tmp_path / "x", start_timestamp=12345)


def test_video_decoding_without_ffmpeg_raises(tmp_path, monkeypatch):
    cam_file = tmp_path / "abc123.txt"
    write_camera_file(cam_file, [(float(i), 0.0, 0.0) for i in range(4)])
    (tmp_path / "abc123.mp4").write_bytes(b"")
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)  # as where ffmpeg is not installed
    with pytest.raises(t_re.FfmpegNotFoundError, match="ffmpeg"):
        t_re.extract_scene(cam_file, 0, tmp_path / "db", num_frames=2, video_path=tmp_path / "abc123.mp4")


@pytest.mark.skipif(not REF_DATA.exists(), reason="reference data not present")
def test_published_splits_match(tmp_path):
    """The reference's published train_test_sets, as
    tests/test_db_builders.py's TestPublishedSplitParity holds the JAX
    creators to them."""
    for builder, db, scenes, sets in (
            (t_re, "RealEstate10K", [0, 1, 3, 4, 6, 7, 8, 9, 10, 11, 15, 17, 19, 22, 23],
             ((1, -1, "dense"), (2, 2, "sparse"), (3, 3, "sparse"), (4, 4, "sparse"))),
            (t_dtu, "DTU", None, ((1, -1, "dense"), (2, 2, "sparse"), (3, 3, "sparse"), (4, 4, "sparse")))):
        ref = REF_DATA / f"{db}/data/train_test_sets"
        for set_num, n, kind in sets:
            if builder is t_re:
                builder.create_train_test_set(tmp_path / db, set_num, scenes, n, train_views_density=kind)
            else:
                builder.create_train_test_set(tmp_path / db, set_num, n, protocol=kind)
            for name in ("Train", "Test", "Validation"):
                pd.testing.assert_frame_equal(
                    pd.read_csv(tmp_path / db / f"train_test_sets/set{set_num:02}/{name}VideosData.csv"),
                    pd.read_csv(ref / f"set{set_num:02}/{name}VideosData.csv"))

"""The port's training data pipeline against the JAX package: PNG reading,
the synthetic database writer, the loaders, the ray and prior caches, the
index streams and the gathered batches.

Both sides read the same database; the JAX side runs its numpy index
streams (`native_raystream: False`). Tolerances: integers, masks, indices
and copied values exactly; rays, view dirs and NDC rays 1e-6 absolute and
relative (the port writes the ray products as explicit f32 multiply-adds,
XLA as a matmul).
"""

import copy
import struct
import time
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from vipnerf_tpu.data import get_data_loader as j_get_data_loader
from vipnerf_tpu.data import get_data_preprocessor as j_get_data_preprocessor
from vipnerf_tpu.data.synthetic import write_synthetic_database as j_write_database
from vipnerf_tpu_torch.data.loaders import get_data_loader
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
from vipnerf_tpu_torch.utils.io import read_mask, read_png

H, W = 48, 64


# ----------------------------------------------------------------- PNGs

def encode_png(image: np.ndarray, filters) -> bytes:
    """A PNG of `image` whose row y uses filter type filters[y % len(filters)]."""
    h, w, c = image.shape
    x = image.astype(np.int64)
    a, b, cc = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)  # left, up, up-left
    a[:, 1:], b[1:], cc[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    ftype = np.array([filters[y % len(filters)] for y in range(h)])[:, None, None]
    pred = np.select([ftype == 1, ftype == 2, ftype == 3, ftype == 4], [a, b, (a + b) // 2, paeth], 0)
    rows = ((x - pred) % 256).astype(np.uint8).reshape(h, w * c)
    raw = np.concatenate([ftype.reshape(h, 1).astype(np.uint8), rows], axis=1).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_decodes_every_filter_type(tmp_path, channels):
    """Rows filtered None, Sub, Up, Average and Paeth in turn (and then in
    another order, so each follows each), and None, Sub and Up alone (which
    decode a row at once), decoded exactly as imageio does."""
    img = np.random.default_rng(channels).integers(0, 256, (11, 9, channels)).astype(np.uint8)
    for k, filters in enumerate(([0, 1, 2, 3, 4], [4, 3, 2, 1, 0, 4, 2], [1, 2, 0, 2])):
        path = tmp_path / f"f{k}.png"
        path.write_bytes(encode_png(img, filters))
        got = read_png(path)
        np.testing.assert_array_equal(got, np.asarray(imageio.imread(path)))
        np.testing.assert_array_equal(got, img[..., 0] if channels == 1 else img)


@pytest.mark.parametrize("filters", [[4], [3], [0, 1, 2, 3, 4]])
def test_read_png_decodes_a_full_size_frame(tmp_path, filters):
    """A 756x1008 RGB frame, the LLFF training size, with Paeth rows, Average
    rows, or all five in turn: decoded exactly, within a second."""
    rng = np.random.default_rng(len(filters))
    y, x = np.mgrid[0:756, 0:1008]
    smooth = np.stack([x // 4, y // 3, (x + y) // 7], -1)
    img = ((smooth + rng.integers(0, 8, smooth.shape)) % 256).astype(np.uint8)
    path = tmp_path / "frame.png"
    path.write_bytes(encode_png(img, filters))
    start = time.perf_counter()
    got = read_png(path)
    seconds = time.perf_counter() - start
    np.testing.assert_array_equal(got, img)
    assert seconds < 1.0, f"read_png took {seconds:.2f} s"


def test_read_png_reads_what_imageio_writes(tmp_path):
    """A smooth image written by imageio (its encoder picks the filters) and a
    binary mask."""
    y, x = np.mgrid[0:40, 0:50]
    img = np.stack([(x * 5) % 256, (y * 3 + x) % 256, (x * y) % 256], -1).astype(np.uint8)
    imageio.imwrite(tmp_path / "a.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)
    imageio.imwrite(tmp_path / "m.png", ((x + y) % 3 == 0).astype(np.uint8) * 255)
    np.testing.assert_array_equal(read_mask(tmp_path / "m.png"), (x + y) % 3 == 0)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        read_png(tmp_path / "bad.png")


# ------------------------------------------------------------- database

DB_ARGS = dict(scene_name="synth01", num_frames=6, train_frames=(0, 5), val_frames=(2,),
               height=H, width=W)


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    """The same scene written by each package's writer, with a dense depth
    prior (the true depths) beside it."""
    roots = {}
    for name, writer in (("jax", j_write_database), ("torch", write_synthetic_database)):
        root = tmp_path_factory.mktemp(name)
        gt = writer(root, **DB_ARGS)
        dense = root / "NeRF_LLFF/data/all/estimated_depths/DD02/synth01/estimated_depths"
        dense.mkdir(parents=True)
        for f in DB_ARGS["train_frames"]:
            np.save(dense / f"{f:04}.npy", gt["depths"][f].astype(np.float32))
        roots[name] = (root / "NeRF_LLFF/data", gt)
    return roots


def test_synthetic_writers_agree(databases):
    (j_dir, j_gt), (t_dir, t_gt) = databases["jax"], databases["torch"]
    for k in ("images", "depths", "extrinsics", "intrinsics", "bounds"):
        np.testing.assert_array_equal(t_gt[k], j_gt[k], err_msg=k)
    j_files = sorted(p.relative_to(j_dir) for p in j_dir.rglob("*") if p.is_file())
    assert j_files == sorted(p.relative_to(t_dir) for p in t_dir.rglob("*") if p.is_file())
    for rel in j_files:
        if rel.suffix == ".png":  # other encoders, the same pixels
            np.testing.assert_array_equal(read_png(t_dir / rel), imageio.imread(j_dir / rel), str(rel))
        else:
            assert (t_dir / rel).read_bytes() == (j_dir / rel).read_bytes(), str(rel)


def train_configs(**dl):
    cfg = {
        "data_loader": {
            "data_loader_name": "NerfLlffDataLoader01", "data_preprocessor_name": "DataPreprocessor01",
            "train_set_num": 2, "scene_id": "synth01", "resolution_suffix": "",
            "recenter_camera_poses": True, "bd_factor": 0.75, "spherify": False, "ndc": True,
            "batching": True, "downsampling_factor": 1, "num_rays": 1000,
            "precrop_fraction": 1, "precrop_iterations": -1, "native_raystream": False,
            "visibility_prior": {"load_masks": True, "load_weights": True,
                                 "masks_dirname": "VW02", "weights_dirname": "VW02"},
            "sparse_depth": {"dirname": "DE02", "num_rays": 150},
        },
        "model": {"white_bkgd": False, "coarse_mlp": {"predict_visibility": True}},
        "seed": 3,
    }
    cfg["data_loader"].update(dl)
    return cfg


def both_preprocessors(db_dir, cfg, mode="train", model_configs=None):
    j_raw = j_get_data_loader(cfg, db_dir, mode).load_data()
    t_raw = get_data_loader(cfg, db_dir, mode).load_data()
    jp = j_get_data_preprocessor(copy.deepcopy(cfg), mode, j_raw, model_configs)
    tp = get_data_preprocessor(copy.deepcopy(cfg), mode, t_raw, model_configs)
    return jp, tp, j_raw, t_raw


def as_np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_batches_equal(tb, jb):
    assert set(tb) == set(jb)
    for k, jv in jb.items():
        jv, tv = np.asarray(jv), as_np(tb[k])
        if jv.dtype.kind == "f":
            np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(tv, jv.astype(tv.dtype), err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_loaders_and_caches_match_jax(databases, writer):
    """Raw data of both loaders, the train caches (rays, NDC rays, pixel ids,
    targets, poses, sparse-depth, dense-depth and both visibility priors) and
    the model configs, on each package's database."""
    db_dir, _ = databases[writer]
    cfg = train_configs(dense_depth={"dirname": "DD02"})
    jp, tp, j_raw, t_raw = both_preprocessors(db_dir, cfg)

    np.testing.assert_array_equal(t_raw["frame_nums"], j_raw["frame_nums"])
    for k in ("images", "extrinsics", "intrinsics", "bounds"):
        np.testing.assert_array_equal(t_raw["nerf_data"][k], j_raw["nerf_data"][k], err_msg=k)
    for f, frame in j_raw["sparse_depth_data"].items():
        for col in frame.columns:
            np.testing.assert_array_equal(t_raw["sparse_depth_data"][f][col], frame[col].to_numpy())
    for k in ("masks", "weights"):
        np.testing.assert_array_equal(t_raw["visibility_prior_data"][k], j_raw["visibility_prior_data"][k])

    assert set(tp.cache) == set(jp.cache)
    for k, jv in jp.cache.items():
        jv, tv = np.asarray(jv), tp.cache[k].numpy()
        assert tv.shape == jv.shape, k
        if jv.dtype.kind == "f":
            np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=k)
    assert tp.get_model_configs() == jp.get_model_configs()


def test_index_streams_and_batches_match_jax(databases):
    """Streams index for index across epoch wraps (6,144 rays in batches of
    1,000; the pool of ~400 sparse-depth rays in batches of 150), and the gathered
    [nerf; sparse-depth] batches, field by field."""
    db_dir, _ = databases["jax"]
    jp, tp, _, _ = both_preprocessors(db_dir, train_configs())
    for start in (0, 7, 20):
        jn, js = jp.get_index_chunk(start, 7)
        tn, ts = tp.get_index_chunk(start, 7)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(ts, js)
        assert tn.dtype == np.int32 and ts.dtype == np.int32
    for j in (0, 6):
        assert_batches_equal(tp.gather_batch(torch.from_numpy(tn[j]), torch.from_numpy(ts[j]), start + j),
                             jp.gather_batch(jn[j], js[j], start + j))
    assert_batches_equal(tp.get_next_batch(27), jp.get_next_batch(27))


def test_precrop_streams_match_jax(databases):
    """The precrop window while it lasts, the full stream after it, and a
    stream resumed past it."""
    db_dir, _ = databases["jax"]
    cfg = train_configs(precrop_fraction=0.5, precrop_iterations=4, num_rays=300)
    del cfg["data_loader"]["sparse_depth"]
    jp, tp, _, _ = both_preprocessors(db_dir, cfg)
    jn, _ = jp.get_index_chunk(0, 9)
    tn, ts = tp.get_index_chunk(0, 9)
    assert ts is None
    np.testing.assert_array_equal(tn, jn)
    rows = (tn[:4] % (H * W)) // W
    assert rows.min() >= 12 and rows.max() < 36  # inside the crop window
    jp, tp, _, _ = both_preprocessors(db_dir, cfg)
    np.testing.assert_array_equal(tp.get_index_chunk(10, 3)[0], jp.get_index_chunk(10, 3)[0])


def test_validation_and_uncached_batches_match_jax(databases):
    """Full-image batches of the train and validation preprocessors, the
    uncached (no batching) path and a test batch of the train preprocessor."""
    db_dir, _ = databases["jax"]
    cfg = train_configs()
    jp, tp, _, _ = both_preprocessors(db_dir, cfg)
    assert_batches_equal(tp.get_next_batch(9, image_num=5), jp.get_next_batch(9, image_num=5))
    jv, tv, _, _ = both_preprocessors(db_dir, cfg, "validation", jp.get_model_configs())
    assert list(tv.frame_nums) == [2] and tv.mode == "validation"
    assert_batches_equal(tv.get_next_batch(9, image_num=2), jv.get_next_batch(9, image_num=2))

    cfg_u = train_configs(batching=False)
    ju, tu, _, _ = both_preprocessors(db_dir, cfg_u)
    assert_batches_equal(tu.get_next_batch(3), ju.get_next_batch(3))
    assert_batches_equal(tu.get_next_batch(4, image_num=0), ju.get_next_batch(4, image_num=0))

    pose = np.eye(4, dtype=np.float32)
    pose[:3] = tp.poses[1][:3]
    tb = tp.create_test_data(pose, preprocess_pose=False)
    jb = jp.create_test_data(pose, preprocess_pose=False)
    for k in tb:
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), atol=1e-6, rtol=1e-6, err_msg=k)


def test_downsampled_caches_match_jax(databases):
    """downsampling_factor 2: frames, dense depths and both visibility priors
    area-downscaled (the JAX package's cv2 INTER_AREA), the intrinsics and
    the sparse-depth coordinates halved; the train caches and the batches."""
    db_dir, _ = databases["jax"]
    cfg = train_configs(downsampling_factor=2, dense_depth={"dirname": "DD02"})
    jp, tp, _, _ = both_preprocessors(db_dir, cfg)
    assert tp.resolution == jp.resolution == [H // 2, W // 2]
    np.testing.assert_array_equal(tp.intrinsics, jp.intrinsics)
    assert set(tp.cache) == set(jp.cache)
    for k, jv in jp.cache.items():
        jv, tv = np.asarray(jv), tp.cache[k].numpy()
        assert tv.shape == jv.shape, k
        if jv.dtype.kind == "f":
            np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=k)
    assert tp.get_model_configs() == jp.get_model_configs()
    np.testing.assert_array_equal(tp.get_index_chunk(0, 3)[1], jp.get_index_chunk(0, 3)[1])


def test_unported_options_raise(databases):
    """spherify, the one option that raised, is ported now: the train
    preprocessor with `spherify: True` gives the JAX preprocessor's poses,
    bounds, near/far and batches (metric rays: NDC needs the forward-facing
    near plane that a spherified scene lacks)."""
    db_dir, _ = databases["jax"]
    cfg = train_configs(spherify=True, ndc=False)
    jp, tp, _, _ = both_preprocessors(db_dir, cfg)
    np.testing.assert_allclose(tp.poses, jp.poses, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tp.bounds, jp.bounds, rtol=1e-12)
    assert (tp.near, tp.far) == pytest.approx((jp.near, jp.far), rel=1e-12)
    assert_batches_equal(tp.get_next_batch(9), jp.get_next_batch(9))

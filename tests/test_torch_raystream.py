"""The port's index streams against the JAX package's under default configs.

Both packages' train-mode preprocessors read one synthetic database with the
same seed. With `native_raystream` left at its default (True) both draw from
the C++ stream (the JAX package's vipnerf_tpu/native, the port's copy in
vipnerf_tpu_torch/csrc/raystream.cpp); with it False both draw numpy. Their
`get_index_chunk` blocks must be equal index for index, NeRF and
sparse-depth streams alike, over chunks that cross epoch wraps and the end
of the precrop window (chunks cut at `precrop_iterations`, as the trainers
cut them). Exact equality: the streams are integer permutations.
"""

import copy

import numpy as np
import pytest

from vipnerf_tpu.data import get_data_loader as j_get_data_loader
from vipnerf_tpu.data import get_data_preprocessor as j_get_data_preprocessor
from vipnerf_tpu_torch.data.loaders import get_data_loader
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
from vipnerf_tpu_torch.data.raystream import NativeRayStream
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database

H, W = 24, 32


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("raystream")
    write_synthetic_database(root, scene_name="synth01", num_frames=6, train_frames=(0, 5),
                             val_frames=(2,), height=H, width=W)
    return root / "NeRF_LLFF/data"


def configs(**dl):
    cfg = {
        "data_loader": {
            "data_loader_name": "NerfLlffDataLoader01", "data_preprocessor_name": "DataPreprocessor01",
            "train_set_num": 2, "scene_id": "synth01", "resolution_suffix": "",
            "recenter_camera_poses": True, "bd_factor": 0.75, "spherify": False, "ndc": True,
            "batching": True, "downsampling_factor": 1, "num_rays": 500,
            "precrop_fraction": 1, "precrop_iterations": -1,
            "visibility_prior": {"load_masks": True, "load_weights": False, "masks_dirname": "VW02"},
            "sparse_depth": {"dirname": "DE02", "num_rays": 64},
        },
        "model": {"white_bkgd": False, "coarse_mlp": {"predict_visibility": True}},
        "seed": 5,
    }
    cfg["data_loader"].update(dl)
    return cfg


def preprocessors(db_dir, cfg):
    jp = j_get_data_preprocessor(copy.deepcopy(cfg), "train", j_get_data_loader(cfg, db_dir, "train").load_data())
    tp = get_data_preprocessor(copy.deepcopy(cfg), "train", get_data_loader(cfg, db_dir, "train").load_data())
    return jp, tp


# chunks as the trainers cut them: (start, length); precrop ends at 4
CHUNKS = [(0, 4), (4, 5), (9, 7), (16, 3)]


@pytest.mark.parametrize("native", [None, False], ids=["default", "numpy"])
@pytest.mark.parametrize("precrop", [False, True], ids=["full", "precrop"])
def test_index_chunks_equal_the_jax_package(db_dir, native, precrop):
    extra = {} if native is None else {"native_raystream": native}
    if precrop:
        extra.update(precrop_fraction=0.5, precrop_iterations=4, num_rays=300)  # window: 384 rays
    jp, tp = preprocessors(db_dir, configs(**extra))
    uses_native = native is None
    assert (jp._native_nerf is not None) == uses_native  # the JAX side built its library
    assert (tp._native_nerf is not None) == uses_native
    assert (tp._native_sd is not None) == uses_native
    n_full = 2 * H * W
    sd_pool = len(tp._indices_sd)
    assert 0 < sd_pool < 64 * sum(k for _, k in CHUNKS)  # the sparse-depth stream wraps too
    seen = []
    for start, k in CHUNKS:
        jn, js = jp.get_index_chunk(start, k)
        tn, ts = tp.get_index_chunk(start, k)
        assert tn.dtype == np.int32 and ts.dtype == np.int32
        np.testing.assert_array_equal(tn, jn, err_msg=f"NeRF stream, chunk {start}")
        np.testing.assert_array_equal(ts, np.asarray(js), err_msg=f"sparse-depth stream, chunk {start}")
        seen.append(tn)
    rays = np.concatenate(seen)
    assert rays.size > n_full  # past the first epoch
    if precrop:
        rows = (rays[:4] % (H * W)) // W
        assert rows.min() >= H // 4 and rows.max() < 3 * H // 4  # inside the window
        assert len(np.unique(rays[4:])) > len(np.unique(rays[:4]))  # the full stream after it


def test_native_stream_semantics():
    """A permutation per epoch, the tail wrapping into the next one, a reset
    to a new candidate set, and the same blocks from the same seed."""
    a = NativeRayStream(3, candidates=np.arange(10, 20))
    b = NativeRayStream(3, count=10)
    assert a.size == 10
    block = a.next_block(3, 4)  # 12 draws: one epoch and 2 of the next
    assert sorted(block.ravel()[:10]) == list(range(10, 20))
    np.testing.assert_array_equal(b.next_block(3, 4) + 10, block)
    a.reset(count=7)
    assert a.size == 7 and sorted(a.next_block(1, 7).ravel()) == list(range(7))
    with pytest.raises(ValueError):
        NativeRayStream(0, count=0)

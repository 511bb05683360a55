"""The frozen counts of the benchmark against hand counts at one small
shape, and against the program's constants as they stand today (a later
change to the program may move those; the frozen copy stays)."""

import pytest

from harness import counts


def test_macs_per_point_by_hand():
    # trunk: 63->256, four 256->256, the skip 319->256, two 256->256
    trunk = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256
    heads = 256 * 256 + 256 * 1 + (256 + 27) * 128 + 128 * 4  # feature, sigma, view hidden, view output
    assert counts.TRUNK_MACS == trunk == 491_008
    assert counts.MACS_PER_POINT == trunk + heads == 593_536
    assert counts.MACS_PER_SEC_VIEW == (256 + 27) * 128 + 128 * 4


def test_model_flops_and_k1_forward_bound_by_hand():
    points, n_sec = 100, 2
    macs = 100 * (593_536 + 2 * 36_736)
    assert counts.model_flops(points, n_sec, False) == 2 * macs
    assert counts.model_flops(points, n_sec, True) == 6 * macs
    split = 3 * (256 * 256 + 256) + 6 * (256 * 128 + 27 * 128 + 128 * 4) + 2 * 6 * (27 * 128 + 128)
    ops_s = 2 * points * (491_008 + split) / 989e12
    bytes_ = points * (64 * 2 + 4 * (32 * 3 + 8)) + counts.FWD_PACK_BYTES
    assert counts.k1_fwd_bound_s(points, n_sec) == pytest.approx(max(ops_s, bytes_ / 3.35e12), rel=1e-12)
    # one scene's pack: bf16 trunk, three bf16 parts per f32 head weight, f32 biases
    # (the trunk as K1 pads it: 64 input columns to layer 0, 320 to the skip layer)
    trunk_padded = 256 * 64 + 4 * 256 * 256 + 256 * 320 + 2 * 256 * 256
    assert counts.FWD_PACK_BYTES == 2 * trunk_padded + 6 * (256 * 256 + 8 * 256 + 128 * 288 + 8 * 128) \
        + 4 * (8 * 256 + 256 + 8 + 128 + 8)


def test_k1_backward_bound_by_hand():
    points, n_sec = 1000, 1
    ops_p = 2 * points * (3 * 256 * 256 + 6 * (128 * 256 * 2 + 256 * 256) + 2 * 6 * 27 * 128) / 989e12
    ops_w = 2 * points * (3 * (256 * 256 + 256) + 6 * (128 * 256 + 3 * 128) + 2 * 6 * (128 * 27 + 128)) / 989e12
    b_p, b_w = counts.bwd_bytes(points, n_sec)
    assert counts.k1_bwd_bound_s(points, n_sec) == pytest.approx(
        max(ops_p, b_p / 3.35e12) + max(ops_w, b_w / 3.35e12), rel=1e-12)
    inputs = points * (2 * 256 + 4 * 32 * 2 + 4 * 8)
    mid = points * (4 * (2 * 256 + 128) + 2 * 4 * 2 * 128)
    assert b_w - inputs - mid == 4 * (256 * 256 + 8 * 256 + 128 * 288 + 8 * 128 + 256 + 1 + 128 + 4)


def test_frozen_counts_match_the_program_today():
    from vipnerf_tpu_torch.kernels import fused_mlp as k1

    assert counts.TRUNK_MACS == k1.TRUNK_MACS_PER_POINT
    assert counts.MACS_PER_POINT == k1.MACS_PER_POINT and counts.MACS_PER_SEC_VIEW == k1.MACS_PER_SEC_VIEW
    assert counts.F32H_SPLIT_MACS == k1.F32H_SPLIT_MACS
    assert counts.F32H_SPLIT_MACS_PER_SEC_VIEW == k1.F32H_SPLIT_MACS_PER_SEC_VIEW
    assert counts.FWD_PACK_BYTES == k1.PACK_BYTES[k1.torch.bfloat16, k1.torch.float32] + 4 * k1.B_NUMEL
    assert counts.BWD_POINT_MACS == k1.BWD_POINT_MACS and counts.BWD_WEIGHT_MACS == k1.BWD_WEIGHT_MACS
    assert counts.BWD_POINT_MACS_PER_VIEW == k1.BWD_POINT_MACS_PER_VIEW
    assert counts.BWD_WEIGHT_MACS_PER_VIEW == k1.BWD_WEIGHT_MACS_PER_VIEW
    for n, n_sec, s in ((4096 * 64, 1, 1), (8192 * 192, 2, 2)):
        assert counts.bwd_bytes(n, n_sec, s) == k1.bwd_bytes(n, n_sec, s)

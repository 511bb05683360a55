"""The port's core math (vipnerf_tpu_torch.core) against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. Everything is
f32; tolerances: 1e-6 absolute where both sides do the same few float ops,
1e-5 where sin/cos of arguments up to 2^9 or a 3x3 inverse enter, relative
1e-5 for metric depths (values up to ~1e2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipnerf_tpu.core import encoding as j_enc
from vipnerf_tpu.core import poses as j_poses
from vipnerf_tpu.core import rays as j_rays
from vipnerf_tpu.core import rendering as j_rend
from vipnerf_tpu.core import sampling as j_samp
from vipnerf_tpu_torch.core import encoding as t_enc
from vipnerf_tpu_torch.core import poses as t_poses
from vipnerf_tpu_torch.core import rays as t_rays
from vipnerf_tpu_torch.core import rendering as t_rend
from vipnerf_tpu_torch.core import sampling as t_samp


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def close(t_out, j_out, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(
        t_out.detach().numpy(), np.asarray(j_out), atol=atol, rtol=rtol
    )


def random_rays(nr=32, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.3, (nr, 3)).astype(np.float32)
    d = (rng.normal(0, 0.3, (nr, 3)) + [0, 0, -1.0]).astype(np.float32)
    return o, d


@pytest.mark.parametrize("degree", [0, 4, 10])
def test_positional_encoding(degree):
    x = np.random.default_rng(degree).uniform(-1, 1, (64, 3)).astype(np.float32)
    out = t_enc.positional_encoding(T(x), degree)
    assert out.shape[-1] == t_enc.encoding_dim(3, degree) == j_enc.encoding_dim(3, degree)
    close(out, j_enc.positional_encoding(jnp.asarray(x), degree), atol=1e-5)


def test_get_rays_and_view_dirs():
    rng = np.random.default_rng(1)
    intr = np.array([[50.0, 0, 16.3], [0, 52.0, 11.7], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = rng.normal(size=3)
    o_t, d_t = t_rays.get_rays(24, 32, T(intr), T(c2w))
    o_j, d_j = j_rays.get_rays(24, 32, jnp.asarray(intr), jnp.asarray(c2w))
    assert o_t.shape == d_t.shape == (24, 32, 3)
    close(o_t, o_j)
    close(d_t, d_j, atol=1e-5)
    close(t_rays.get_view_dirs(d_t), j_rays.get_view_dirs(jnp.asarray(d_t.numpy())))


def test_ndc_rays_and_depth_conversions():
    o, d = random_rays()
    on_t, dn_t = t_rays.get_ndc_rays(T(o), T(d), 24, 32, 40.0, 41.0, 1.0)
    on_j, dn_j = j_rays.get_ndc_rays(jnp.asarray(o), jnp.asarray(d), 24, 32, 40.0, 41.0, 1.0)
    close(on_t, on_j, atol=1e-5)
    close(dn_t, dn_j, atol=1e-5)

    depths = np.random.default_rng(2).uniform(1.5, 20.0, (32, 5)).astype(np.float32)
    for dep in (depths, depths[:, :1]):
        close(t_rays.depth_to_ndc(T(dep), T(o), T(d)),
              j_rays.depth_to_ndc(jnp.asarray(dep), jnp.asarray(o), jnp.asarray(d)))


def test_both_ndc_stabilizers():
    """depth_from_ndc adds 1e-3 only where z' == 1 exactly; ndc_z_to_ray_t
    adds 1e-6 everywhere. Both at z' = 1, just below it, and inside."""
    o, d = random_rays(8)
    z = np.tile(np.array([0.0, 0.3, 0.9, 0.999, 1.0], np.float32), (8, 1))
    args_t = (T(z), T(o), T(d))
    args_j = (jnp.asarray(z), jnp.asarray(o), jnp.asarray(d))
    depth_t = t_rays.depth_from_ndc(*args_t)
    assert torch.isfinite(depth_t).all()
    close(depth_t, j_rays.depth_from_ndc(*args_j), rtol=1e-5)
    ray_t = t_rays.ndc_z_to_ray_t(*args_t)
    close(ray_t, j_rays.ndc_z_to_ray_t(*args_j), rtol=1e-5)
    # the two conversions differ at z' == 1: 1/(1e-3) vs 1/(1e-6)
    assert not np.allclose(depth_t[:, -1].numpy(), ray_t[:, -1].numpy(), rtol=0.1)


@pytest.mark.parametrize("train_mode", [False, True])
def test_preprocess_poses(train_mode):
    rng = np.random.default_rng(3)
    w2c = np.tile(np.eye(4), (4, 1, 1))
    for i in range(4):
        w2c[i, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        w2c[i, :3, 3] = rng.normal(size=3)
    bounds = np.array([1.3, 9.0])
    if train_mode:
        kw = dict(train_mode=True, bounds=bounds, bd_factor=0.75)
    else:
        kw = dict(train_mode=False, bounds=bounds, translation_scale=0.7,
                  average_pose=j_poses.compute_average_pose(w2c))
    out_t = t_poses.preprocess_poses(w2c, **kw)
    out_j = j_poses.preprocess_poses(w2c, **kw)
    assert set(out_t) == set(out_j)
    for k in out_j:
        np.testing.assert_allclose(np.asarray(out_t[k]), np.asarray(out_j[k]), atol=1e-12 if k != "poses" else 1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
def test_coarse_z_vals(lindisp):
    near = np.full((16, 1), 0.5, np.float32)
    far = np.random.default_rng(4).uniform(2, 6, (16, 1)).astype(np.float32)
    z_t = t_samp.coarse_z_vals(T(near), T(far), 64, lindisp=lindisp)
    close(z_t, j_samp.coarse_z_vals(jnp.asarray(near), jnp.asarray(far), 64, lindisp=lindisp), rtol=1e-6)


def test_coarse_z_vals_perturbed_stay_in_their_strata():
    near, far = torch.full((16, 1), 0.0), torch.full((16, 1), 1.0)
    det = t_samp.coarse_z_vals(near, far, 8)
    z = t_samp.coarse_z_vals(near, far, 8, perturb=True, generator=torch.Generator().manual_seed(0))
    mids = 0.5 * (det[:, 1:] + det[:, :-1])
    lower = torch.cat([det[:, :1], mids], -1)
    upper = torch.cat([mids, det[:, -1:]], -1)
    assert ((z >= lower) & (z <= upper)).all() and not torch.equal(z, det)
    with pytest.raises(ValueError):
        t_samp.coarse_z_vals(near, far, 8, perturb=True)


def _pdf_case(name):
    rng = np.random.default_rng(5)
    bins = np.sort(rng.uniform(0, 1, (8, 33)), axis=-1).astype(np.float32)
    if name == "random":
        w = rng.uniform(0, 1, (8, 32))
    elif name == "zeros":  # uniform pdf after the 1e-5 floor
        w = np.zeros((8, 32))
    elif name == "one_hot":  # almost all bins narrower than 1e-5 in the cdf
        w = np.zeros((8, 32))
        w[np.arange(8), rng.integers(0, 32, 8)] = 5.0
    else:  # "ends": mass at both ends, u = 1.0 lands on cdf[-1]
        w = np.zeros((8, 32))
        w[:, 0] = w[:, -1] = 1.0
    return bins, w.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "zeros", "one_hot", "ends"])
def test_sample_pdf_deterministic(case):
    """torch.cumsum and XLA's cumsum round differently (~2e-7), so a u within
    1e-6 of a cdf entry may fall in the neighbouring bin on one side: those
    ties are excluded, everything else agrees to 1e-5."""
    bins, w = _pdf_case(case)
    s_t = t_samp.sample_pdf(T(bins), T(w), 48, det=True)
    s_j = j_samp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 48, det=True)
    wf = w.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((8, 1)), np.cumsum(wf / wf.sum(-1, keepdims=True), -1)], -1)
    u = np.linspace(0, 1, 48)
    no_tie = np.abs(u[None, :, None] - cdf[:, None, :]).min(-1) > 1e-6
    assert no_tie.mean() > 0.9
    np.testing.assert_allclose(s_t.numpy()[no_tie], np.asarray(s_j)[no_tie], atol=1e-5)
    # u = 1.0, the last det sample, lands on cdf[-1] (within its rounding):
    # the last bin's end
    np.testing.assert_allclose(s_t[:, -1].numpy(), bins[:, -1], atol=1e-5)


def test_fine_z_vals():
    rng = np.random.default_rng(6)
    z = np.sort(rng.uniform(0, 1, (8, 64)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (8, 64)).astype(np.float32)
    f_t = t_samp.fine_z_vals(T(z), T(w), 128)
    f_j = j_samp.fine_z_vals(jnp.asarray(z), jnp.asarray(w), 128)
    assert f_t.shape == (8, 192)
    close(f_t, f_j, atol=1e-6)


def test_exclusive_cumprod():
    x = np.random.default_rng(7).uniform(0.5, 1.0, (4, 40)).astype(np.float32)
    close(t_rend.exclusive_cumprod(T(x)), j_rend.exclusive_cumprod(jnp.asarray(x)), rtol=1e-6)


@pytest.mark.parametrize("ndc", [False, True])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volume_rendering(ndc, white_bkgd):
    rng = np.random.default_rng(8)
    nr, ns = 16, 24
    rgb = rng.uniform(0, 1, (nr, ns, 3)).astype(np.float32)
    sigma = rng.uniform(0, 3, (nr, ns)).astype(np.float32)
    vis2 = rng.uniform(0, 1, (nr, ns, 2, 1)).astype(np.float32)
    o, d = random_rays(nr)
    z = np.sort(rng.uniform(0.05, 0.95, (nr, ns)), axis=-1).astype(np.float32)
    if ndc:
        dn = rng.normal(0, 0.5, (nr, 3)).astype(np.float32)
        kw = dict(z_vals_ndc=z, rays_d_ndc=dn, rays_o=o, rays_d=d)
    else:
        kw = dict(z_vals=z * 10, rays_d=d)
    out_t = t_rend.volume_rendering(T(rgb), T(sigma), white_bkgd=white_bkgd, ndc=ndc,
                                    visibility2=T(vis2), **{k: T(v) for k, v in kw.items()})
    out_j = j_rend.volume_rendering(jnp.asarray(rgb), jnp.asarray(sigma), white_bkgd=white_bkgd,
                                    ndc=ndc, visibility2=jnp.asarray(vis2),
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    assert set(out_t) == set(out_j)
    for k in out_j:
        close(out_t[k], out_j[k], atol=1e-5, rtol=1e-5)

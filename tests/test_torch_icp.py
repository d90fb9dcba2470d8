"""Parity of the port's ICP module (`aslam_tpu_torch/ops/icp.py`) with the
JAX package's `aslam_tpu/ops/icp.py`, on the CPU, on the curved-surface pair
of tests/test_gicp.py: the same numpy inputs through both.

Tolerances: `backproject_depth` and `normal_map` 1e-6; the refined T12 of
`icp_refine`, `gicp_refine` and `gicp_align_matched` 1e-4 (the port inverts
the per-point 3x3 weight matrix in closed form where the reference calls an
LU inverse), `n_corr` and `converged` equal; the `voxel_downsample` mask
equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.ops import icp as jicp
from aslam_tpu.utils.se3 import se3_exp
from aslam_tpu_torch import convert
from aslam_tpu_torch.ops import icp as ticp
from test_gicp import _curved_depth, _pose_err, _src_set

CFG = small_config()
PCFG = P.port_config(CFG)


@pytest.fixture(scope="module")
def curved_pair():
    cam = CFG.camera
    xi = np.array([0.03, -0.02, 0.025, 0.015, -0.02, 0.01], np.float32)
    T12_true = np.asarray(se3_exp(jnp.asarray(xi)))
    d1 = _curved_depth(cam, np.eye(4))
    d2 = _curved_depth(cam, T12_true)
    d2[40:60, 100:140] = 0.0                      # a depth hole in the target
    p, n, valid = (np.asarray(a) for a in _src_set(cam, d1))
    return d1, d2, T12_true.astype(np.float32), p, n, valid


def _assert_result(out: ticp.ICPResult, ref, atol=1e-4):
    np.testing.assert_allclose(P.n(out.T12), np.asarray(ref.T12), atol=atol)
    assert int(out.n_corr) == int(ref.n_corr)
    assert bool(out.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(out.rmse), float(ref.rmse), atol=1e-5)
    assert out.n_corr.dtype == torch.int32 and out.converged.dtype == torch.bool


def test_backproject_and_normal_map_match_reference(curved_pair):
    d1, d2, *_ = curved_pair
    for d in (d1, d2):
        pts_j = jicp.backproject_depth(jnp.asarray(d), CFG.camera)
        nm_j = jicp.normal_map(pts_j, jnp.asarray(d > 0.05))
        pts_t = ticp.backproject_depth(P.t(d), PCFG.camera)
        nm_t = ticp.normal_map(pts_t, P.t(d > 0.05))
        np.testing.assert_allclose(P.n(pts_t), np.asarray(pts_j), atol=1e-6)
        np.testing.assert_allclose(P.n(nm_t), np.asarray(nm_j), atol=1e-6)
    # the hole leaves zero normals around it, and the borders wrap (roll)
    assert (P.n(nm_t)[40:60, 99:141] == 0).all()
    assert (P.n(nm_t)[39:61, 100:140] == 0).all()
    assert np.abs(P.n(nm_t)[0]).sum() > 0


@pytest.mark.parametrize("start", ["identity", "truth"])
@pytest.mark.parametrize("method", ["point_to_plane", "gicp"])
def test_refine_matches_reference(curved_pair, method, start):
    d1, d2, T12_true, p, n, valid = curved_pair
    T0 = np.eye(4, dtype=np.float32) if start == "identity" else T12_true
    if method == "gicp":
        ref = jicp.gicp_refine(jnp.asarray(p), jnp.asarray(n),
                               jnp.asarray(valid), jnp.asarray(d2),
                               jnp.asarray(T0), CFG.camera, CFG.icp)
        out = ticp.gicp_refine(P.t(p), P.t(n), P.t(valid), P.t(d2), P.t(T0),
                               PCFG.camera, PCFG.icp)
    else:
        ref = jicp.icp_refine(jnp.asarray(p), jnp.asarray(valid),
                              jnp.asarray(d2), jnp.asarray(T0), CFG.camera,
                              CFG.icp)
        out = ticp.icp_refine(P.t(p), P.t(valid), P.t(d2), P.t(T0),
                              PCFG.camera, PCFG.icp)
    _assert_result(out, ref)
    assert bool(out.converged)
    t_err, r_err = _pose_err(P.n(out.T12), T12_true)
    assert t_err < 0.02 and r_err < 0.02
    # carried across, the reference's result is the port's
    back = convert.icp_result(P.tree_np(ref), "cpu")
    assert back.n_corr.dtype == torch.int32 and int(back.n_corr) == int(out.n_corr)


def test_refine_without_correspondences_keeps_the_start(curved_pair):
    """Fewer than 10 correspondences: not converged, T12 is the start; a
    point with a tiny z projects far beyond int32 and is masked, not cast."""
    d1, d2, T12_true, p, n, valid = curved_pair
    few = valid & (np.arange(len(valid)) < 6)
    p = p.copy()
    p[7] = [3.0e4, -2.0e4, 1e-9]                   # |u| ~ 1e16
    few[7] = True
    for fn_j, fn_t, extra in (
            (jicp.icp_refine, ticp.icp_refine, ()),
            (jicp.gicp_refine, ticp.gicp_refine, (n,))):
        ref = fn_j(jnp.asarray(p), *(jnp.asarray(a) for a in extra),
                   jnp.asarray(few), jnp.asarray(d2), jnp.asarray(T12_true),
                   CFG.camera, CFG.icp)
        out = fn_t(P.t(p), *(P.t(a) for a in extra), P.t(few), P.t(d2),
                   P.t(T12_true), PCFG.camera, PCFG.icp)
        # six points leave the Gauss-Newton system singular, so the last
        # iterate (and its few correspondences) is not comparable: what both
        # sides must give is "not converged" and the start
        assert not bool(out.converged) and not bool(ref.converged)
        assert int(out.n_corr) < 10 and int(ref.n_corr) < 10
        assert np.isfinite(float(out.rmse))
        np.testing.assert_array_equal(P.n(out.T12), T12_true)
        np.testing.assert_array_equal(np.asarray(ref.T12), T12_true)


def test_gicp_align_matched_matches_reference():
    rng = np.random.default_rng(3)
    N = 400
    p1 = rng.uniform(-1, 1, (N, 3))
    p1[:, 2] += 2.5
    n1 = rng.normal(size=(N, 3))
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n1[:40] = 0.0                                  # unknown normals
    xi = np.array([0.04, -0.03, 0.02, 0.02, 0.015, -0.01], np.float32)
    T_true = np.asarray(se3_exp(jnp.asarray(xi)))
    p2 = p1 @ T_true[:3, :3].T + T_true[:3, 3] + n1 * rng.normal(0, 0.02, (N, 1))
    n2 = n1 @ T_true[:3, :3].T
    ok = rng.random(N) > 0.1
    args = [a.astype(np.float32) for a in (p1, n1, p2, n2)]
    eye = np.eye(4, dtype=np.float32)
    ref = jicp.gicp_align_matched(*(jnp.asarray(a) for a in args),
                                  jnp.asarray(ok), jnp.asarray(eye), CFG.icp,
                                  iters=15)
    out = ticp.gicp_align_matched(*(P.t(a) for a in args), P.t(ok), P.t(eye),
                                  PCFG.icp, iters=15)
    _assert_result(out, ref)
    t_err, r_err = _pose_err(P.n(out.T12), T_true)
    assert t_err < 0.015 and r_err < 0.01


@pytest.mark.parametrize("cell", [0.03, 0.1, 0.5])
def test_voxel_downsample_mask_equals_reference(cell):
    rng = np.random.default_rng(int(cell * 100))
    pts = rng.uniform(-2, 2, (4000, 3)).astype(np.float32)
    pts[:200] = pts[200:400]                       # exact duplicates
    pts[500] *= 4000.0                             # hash products wrap int32
    valid = rng.random(4000) > 0.1
    _, keep_j = jicp.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid),
                                      cell=cell)
    out_pts, keep_t = ticp.voxel_downsample(P.t(pts), P.t(valid), cell=cell)
    np.testing.assert_array_equal(P.n(keep_t), np.asarray(keep_j))
    assert 0 < int(keep_t.sum()) < int(valid.sum())
    assert torch.equal(out_pts, P.t(pts))


def test_subset_mask_keeps_the_fraction():
    valid = torch.ones(10_000, dtype=torch.bool)
    valid[:1000] = False
    gen = torch.Generator().manual_seed(0)
    m = ticp.subset_mask(gen, valid, frac=0.75)
    assert not m[:1000].any()
    assert 0.7 < float(m[1000:].float().mean()) < 0.8
    gen2 = torch.Generator().manual_seed(0)
    assert torch.equal(ticp.subset_mask(gen2, valid, frac=0.75), m)


def test_iteration_count_comes_from_the_config(curved_pair):
    """The port's loop over `cfg.iterations` honours the config."""
    d1, d2, T12_true, p, n, valid = curved_pair
    eye = np.eye(4, dtype=np.float32)
    one = dataclasses.replace(PCFG.icp, iterations=1)
    many = dataclasses.replace(PCFG.icp, iterations=15)
    r1 = ticp.gicp_refine(P.t(p), P.t(n), P.t(valid), P.t(d2), P.t(eye),
                          PCFG.camera, one)
    r15 = ticp.gicp_refine(P.t(p), P.t(n), P.t(valid), P.t(d2), P.t(eye),
                           PCFG.camera, many)
    assert _pose_err(P.n(r15.T12), T12_true)[0] \
        < _pose_err(P.n(r1.T12), T12_true)[0]

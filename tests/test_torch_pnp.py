"""Parity of the port's PnP-RANSAC (`ops/pnp.py`) with the JAX package, on
the CPU, on the problems of tests/test_pnp.py.  With the reference's draws
injected the port reaches its pose to 1e-4 and its inlier mask exactly;
with its own draws it recovers the true pose as the reference's test asks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import CameraModel
from aslam_tpu.ops import pnp as jpnp
from aslam_tpu.utils import camera, se3
from aslam_tpu_torch.config import CameraModel as TCameraModel
from aslam_tpu_torch.ops import pnp as tpnp

CAM = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
TCAM = TCameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320,
                    height=240)


def make_problem(rng, n=120, outlier_frac=0.3, pose_err=0.08, noise_px=0.5):
    pts = np.stack([
        rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(1.5, 4, n)
    ], -1).astype(np.float32)
    T_true = np.asarray(se3.se3_exp(jnp.asarray(
        rng.normal(0, 0.1, 6).astype(np.float32))))
    uv, z = camera.project(CAM, jnp.asarray(pts @ T_true[:3, :3].T + T_true[:3, 3]))
    uv = np.array(uv) + rng.normal(0, noise_px, (n, 2))
    n_out = int(n * outlier_frac)
    sel = rng.choice(n, n_out, replace=False)
    uv[sel] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    T_init = np.asarray(se3.se3_exp(jnp.asarray(
        rng.normal(0, pose_err, 6).astype(np.float32)))) @ T_true
    gt_inl = np.ones(n, bool)
    gt_inl[sel] = False
    return pts, uv.astype(np.float32), T_true, T_init.astype(np.float32), gt_inl


def _both(pts, uv, valid, T_init, seed):
    key = jax.random.PRNGKey(seed)
    rj = jpnp.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid),
                         jnp.asarray(T_init), key, CAM)
    draws = np.asarray(jax.random.randint(key, (64, 8), 0,
                                          max(int(valid.sum()), 1)))
    rt = tpnp.pnp_ransac(P.t(pts), P.t(uv), P.t(valid), P.t(T_init), None,
                         TCAM, draws=P.t(draws))
    return rj, rt


@pytest.mark.parametrize("outlier_frac", [0.0, 0.3, 0.5])
def test_pnp_ransac_matches_reference(outlier_frac):
    rng = np.random.default_rng(0)
    pts, uv, T_true, T_init, gt_inl = make_problem(rng, outlier_frac=outlier_frac)
    valid = np.ones(len(pts), bool)
    valid[::17] = False
    rj, rt = _both(pts, uv, valid, T_init, seed=0)
    assert bool(rt.ok) == bool(rj.ok)
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_array_equal(P.n(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(P.n(rt.T_cw), np.asarray(rj.T_cw), atol=1e-4)


def test_pnp_ransac_prior_rescue_matches_reference():
    rng = np.random.default_rng(1)
    pts, uv, _, T_init, _ = make_problem(rng, outlier_frac=1.0)
    rj, rt = _both(pts, uv, np.ones(len(pts), bool), T_init, seed=1)
    assert not bool(rt.ok) and not bool(rj.ok)
    np.testing.assert_allclose(P.n(rt.T_cw), T_init, atol=1e-6)
    assert int(rt.n_inliers) == 0 and not P.n(rt.inliers).any()


def test_pnp_ransac_recovers_pose_with_own_draws():
    rng = np.random.default_rng(0)
    pts, uv, T_true, T_init, gt_inl = make_problem(rng)
    g = torch.Generator().manual_seed(0)
    res = tpnp.pnp_ransac(P.t(pts), P.t(uv), torch.ones(len(pts), dtype=torch.bool),
                          P.t(T_init), g, TCAM)
    assert bool(res.ok)
    T = P.n(res.T_cw)
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.01
    assert (P.n(res.inliers) == gt_inl).mean() > 0.9


def test_gn_refine_matches_reference():
    rng = np.random.default_rng(3)
    pts, uv, _, T_init, _ = make_problem(rng, outlier_frac=0.0)
    w = rng.uniform(0.5, 1.0, len(pts)).astype(np.float32)
    Tj = np.asarray(jpnp._gn_refine(jnp.asarray(T_init), jnp.asarray(pts),
                                    jnp.asarray(uv), jnp.asarray(w), CAM, 8))
    Tt = P.n(tpnp._gn_refine(P.t(T_init), P.t(pts), P.t(uv), P.t(w), TCAM, 8))
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)

"""The port's copy of the sequential CPU baseline
(`aslam_tpu_torch/baselines/refcpu.py`) against the JAX package's
(`aslam_tpu/baselines/refcpu.py`) on the same seeded inputs: both are numpy,
so every output is equal, bit for bit."""

import dataclasses

import numpy as np
import pytest

import _torch_parity as P
from aslam_tpu.baselines import refcpu as jref
from aslam_tpu.config import small_config
from aslam_tpu_torch.baselines import refcpu as tref


def _cams():
    cam = small_config().camera
    return cam, P.port_config(small_config()).camera


def _pairs(seed, n=150, outliers=0.3):
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                   rng.uniform(0.8, 3.5, n)], -1)
    xi = rng.normal(0, 0.03, 6)
    T = jref._se3_exp_g2o(xi)
    p2 = p1 @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.003, (n, 3))
    bad = rng.random(n) < outliers
    p2[bad] += rng.normal(0, 0.3, (int(bad.sum()), 3))
    p2[:4, 2] = 0.0                                   # no depth
    return p1, p2, rng.random(n) * 64, T


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ref_ransac_equals_reference(seed, static):
    cam, pcam = _cams()
    p1, p2, dist, _ = _pairs(seed)
    params = dict(static_depth_cov=static, iterations=60)
    ref = jref.RefRansac(cam, jref.RefRansacParams(**params), seed=seed)
    port = tref.RefRansac(pcam, tref.RefRansacParams(**params), seed=seed)
    for _ in range(2):                # the frozen depth covariance carries over
        a, b = ref.iterate(p1, p2, dist), port.iterate(p1, p2, dist)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
        assert b[3] and len(b[1]) >= 20
    assert ref.depth_cov.frozen == port.depth_cov.frozen
    assert dataclasses.asdict(ref.p) == dataclasses.asdict(port.p)


def test_ref_ransac_refuses_a_small_pool():
    cam, pcam = _cams()
    p1, p2, dist, _ = _pairs(3, n=12)
    T, inl, rmse, ok = tref.RefRansac(pcam).iterate(p1, p2, dist)
    assert not ok and rmse == 1e6 and len(inl) == 0
    np.testing.assert_array_equal(T, np.eye(4))


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_umeyama_and_se3_exp_equal_reference(seed):
    p1, p2, _, T = _pairs(seed, outliers=0.0)
    w = np.random.default_rng(seed).random(len(p1))
    a, b = jref.weighted_umeyama(p1, p2, w), tref.weighted_umeyama(p1, p2, w)
    np.testing.assert_array_equal(a, b)
    # the pairs with depth give the transform back
    np.testing.assert_allclose(tref.weighted_umeyama(p1[4:], p2[4:], w[4:]),
                               T, atol=0.02)
    np.testing.assert_array_equal(tref.weighted_umeyama(p1[:2], p2[:2], w[:2]),
                                  np.eye(4))
    for xi in (np.zeros(6), np.random.default_rng(seed).normal(0, 0.4, 6)):
        np.testing.assert_array_equal(jref._se3_exp_g2o(xi),
                                      tref._se3_exp_g2o(xi))


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_only_ba_equals_reference(seed):
    cam, pcam = _cams()
    rng = np.random.default_rng(seed)
    n = 120
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(1, 3, n)], -1)
    T_true = jref._se3_exp_g2o(rng.normal(0, 0.02, 6))
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    uv += rng.normal(0, 0.4, uv.shape)
    uv[:10] += 40.0                                   # outliers
    ur = np.where(rng.random(n) > 0.3, uv[:, 0] - cam.bf / pc[:, 2], -1.0)
    a = jref.pose_only_ba(np.eye(4), pts, uv, ur, cam)
    b = tref.pose_only_ba(np.eye(4), pts, uv, ur, pcam)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2] and not b[1][:10].any()
    np.testing.assert_allclose(b[0][:3, 3], T_true[:3, 3], atol=0.01)

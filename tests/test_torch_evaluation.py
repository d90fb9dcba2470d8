"""Parity of the port's evaluation tooling (`utils/evaluation.py`) and of
`utils/metrics.py::xla_trace` with the JAX package, on the CPU, on the inputs
of tests/test_aux.py.

Tolerances: homographies to 1e-4 relative after the H[2,2] = 1
normalization (which removes the SVD's sign), reprojections to 1e-3 px;
RANSAC with the reference's draws injected: the same inlier mask and count;
masks and curves exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.utils import evaluation as jev
from aslam_tpu_torch.utils import evaluation as tev
from aslam_tpu_torch.utils import metrics as tmetrics

H_AFFINE = np.array([[1.1, 0.02, 5.0], [-0.03, 0.95, -3.0], [1e-4, -2e-4, 1.0]])
H_SHIFT = np.array([[1.0, 0.01, 8.0], [0.0, 1.05, -4.0], [0.0, 0.0, 1.0]])


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_apply_homography_matches_reference(rng):
    src = rng.uniform(0, 300, (40, 2)).astype(np.float32)
    ref = np.asarray(jev.apply_homography(jnp.asarray(H_AFFINE),
                                          jnp.asarray(src)))
    out = P.n(tev.apply_homography(torch.as_tensor(H_AFFINE, dtype=torch.float32),
                                   P.t(src)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("weights", ["ones", "random"])
def test_homography_dlt_matches_reference(rng, weights):
    src = rng.uniform(0, 300, (40, 2)).astype(np.float32)
    dst = np.asarray(jev.apply_homography(jnp.asarray(H_AFFINE),
                                          jnp.asarray(src)))
    dst = (dst + rng.normal(0, 0.3, dst.shape)).astype(np.float32)
    w = (np.ones(40) if weights == "ones" else rng.uniform(0.2, 1.0, 40)) \
        .astype(np.float32)
    Hj = np.asarray(jev.homography_dlt(jnp.asarray(src), jnp.asarray(dst),
                                       jnp.asarray(w)))
    Ht = P.n(tev.homography_dlt(P.t(src), P.t(dst), P.t(w)))
    np.testing.assert_allclose(Ht, Hj, rtol=1e-4, atol=1e-6)
    # the same reprojections
    pj = np.asarray(jev.apply_homography(jnp.asarray(Hj), jnp.asarray(src)))
    pt = P.n(tev.apply_homography(torch.from_numpy(Ht), P.t(src)))
    np.testing.assert_allclose(pt, pj, atol=1e-3)


def test_homography_dlt_exact_and_batched(rng):
    src = rng.uniform(0, 300, (3, 40, 2)).astype(np.float32)
    dst = P.n(tev.apply_homography(torch.as_tensor(H_AFFINE, dtype=torch.float32),
                                   P.t(src)))
    H = P.n(tev.homography_dlt(P.t(src), P.t(dst), torch.ones(3, 40)))
    assert H.shape == (3, 3, 3)
    for h in H:
        np.testing.assert_allclose(h, H_AFFINE, atol=1e-3)


def test_find_homography_ransac_matches_reference(rng):
    src = rng.uniform(0, 300, (100, 2)).astype(np.float32)
    dst = np.array(jev.apply_homography(jnp.asarray(H_SHIFT), jnp.asarray(src)))
    dst[70:] += rng.uniform(30, 80, (30, 2))
    dst = dst.astype(np.float32)
    valid = np.ones(100, bool)
    valid[95:] = False
    key = jax.random.PRNGKey(0)
    Hj, inl_j, n_j = jev.find_homography_ransac(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key)
    draws = np.asarray(jax.random.randint(key, (128, 4), 0, int(valid.sum())))
    Ht, inl_t, n_t = tev.find_homography_ransac(
        P.t(src), P.t(dst), P.t(valid), draws=P.t(draws))
    assert int(n_t) == int(n_j) >= 65
    np.testing.assert_array_equal(P.n(inl_t), np.asarray(inl_j))
    np.testing.assert_allclose(P.n(Ht), np.asarray(Hj), rtol=1e-3, atol=1e-5)
    # without draws: the port's own stream reaches the same consensus
    g = torch.Generator().manual_seed(0)
    _, inl_g, n_g = tev.find_homography_ransac(P.t(src), P.t(dst), P.t(valid),
                                               generator=g)
    assert int(n_g) == int(n_j)


def test_distance_filter_matches_reference(rng):
    src = rng.uniform(0, 300, (50, 2)).astype(np.float32)
    dst = np.asarray(jev.apply_homography(jnp.asarray(H_SHIFT),
                                          jnp.asarray(src))).copy()
    dst[::3] += rng.uniform(1.0, 6.0, (len(dst[::3]), 2))
    np.testing.assert_array_equal(
        tev.distance_filter(src, dst, H_SHIFT),
        jev.distance_filter(src, dst, H_SHIFT))


@pytest.mark.parametrize("kind", ["binary", "float"])
def test_recall_precision_curve_matches_reference(rng, kind):
    n = 60
    if kind == "binary":
        desc1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        desc2 = desc1.copy()
        flip = rng.integers(0, 2**32, (n, 8), dtype=np.uint32) \
            & rng.integers(0, 2**32, (n, 8), dtype=np.uint32) \
            & rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        desc2 ^= flip                                   # ~32 bits flipped
    else:
        desc1 = rng.normal(0, 1, (n, 128)).astype(np.float32)
        desc2 = (desc1 + rng.normal(0, 0.3, (n, 128))).astype(np.float32)
    xy1 = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    xy2 = (xy1 + rng.normal(0, 1.0, (n, 2))).astype(np.float32)
    xy2[:10] += 50.0                                    # wrong geometry
    tj, rj, pj = jev.recall_precision_curve(desc1, desc2, xy1, xy2, np.eye(3))
    tt, rt, pt = tev.recall_precision_curve(desc1, desc2, xy1, xy2, np.eye(3))
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(pt, pj)
    assert rt[-1] > 0.5


def test_xla_trace_is_the_profiler_trace(tmp_path):
    assert tmetrics.xla_trace is tmetrics.profiler_trace
    with tmetrics.xla_trace(str(tmp_path / "trace")):
        (torch.ones(32, 32) * 2).sum()
    assert list((tmp_path / "trace").rglob("*")), "no profiler output written"

"""Parity of the port's Hamming matcher with the JAX package: distance
matrices, the top-2 (`hamming_top2_plain`, the plain version of the CUDA
kernel) against the reference's default path (masked distance matrix +
lax.top_k) and against its Pallas kernel in interpret mode, the ratio match
and the duplicate resolution.  All exact: the distances are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import _torch_parity as P
from aslam_tpu.ops import hamming as jham
from aslam_tpu.ops import matching as jmatch
from aslam_tpu.ops import pallas_kernels
from aslam_tpu_torch.ops import hamming as tham
from aslam_tpu_torch.ops import matching as tmatch
from aslam_tpu_torch.ops.hamming_top2 import hamming_top2, hamming_top2_plain

INVALID = jham.INVALID_DIST


def make_case(kind, n=256, m=320, seed=0):
    """(desc_a, valid_a, desc_b, valid_b) as uint32 / bool numpy arrays."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    va = rng.random(n) > 0.1
    vb = rng.random(m) > 0.1
    if kind == "ties":
        # duplicated targets: equal minima at several indices
        b[10:20] = b[10]
        b[100:104] = b[10]
        a[:40] = b[10]
        a[40:60] = b[7] ^ np.uint32(1)          # distance 1 to target 7
        b[200:210] = b[7]
    elif kind == "near":
        # queries near targets so that distances are small and the ratio
        # test passes for many rows (a realistic match pool)
        src = rng.integers(0, m, n)
        flips = rng.integers(0, 2**32, (n, 8), dtype=np.uint32) \
            & rng.integers(0, 2**32, (n, 8), dtype=np.uint32) \
            & rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        a = b[src] ^ flips
        a[:30] = b[src[:30]]
        b[50:60] = b[src[0]]                   # duplicate claims
    elif kind == "no_valid_targets":
        vb[:] = False
    elif kind == "one_valid_target":
        vb[:] = False
        vb[17] = True
    elif kind == "no_valid_queries":
        va[:] = False
    return a, va, b, vb


KINDS = ["random", "ties", "near", "no_valid_targets", "one_valid_target",
         "no_valid_queries"]


def _ref_top2(a, va, b, vb):
    d = jham.masked_distance_matrix(*(jnp.asarray(x) for x in (a, va, b, vb)))
    neg, idx = lax.top_k(-d, 2)
    return np.asarray(-neg[:, 0]), np.asarray(idx[:, 0]), np.asarray(-neg[:, 1])


def test_distance_matrices_match_popcount_reference():
    a, _, b, _ = make_case("ties")
    ref = np.asarray(jham.distance_matrix_popcount(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(P.n(tham.distance_matrix(P.t(a), P.t(b))), ref)
    np.testing.assert_array_equal(
        P.n(tham.distance_matrix_popcount(P.t(a), P.t(b))), ref)
    np.testing.assert_array_equal(
        P.n(tham.signs_from_packed(P.t(a))),
        np.asarray(jham.signs_from_packed(jnp.asarray(a)), np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_top2_plain_matches_reference_default_path(kind):
    a, va, b, vb = make_case(kind)
    rd1, ri1, rd2 = _ref_top2(a, va, b, vb)
    d1, i1, d2 = hamming_top2_plain(P.t(a), P.t(va), P.t(b), P.t(vb))
    assert d1.dtype == torch.float32 and i1.dtype == torch.int32
    np.testing.assert_array_equal(P.n(d1), rd1)
    np.testing.assert_array_equal(P.n(i1), ri1)
    np.testing.assert_array_equal(P.n(d2), rd2)
    # the wrapper takes the plain version for CPU tensors
    w = hamming_top2(P.t(a), P.t(va), P.t(b), P.t(vb))
    for x, y in zip(w, (d1, i1, d2)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["random", "ties", "one_valid_target"])
def test_top2_plain_agrees_with_pallas_kernel(kind):
    a, va, b, vb = make_case(kind)
    pd1, pi1, pd2 = (np.asarray(x) for x in pallas_kernels.hamming_top2(
        *(jnp.asarray(x) for x in (a, va, b, vb)), interpret=True))
    d1, i1, d2 = (P.n(x) for x in hamming_top2_plain(P.t(a), P.t(va),
                                                      P.t(b), P.t(vb)))
    real = d1 < INVALID
    np.testing.assert_array_equal(d1[real], pd1[real])
    both = real & (d2 < INVALID)
    np.testing.assert_array_equal(d2[both], pd2[both])
    unique = real & (d2 > d1)
    np.testing.assert_array_equal(i1[unique], pi1[unique])


@pytest.mark.parametrize("kind", ["random", "ties", "near"])
def test_knn_ratio_match_and_dedup_match_reference(kind):
    a, va, b, vb = make_case(kind)
    jm = jmatch.knn_ratio_match(*(jnp.asarray(x) for x in (a, va, b, vb)),
                                ratio=0.9, max_dist=100.0)
    tm = tmatch.knn_ratio_match(P.t(a), P.t(va), P.t(b), P.t(vb),
                                ratio=0.9, max_dist=100.0)
    for x, y in zip(tm, jm):
        np.testing.assert_array_equal(P.n(x), np.asarray(y))
    jr = jmatch.resolve_duplicates(jm, b.shape[0])
    tr = tmatch.resolve_duplicates(tm, b.shape[0])
    for x, y in zip(tr, jr):
        np.testing.assert_array_equal(P.n(x), np.asarray(y))
    if kind == "near":
        assert P.n(tm.valid).sum() > 100
        assert P.n(tr.valid).sum() < P.n(tm.valid).sum()   # dedup did work


def test_hamming_top2_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hamming_top2 kernel has no CPU mode")
    for kind in KINDS:
        a, va, b, vb = make_case(kind, n=1024, m=1024)
        args = [P.t(x).cuda() for x in (a, va, b, vb)]
        before = hamming_top2.launches
        out = hamming_top2(*args)
        torch.cuda.synchronize()
        assert hamming_top2.launches == before + 1
        for x, y in zip(out, hamming_top2_plain(*args)):
            assert torch.equal(x, y), kind

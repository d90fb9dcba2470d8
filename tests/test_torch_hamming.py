"""Parity of the port's Hamming matcher with the JAX package: distance
matrices, the top-2 (`hamming_top2_plain`, the plain version of the CUDA
kernel) against the reference's default path (masked distance matrix +
lax.top_k) and against its Pallas kernel in interpret mode, the ratio match
and the duplicate resolution.  All exact: the distances are integers."""

import re
from pathlib import Path

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
from aslam_tpu_torch.ops import hamming_top2 as top2_mod
from aslam_tpu_torch.ops.hamming_top2 import (hamming_top2, hamming_top2_bound,
                                              hamming_top2_plain)

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
    elif kind == "all_equal":
        b[:] = b[0]
        a[: n // 2] = b[0]
        vb[:] = True
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


@pytest.mark.cuda
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


@pytest.mark.parametrize("kind", ["random", "ties", "one_valid_target"])
def test_top2_with_second_index_matches_reference(kind):
    """`_top2` with its second index, ties to the lowest index as in
    `lax.top_k`."""
    a, va, b, vb = make_case(kind)
    d = jham.masked_distance_matrix(*(jnp.asarray(x) for x in (a, va, b, vb)))
    ref = jmatch._top2(d)
    out = tmatch._top2(P.t(np.asarray(d)))
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(P.n(x), np.asarray(y))


@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_compact_candidates_matches_reference(density):
    rng = np.random.default_rng(5)
    cand = rng.random(3000) < density
    for cap in (1, 64, 1024, 4096):
        ref = jmatch.compact_candidates(jnp.asarray(cand), cap)
        out = tmatch.compact_candidates(P.t(cand), cap)
        for x, y in zip(out, ref):
            np.testing.assert_array_equal(P.n(x), np.asarray(y))


@pytest.mark.parametrize("ratio,ties", [(0.8, False), (0.8, True),
                                        (1.0, True)])
def test_projection_match_matches_reference(ratio, ties):
    """320 landmarks, 256 features each a noisy copy of one landmark's
    descriptor and predicted within a few pixels of it, plus decoys; bound
    features excluded; with `ties`, duplicated features give equal
    distances for the ratio test and the per-feature conflict."""
    rng = np.random.default_rng(6)
    L, N = 320, 256
    lm = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
    owner = rng.permutation(L)[:N]
    flips = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    for _ in range(3):
        flips &= rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    kp = lm[owner] ^ flips
    kp_xy = rng.uniform(0, [320, 240], (N, 2)).astype(np.float32)
    if ties:
        kp[1:60:2] = kp[0:60:2]
        kp_xy[1:60:2] = kp_xy[0:60:2] + 1.0
        lm[owner[100:110]] = lm[owner[90:100]]
    pred = rng.uniform(0, [320, 240], (L, 2)).astype(np.float32)
    pred[owner] = kp_xy + rng.normal(0, 2, (N, 2))
    octave = rng.integers(0, 3, N).astype(np.int32)
    args = (lm, rng.random(L) > 0.05, pred, kp_xy, kp, rng.random(N) > 0.05,
            octave, rng.random(N) > 0.2)
    kw = dict(radius=8.0, th_high=100.0, ratio=ratio)
    ref = jmatch.projection_match(*(jnp.asarray(x) for x in args), **kw)
    out = tmatch.projection_match(*(P.t(x) for x in args), **kw)
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(P.n(x), np.asarray(y))
    assert int(np.asarray(ref.valid).sum()) > 100


# --- the CUDA kernel's partition and merge, modelled in numpy ---------------

_NO_KEY = np.uint32(0xFFFFFFFF)


def _merge_pairs(k1, k2):
    """The kernel's merge of (k1 <= k2) key pairs along the last axis: m1 the
    least first key, m2 the least of the winner's second key and the others'
    first keys (keys other than _NO_KEY are distinct)."""
    m1 = k1.min(axis=-1)
    m2 = np.where(k1 == m1[..., None], k2, k1).min(axis=-1)
    return m1, m2


def partition_model(a, va, b, vb):
    """What csrc/hamming_top2.cu computes, in its order.  Of every CHUNK =
    WARPS * 32 targets warp w takes the groups of GROUP = 16 targets w and w +
    WARPS; within a group, lane g of the 8 that share a query row takes
    targets g and g + 8.  A thread keeps the two least keys (distance <<
    KEY_SHIFT | index, MASKED added to the distance of a target that is
    masked or beyond the end) of what it takes; the 8 lanes merge pairwise in
    three exchange steps, then the WARPS warps by the rule of `_merge_pairs`;
    the row's result is decoded from the two keys left."""
    M = top2_mod
    n, m = len(a), len(b)
    chunks = -(-m // M.CHUNK)
    steps = M.CHUNK // (M.GROUP * M.WARPS)
    x = a[:, None, :] ^ b[None, :, :]
    dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.uint32)
    # beyond the end the kernel scores what shared memory happens to hold
    dist = np.concatenate([dist, np.full((n, chunks * M.CHUNK - m), 77, np.uint32)], axis=1)
    masked = np.concatenate([~vb, np.ones(chunks * M.CHUNK - m, bool)])
    jpen = np.arange(chunks * M.CHUNK, dtype=np.uint32) \
        | np.where(masked, M.MASKED << M.KEY_SHIFT, 0).astype(np.uint32)
    keys = (dist << np.uint32(M.KEY_SHIFT)) + jpen
    # target c * CHUNK + (s * WARPS + w) * GROUP + 8 * h + g -> [c, s, w, h, g]
    keys = keys.reshape(n, chunks, steps, M.WARPS, 2, 8)
    k1 = np.full((n, M.WARPS, 8), _NO_KEY)
    k2 = k1.copy()
    for c in range(chunks):
        for s in range(steps):
            for h in range(2):
                key = keys[:, c, s, :, h, :]
                k2 = np.minimum(k2, np.maximum(k1, key))
                k1 = np.minimum(k1, key)
    for step in (1, 2, 4):          # lane g exchanges with lane g ^ step
        other = np.arange(8) ^ step
        o1, o2 = k1[..., other], k2[..., other]
        k1, k2 = np.minimum(k1, o1), np.minimum(np.maximum(k1, o1), np.minimum(k2, o2))
    assert (k1 == k1[..., :1]).all() and (k2 == k2[..., :1]).all()
    m1, m2 = _merge_pairs(k1[..., 0], k2[..., 0])
    d1, d2 = (m1 >> M.KEY_SHIFT).astype(np.int64), (m2 >> M.KEY_SHIFT).astype(np.int64)
    found = va & (d1 < M.MASKED)
    i1 = np.where(found, m1 & np.uint32(M.MAX_TARGETS - 1), 0).astype(np.int32)
    return (np.where(found, d1, INVALID).astype(np.float32), i1,
            np.where(found & (d2 < M.MASKED), d2, INVALID).astype(np.float32))


@pytest.mark.parametrize("kind,n,m", [
    ("random", 40, 320), ("ties", 64, 320), ("all_equal", 24, 1100),
    ("one_valid_target", 24, 600), ("no_valid_targets", 9, 513),
    ("no_valid_queries", 9, 511), ("ties", 64, 1025), ("random", 5, 3),
    ("random", 3, 1), ("one_valid_target", 8, 18)])
def test_kernel_partition_model_equals_plain(kind, n, m):
    """The kernel's split of the targets over lanes, warps and chunks and its
    merge order give the plain version's outputs exactly, ties and masks
    included, for target counts that are no multiple of the partition."""
    a, va, b, vb = make_case(kind, n=n, m=m, seed=3)
    d1, i1, d2 = partition_model(a, va, b, vb)
    if m == 1:      # the plain version sorts two values: add a masked target
        b, vb = np.concatenate([b, b]), np.concatenate([vb, [False]])
    ref = hamming_top2_plain(P.t(a), P.t(va), P.t(b), P.t(vb))
    np.testing.assert_array_equal(d1, P.n(ref[0]))
    np.testing.assert_array_equal(i1, P.n(ref[1]))
    np.testing.assert_array_equal(d2, P.n(ref[2]))
    if kind in ("ties", "all_equal"):
        assert (d1 == d2)[va].any()


def test_wrapper_constants_equal_the_kernel_source():
    src = (Path(top2_mod.__file__).parent.parent / "csrc" / "hamming_top2.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(const["kTileRows"]) == top2_mod.TILE_ROWS
    assert int(const["kGroup"]) == top2_mod.GROUP
    assert int(const["kWarps"]) == top2_mod.WARPS
    assert const["kThreads"] == "kWarps * 32" and const["kChunk"] == "kThreads"
    assert top2_mod.CHUNK == top2_mod.WARPS * 32
    assert int(const["kSlots"]) == top2_mod.SLOTS
    assert int(const["kKeyShift"]) == top2_mod.KEY_SHIFT
    assert int(const["kMasked"]) == top2_mod.MASKED
    # the slots fit the 227 KB of shared memory a block may have, beside the
    # barriers and the block's partial results
    partial = top2_mod.TILE_ROWS * top2_mod.WARPS * 8
    assert top2_mod.SLOTS * top2_mod.CHUNK * 32 + partial + 1024 <= 232448


@pytest.mark.parametrize("n,m,popc,nbytes,bound_us,popc_us", [
    (1024, 1024, 8388608, 79872, 0.05478, 2.0),
    (8192, 8192, 536870912, 638976, 3.506, 128.4),
    (1024, 16384, 134217728, 586752, 0.8765, 32.1),
    (8192, 1024, 67108864, 402432, 0.4383, 16.05)])
def test_hamming_top2_bound(n, m, popc, nbytes, bound_us, popc_us):
    bound = hamming_top2_bound(n, m)
    assert bound["popc"] == popc == n * m * 8
    assert bound["mma_ops"] == 2 * n * m * 256
    assert bound["bytes"] == nbytes == 33 * (n + m) + 12 * n
    assert bound["bound_by"] == "mma"
    assert bound["bound_us"] == pytest.approx(bound_us, rel=1e-3)
    assert bound["bound_us"] == bound["mma_ops"] / top2_mod.MMA_OPS_PER_S * 1e6
    # the 1-bit rate is a measured one, above the data sheet's int8 rate
    assert top2_mod.MMA_OPS_PER_S == 9800e12 > 1979e12
    assert bound["popc_us"] == pytest.approx(popc_us, abs=0.05)
    assert bound["popc_us"] == popc / (132 * 16 * 1.98e9) * 1e6


def test_hamming_top2_bound_by_bytes_when_one_side_is_tiny():
    bound = hamming_top2_bound(1, 1)
    assert bound["bound_by"] == "bytes" and bound["popc"] == 8
    assert bound["bound_us"] == bound["bytes"] / 3.35e12 * 1e6


@pytest.mark.parametrize("kind", ["random", "no_valid_targets"])
def test_wrapper_on_cpu_returns_plain_tensors_with_documented_types(kind):
    a, va, b, vb = make_case(kind, n=33, m=70)
    out = hamming_top2(P.t(a), P.t(va), P.t(b), P.t(vb))
    ref = hamming_top2_plain(P.t(a), P.t(va), P.t(b), P.t(vb))
    assert [x.dtype for x in out] == [torch.float32, torch.int32, torch.float32]
    assert [tuple(x.shape) for x in out] == [(33,)] * 3
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


def test_bench_inputs_hold_masks_and_tied_minima():
    """`bench_top2.top2_inputs`, the timed and checked inputs of the kernel on
    the card: the documented shapes and types, a tenth masked, and tied
    minima (d2 == d1) among the rows of the plain version's result."""
    from aslam_tpu_torch.kernels.bench_top2 import top2_inputs

    a, va, b, vb = top2_inputs(np.random.default_rng(0), "cpu", 128, 600)
    assert (a.dtype, va.dtype, b.dtype, vb.dtype) == (torch.int32, torch.bool) * 2
    assert a.shape == (128, 8) and b.shape == (600, 8)
    assert va.shape == (128,) and vb.shape == (600,)
    assert 0 < int((~va).sum()) < 40 and 0 < int((~vb).sum()) < 120
    d1, _, d2 = hamming_top2_plain(a, va, b, vb)
    assert int(((d1 == d2) & va).sum()) >= 32


@pytest.mark.parametrize("kind", ["random", "ties", "near"])
def test_window_match_matches_reference(kind):
    """`window_match` (spatially windowed ratio match + dedup), exact."""
    a, va, b, vb = make_case(kind, n=96, m=120)
    rng = np.random.default_rng(7)
    uv_a = rng.uniform(0, 160, (len(a), 2)).astype(np.float32)
    uv_b = rng.uniform(0, 160, (len(b), 2)).astype(np.float32)
    h = len(a) // 2
    uv_b[:h] = uv_a[:h] + rng.uniform(-4, 4, (h, 2))
    # the first half of the targets: the queries with a few bits flipped
    b[:h] = a[:h] ^ (rng.integers(0, 2**32, (h, 8), dtype=np.uint32)
                     & rng.integers(0, 2**32, (h, 8), dtype=np.uint32)
                     & rng.integers(0, 2**32, (h, 8), dtype=np.uint32)
                     & rng.integers(0, 2**32, (h, 8), dtype=np.uint32))
    args = dict(radius=12.0, max_dist=100.0, ratio=0.9)
    mj = jmatch.window_match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(uv_a),
                             jnp.asarray(b), jnp.asarray(vb), jnp.asarray(uv_b),
                             **args)
    mt = tmatch.window_match(P.t(a), P.t(va), P.t(uv_a), P.t(b), P.t(vb),
                             P.t(uv_b), **args)
    np.testing.assert_array_equal(P.n(mt.target_idx), np.asarray(mj.target_idx))
    np.testing.assert_array_equal(P.n(mt.valid), np.asarray(mj.valid))
    np.testing.assert_array_equal(P.n(mt.distance), np.asarray(mj.distance))
    assert P.n(mt.valid).any()


def test_window_match_finds_twins_in_window():
    rng = np.random.default_rng(0)
    n = 12
    d1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    uv1 = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    uv2 = uv1 + rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    uv2[4] = uv1[4] + 100.0                                # out of window
    m = tmatch.window_match(P.t(d1), torch.ones(n, dtype=torch.bool), P.t(uv1),
                            P.t(d1), torch.ones(n, dtype=torch.bool), P.t(uv2),
                            radius=10.0, max_dist=64.0, ratio=0.9)
    idx = P.n(m.target_idx)
    assert idx[4] == -1
    good = [i for i in range(n) if i != 4]
    assert (idx[good] == np.asarray(good)).mean() > 0.8

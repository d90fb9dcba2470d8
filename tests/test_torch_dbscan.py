"""Parity of the port's DBSCAN declustering (`ops/dbscan.py`) with the JAX
package, on the CPU, on the point sets of tests/test_aux.py and on random
ones: labels and surviving masks exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as P
from aslam_tpu.ops import dbscan as jdb
from aslam_tpu_torch.ops import dbscan as tdb


def _clusters_and_noise(rng):
    return np.concatenate([
        rng.normal([50, 50], 2.0, (20, 2)),
        rng.normal([150, 100], 2.0, (15, 2)),
        [[10, 200], [300, 20], [200, 220]],
    ]).astype(np.float32)


def _chain(rng):
    blob1 = rng.normal([20, 20], 1.5, (12, 2))
    blob2 = rng.normal([60, 20], 1.5, (12, 2))
    chain = np.stack([np.linspace(22, 58, 10), np.full(10, 20.0)], -1)
    return np.concatenate([blob1, blob2, chain, chain + [0.5, 0.5]]) \
        .astype(np.float32)


def _random(rng, n=200):
    return rng.uniform(0, 160, (n, 2)).astype(np.float32)


SETS = {"clusters": (_clusters_and_noise, 10.0, 3),
        "chain": (_chain, 6.0, 3),
        "random": (_random, 10.0, 2)}


@pytest.mark.parametrize("name", sorted(SETS))
def test_dbscan_labels_match_reference(name):
    make, eps, min_pts = SETS[name]
    rng = np.random.default_rng(0)
    pts = make(rng)
    valid = rng.uniform(size=len(pts)) > 0.1
    ref = np.asarray(jdb.dbscan_labels(jnp.asarray(pts), jnp.asarray(valid),
                                       eps=eps, min_pts=min_pts))
    out = P.n(tdb.dbscan_labels(P.t(pts), P.t(valid), eps=eps,
                                min_pts=min_pts))
    np.testing.assert_array_equal(out, ref)
    assert (ref >= 0).any() and (ref == -1).any()


def test_dbscan_clusters_and_noise():
    rng = np.random.default_rng(0)
    pts = _clusters_and_noise(rng)
    labels = P.n(tdb.dbscan_labels(P.t(pts), P.t(np.ones(len(pts), bool)),
                                   eps=10.0, min_pts=3))
    assert len(np.unique(labels[:20])) == 1 and labels[0] >= 0
    assert len(np.unique(labels[20:35])) == 1 and labels[20] >= 0
    assert labels[0] != labels[20]
    assert (labels[35:] == -1).all()


@pytest.mark.parametrize("keep", [1, 2])
@pytest.mark.parametrize("name", sorted(SETS))
def test_decluster_matches_reference(name, keep):
    make, eps, min_pts = SETS[name]
    rng = np.random.default_rng(1)
    pts = make(rng)
    resp = rng.uniform(0, 100, len(pts)).astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.1
    ref = np.asarray(jdb.decluster(jnp.asarray(pts), jnp.asarray(resp),
                                   jnp.asarray(valid), eps=eps,
                                   min_pts=min_pts, keep_per_cluster=keep))
    out = P.n(tdb.decluster(P.t(pts), P.t(resp), P.t(valid), eps=eps,
                            min_pts=min_pts, keep_per_cluster=keep))
    np.testing.assert_array_equal(out, ref)


def test_decluster_keeps_strongest():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal([50, 50], 2.0, (10, 2)),
                          [[200, 200]]]).astype(np.float32)
    keep = P.n(tdb.decluster(P.t(pts), P.t(np.arange(11, dtype=np.float32)),
                             P.t(np.ones(11, bool)), eps=10.0, min_pts=2,
                             keep_per_cluster=1))
    assert keep[9] and not keep[:9].any() and keep[10]


def test_searchsorted_scan_matches_jnp():
    rng = np.random.default_rng(2)
    for n in (1, 2, 7, 64, 100):
        arr = np.sort(rng.integers(-1, 20, n)).astype(np.int32)
        arr[-n // 3:] = -1           # unsorted tails, as decluster makes
        q = rng.integers(-2, 22, 50).astype(np.int32)
        np.testing.assert_array_equal(
            P.n(tdb._searchsorted_scan(P.t(arr), P.t(q))),
            np.asarray(jnp.searchsorted(jnp.asarray(arr), jnp.asarray(q))))

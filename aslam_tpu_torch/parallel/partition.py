"""Covisibility-aware keyframe placement for distributed BA.

Port of `aslam_tpu/parallel/partition.py`.  The sharded solvers
(parallel/sharded_global_ba.py, parallel/sharded_gn_cg.py) give each rank a
contiguous range of keyframe rows: right for corridor trajectories, wrong
for revisit-heavy maps where temporally distant keyframes are strongly
covisible (loops, multi-sequence sessions).

This module computes the general placement: a greedy graph-growing
partitioner (Karypis-style GGGP seed-and-grow, host-side numpy; placement
is an O(K^2) one-off decision per BA epoch) that returns a row permutation
grouping each rank's keyframes contiguously.  Every sharded solver reduces
all cross-rank coupling with the same all-reduce, so a row permutation
changes no math, only how much of the coupling mass stays on one rank.

Every rank computes the same permutation: the covisibility counts are
integers of the same replicated map, and the partitioner is deterministic.
Landmark arrays are untouched: lm_first_kf stores insertion ids, not row
indices, and the solvers read no observer index, so permuting keyframe rows
is free.
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch.device import to_host
from aslam_tpu_torch.models.mapstate import MapState, covisibility
from aslam_tpu_torch.ops.global_ba import _KF_FIELDS
from aslam_tpu_torch.parallel.sharded_global_ba import (pad_map_for_mesh,
                                                        sharded_global_ba)
from aslam_tpu_torch.parallel.sharded_gn_cg import sharded_gn_cg_step


def covisibility_weights(m: MapState) -> np.ndarray:
    """[K,K] float64 shared-landmark counts on the host (incidence products
    on the device, one read)."""
    return to_host(covisibility(m)).astype(np.float64)


def partition_keyframes(
    W: np.ndarray, kf_valid: np.ndarray, n_shards: int
) -> np.ndarray:
    """Greedy graph-growing partition of K keyframe rows into n_shards
    equal blocks.  Returns perm [K] int32 with new row i = old row perm[i];
    rows [s*K/n, (s+1)*K/n) of the permuted map belong to shard s.

    Algorithm (GGGP): per shard, seed with the unassigned valid KF of
    maximum remaining degree, then repeatedly absorb the unassigned KF with
    the strongest connection to the shard until the shard reaches capacity.
    Invalid (tombstoned/padding) rows carry no edges and backfill evenly.
    """
    K = W.shape[0]
    if K % n_shards:
        raise ValueError(f"K={K} not divisible by n_shards={n_shards}")
    cap = K // n_shards
    valid = np.asarray(kf_valid, bool)
    W = np.where(valid[:, None] & valid[None, :], W, 0.0)

    unassigned = valid.copy()
    shards: list[list[int]] = []
    degree = W.sum(axis=1)
    for _ in range(n_shards):
        members: list[int] = []
        conn = np.zeros(K)  # connection strength to current shard
        while len(members) < cap and unassigned.any():
            cand = np.where(unassigned, conn, -1.0)
            best = int(np.argmax(cand))
            if cand[best] <= 0.0:
                # no connected candidate: reseed at max remaining degree
                best = int(np.argmax(np.where(unassigned, degree, -1.0)))
            members.append(best)
            unassigned[best] = False
            conn += W[:, best]
        shards.append(members)

    # backfill invalid rows round-robin into shards with free capacity
    spare = [i for i in range(K) if not valid[i]]
    it = iter(spare)
    for members in shards:
        while len(members) < cap:
            members.append(next(it))
    perm = np.concatenate([np.asarray(s, np.int64) for s in shards])
    if len(np.unique(perm)) != K:
        raise AssertionError("partition is not a permutation")
    return perm.astype(np.int32)


def contiguous_assignment(K: int, n_shards: int) -> np.ndarray:
    """[K] shard id under the default contiguous-range placement."""
    return (np.arange(K) * n_shards) // K


def edge_cut_fraction(W: np.ndarray, shard_of: np.ndarray) -> float:
    """Fraction of covisibility mass crossing shard boundaries (0 = all
    coupling stays on one rank; the quantity the all-reduce traffic of
    cross-rank edges scales with)."""
    total = W.sum()
    if total == 0:
        return 0.0
    cross = W * (shard_of[:, None] != shard_of[None, :])
    return float(cross.sum() / total)


def shard_of_from_perm(perm: np.ndarray, n_shards: int) -> np.ndarray:
    """[K] shard id per OLD row index implied by a row permutation."""
    K = len(perm)
    shard = np.empty(K, np.int64)
    shard[perm] = contiguous_assignment(K, n_shards)
    return shard


def permute_kf_rows(m: MapState, perm: np.ndarray) -> MapState:
    """Reorder keyframe rows: new row i = old row perm[i]."""
    idx = torch.as_tensor(np.asarray(perm, np.int64),
                          device=m.kf_T_cw.device)
    return m._replace(**{f: getattr(m, f)[idx] for f in _KF_FIELDS})


def _placed(m: MapState, mesh, W: np.ndarray | None):
    """The map padded to the mesh, its covisibility placement and the
    inverse permutation -> (permuted map, inv)."""
    padded = pad_map_for_mesh(m, mesh)
    if W is None:
        W = covisibility_weights(padded)
    perm = partition_keyframes(W, to_host(padded.kf_valid), mesh.size)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return permute_kf_rows(padded, perm), inv


def _restored(m: MapState, out: MapState, inv: np.ndarray) -> MapState:
    """The solved poses and points back in the caller's row order and
    capacities."""
    restored = permute_kf_rows(out, inv)
    K0 = m.kf_T_cw.shape[0]
    L0 = m.lm_pos.shape[0]
    return m._replace(kf_T_cw=restored.kf_T_cw[:K0],
                      lm_pos=restored.lm_pos[:L0])


def partitioned_gn_cg_step(m: MapState, cam, cfg, mesh,
                           W: np.ndarray | None = None, **kwargs):
    """`sharded_gn_cg_step` with covisibility-aware placement: permute
    keyframe rows so each rank's contiguous shard is a covisibility
    cluster, run the distributed joint GN-CG step, restore the original row
    order.  The same result as the unpermuted solve up to float
    reassociation (kf_id rides the permutation, so the gauge anchor is the
    same keyframe).  Pass a precomputed `W` (e.g. from a prior epoch) to
    skip the covisibility products.  Call on every rank with the same map."""
    placed, inv = _placed(m, mesh, W)
    out, stats = sharded_gn_cg_step(placed, cam, cfg, mesh, **kwargs)
    return _restored(m, out, inv), stats


def partitioned_global_ba(m: MapState, cam, cfg, mesh, **kwargs):
    """`sharded_global_ba` with covisibility-aware placement: permute,
    solve, restore the row order.  The same result as the unpermuted solve
    (the all-reduce couples all shards); only the cross-rank share of the
    coupling changes."""
    placed, inv = _placed(m, mesh, None)
    out, chi2 = sharded_global_ba(placed, cam, cfg, mesh, **kwargs)
    return _restored(m, out, inv), chi2

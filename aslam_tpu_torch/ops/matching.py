"""Correspondence search: 2-NN ratio matching, guided projection matching,
duplicate resolution and candidate compaction.

Port of `aslam_tpu/ops/matching.py`.  For packed binary descriptors the
top-2 of `knn_ratio_match` goes through `ops/hamming_top2.py`: the CUDA
kernel for tensors on the card, the plain version for CPU tensors.  Float
(SIFT-family) descriptors take the L2 distance matrix and `_top2`, as in the
JAX package, and never the kernel.  `projection_match` and `window_match`
need a per-pair window mask, so they stay the reference's distance matrix
plus `_top2`.  `-1` marks "no match".

`knn_ratio_match` and `resolve_duplicates` take a leading batch axis
([B, Q] rows of B independent frame pairs, batched VO): one kernel launch
for the batch, and one scatter whose lanes claim disjoint ranges.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from aslam_tpu_torch.ops.hamming import (INVALID_DIST, is_packed,
                                         masked_distance_matrix)
from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
from aslam_tpu_torch.ops.index import nonzero_static


class Matches(NamedTuple):
    """Fixed-size match set: for each query row, index into the target set."""

    target_idx: torch.Tensor  # [Q] int32, -1 = unmatched
    distance: torch.Tensor    # [Q] float32
    valid: torch.Tensor       # [Q] bool


def _top2(d: torch.Tensor):
    """Row-wise two smallest distances of [..., Q, T] -> (d1, i1, d2, i2),
    in the order of `lax.top_k(-d, 2)`: i1 the lowest index of the minimum,
    i2 the lowest other index of the next value (torch.argmin returns the
    first minimum)."""
    i1 = torch.argmin(d, dim=-1, keepdim=True)
    d1 = torch.gather(d, -1, i1)[..., 0]
    rest = d.scatter(-1, i1, float("inf"))
    i2 = torch.argmin(rest, dim=-1, keepdim=True)
    d2 = torch.gather(rest, -1, i2)[..., 0]
    i1, i2 = i1[..., 0], i2[..., 0]
    return d1, i1.to(torch.int32), d2, i2.to(torch.int32)


def knn_ratio_match(
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_t: torch.Tensor,
    ratio: float,
    max_dist: float = 256.0,
) -> Matches:
    """Lowe-ratio 2-NN matching, query rows -> target columns."""
    if is_packed(desc_q):
        d1, i1, d2 = hamming_top2(desc_q, valid_q, desc_t, valid_t)
    else:
        d1, i1, d2, _ = _top2(masked_distance_matrix(desc_q, valid_q, desc_t,
                                                     valid_t))
    ok = valid_q & (d1 <= max_dist) & (d1 < ratio * d2) & (d1 < INVALID_DIST)
    return Matches(target_idx=torch.where(ok, i1, torch.full_like(i1, -1)),
                   distance=d1, valid=ok)


def resolve_duplicates(matches: Matches, n_targets: int) -> Matches:
    """Keep only the lowest-distance query per claimed target index: a
    scatter-min over the key (distance, query index) elects one winner per
    target deterministically.  Batched matches [..., Q] claim targets of
    their own lane."""
    lead = matches.target_idx.shape[:-1]
    q = matches.target_idx.shape[-1]
    dev = matches.distance.device
    key = matches.distance * (q + 1) + torch.arange(q, dtype=torch.float32,
                                                    device=dev)
    tgt = torch.where(matches.valid, matches.target_idx,
                      torch.full_like(matches.target_idx, n_targets)).long()
    # lane b's targets (and its padding slot) at b * (n_targets + 1) onwards
    n_lanes = math.prod(lead)
    lane = torch.arange(n_lanes, device=dev).reshape(lead + (1,))
    tgt = (tgt + lane * (n_targets + 1)).reshape(-1)
    best = torch.full((n_lanes * (n_targets + 1),), float("inf"),
                      dtype=torch.float32, device=dev).scatter_reduce(
        0, tgt, key.reshape(-1), "amin")
    win = matches.valid & (key <= best[tgt].reshape(key.shape))
    return Matches(
        target_idx=torch.where(win, matches.target_idx,
                               torch.full_like(matches.target_idx, -1)),
        distance=matches.distance,
        valid=win,
    )


def compact_candidates(cand: torch.Tensor, cap: int):
    """Indices of up to `cap` True entries of `cand`, lowest first.
    -> (idx [cap] int64 (0 where unused), valid [cap] bool, n_overflow
    scalar int32 = candidates dropped)."""
    idx = nonzero_static(cand, cap, 0)
    n_cand = torch.sum(cand.to(torch.int32))
    valid = torch.arange(cap, device=cand.device) < n_cand
    return idx, valid, torch.clamp(n_cand - cap, min=0)


def projection_match(
    lm_desc: torch.Tensor,      # [L,8] int32 landmark descriptors
    lm_valid: torch.Tensor,     # [L] bool
    pred_uv: torch.Tensor,      # [L,2] predicted pixel location
    kp_xy: torch.Tensor,        # [N,2] feature pixel coords
    kp_desc: torch.Tensor,      # [N,8] int32
    kp_valid: torch.Tensor,     # [N] bool
    kp_octave: torch.Tensor,    # [N] int32
    kp_free: torch.Tensor,      # [N] bool: not already bound to a landmark
    radius: float,
    th_high: float,
    ratio: float,
) -> Matches:
    """Guided landmark -> feature search: the best descriptor distance among
    features inside a `radius` box around the predicted projection, if <=
    th_high, rejected when the two best lie on the same pyramid level and
    fail the ratio test; conflicting claims on one feature go to the lowest
    distance."""
    N = kp_desc.shape[0]
    dx = pred_uv[:, 0:1] - kp_xy[None, :, 0]
    dy = pred_uv[:, 1:2] - kp_xy[None, :, 1]
    in_window = (torch.abs(dx) < radius) & (torch.abs(dy) < radius)
    d = masked_distance_matrix(lm_desc, lm_valid, kp_desc, kp_valid & kp_free)
    d = torch.where(in_window, d, torch.full_like(d, INVALID_DIST))
    d1, i1, d2, i2 = _top2(d)
    lvl1 = kp_octave[i1.long()]
    lvl2 = kp_octave[i2.long()]
    has2 = d2 < INVALID_DIST
    ratio_reject = has2 & (lvl1 == lvl2) & (d1 > ratio * d2)
    ok = lm_valid & (d1 <= th_high) & ~ratio_reject
    m = Matches(target_idx=torch.where(ok, i1, torch.full_like(i1, -1)),
                distance=d1, valid=ok)
    return resolve_duplicates(m, N)


def window_match(
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    uv_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_t: torch.Tensor,
    uv_t: torch.Tensor,
    radius: float,
    max_dist: float,
    ratio: float,
) -> Matches:
    """Spatially windowed 2-NN ratio match: each query's targets are those
    within a `radius` box around its pixel; duplicates resolved."""
    d = masked_distance_matrix(desc_q, valid_q, desc_t, valid_t)
    dx = uv_q[:, 0:1] - uv_t[None, :, 0]
    dy = uv_q[:, 1:2] - uv_t[None, :, 1]
    d = torch.where((torch.abs(dx) < radius) & (torch.abs(dy) < radius), d,
                    torch.full_like(d, INVALID_DIST))
    d1, i1, d2, _ = _top2(d)
    ok = valid_q & (d1 <= max_dist) & (d1 < ratio * d2)
    m = Matches(target_idx=torch.where(ok, i1, torch.full_like(i1, -1)),
                distance=d1, valid=ok)
    return resolve_duplicates(m, desc_t.shape[0])

"""Correspondence search: 2-NN ratio matching and duplicate resolution.

Port of the frame-to-frame part of `aslam_tpu/ops/matching.py`.  The top-2
of `knn_ratio_match` goes through `ops/hamming_top2.py`: the CUDA kernel for
tensors on the card, the plain version for CPU tensors.  `-1` marks "no
match".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.ops.hamming import INVALID_DIST
from aslam_tpu_torch.ops.hamming_top2 import hamming_top2


class Matches(NamedTuple):
    """Fixed-size match set: for each query row, index into the target set."""

    target_idx: torch.Tensor  # [Q] int32, -1 = unmatched
    distance: torch.Tensor    # [Q] float32
    valid: torch.Tensor       # [Q] bool


def knn_ratio_match(
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_t: torch.Tensor,
    ratio: float,
    max_dist: float = 256.0,
) -> Matches:
    """Lowe-ratio 2-NN matching, query rows -> target columns."""
    d1, i1, d2 = hamming_top2(desc_q, valid_q, desc_t, valid_t)
    ok = valid_q & (d1 <= max_dist) & (d1 < ratio * d2) & (d1 < INVALID_DIST)
    return Matches(target_idx=torch.where(ok, i1, torch.full_like(i1, -1)),
                   distance=d1, valid=ok)


def resolve_duplicates(matches: Matches, n_targets: int) -> Matches:
    """Keep only the lowest-distance query per claimed target index: a
    scatter-min over the key (distance, query index) elects one winner per
    target deterministically."""
    q = matches.target_idx.shape[0]
    dev = matches.distance.device
    key = matches.distance * (q + 1) + torch.arange(q, dtype=torch.float32,
                                                    device=dev)
    tgt = torch.where(matches.valid, matches.target_idx,
                      torch.full_like(matches.target_idx, n_targets)).long()
    best = torch.full((n_targets + 1,), float("inf"), dtype=torch.float32,
                      device=dev).scatter_reduce(0, tgt, key, "amin")
    win = matches.valid & (key <= best[tgt])
    return Matches(
        target_idx=torch.where(win, matches.target_idx,
                               torch.full_like(matches.target_idx, -1)),
        distance=matches.distance,
        valid=win,
    )

"""DBSCAN keypoint declustering by label propagation.

Port of `aslam_tpu/ops/dbscan.py` (a feature-experiment utility of the
reference, not on the main pipeline): the O(N^2) eps-graph, cluster labels
by iterated min-label propagation over the core-point adjacency, and the
per-cluster strongest-k selection as a rank within the group after a stable
sort (`jnp.argsort` is stable; `torch.sort(stable=True)` is too).  The
group starts come from `_searchsorted_scan`, the binary search of
`jnp.searchsorted`'s default method step for step, so the integer outputs
are the reference's exactly, also where the searched array is not sorted.
"""

from __future__ import annotations

import math

import torch


def dbscan_labels(
    xy: torch.Tensor,       # [N,2] keypoint coords
    valid: torch.Tensor,    # [N] bool
    eps: float = 10.0,
    min_pts: int = 2,
    max_iters: int = 16,
) -> torch.Tensor:
    """Cluster labels [N] int32: connected components of the eps-graph
    restricted to core points (border points join a core neighbour's
    cluster); -1 = noise / invalid."""
    N = xy.shape[0]
    d2 = torch.sum((xy[:, None, :] - xy[None, :, :]) ** 2, -1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    degree = torch.sum(adj, dim=1)                       # includes self
    core = valid & (degree >= min_pts + 1)
    core_adj = adj & core[None, :]                       # only cores relay

    none = torch.full((), N, dtype=torch.int32, device=xy.device)
    labels = torch.where(valid, torch.arange(N, dtype=torch.int32,
                                             device=xy.device), none)
    for _ in range(max_iters):
        neigh = torch.where(core_adj, labels[None, :], none)
        new = torch.minimum(labels, torch.amin(neigh, dim=1))
        labels = torch.where(valid, new, none)
    has_core_neighbor = torch.any(core_adj, dim=1)
    return torch.where(valid & (core | has_core_neighbor), labels,
                       torch.full_like(labels, -1))


def _searchsorted_scan(arr: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """`jnp.searchsorted(arr, query, side="left")` with its default method:
    ceil(log2(n + 1)) halvings of [low, high) from [0, n), going left where
    query <= arr[mid]; returns high."""
    n = arr.shape[0]
    low = torch.zeros_like(query, dtype=torch.int64)
    high = torch.full_like(query, n, dtype=torch.int64)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        left = query <= arr[mid]
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high


def decluster(
    xy: torch.Tensor,
    response: torch.Tensor,
    valid: torch.Tensor,
    eps: float = 10.0,
    min_pts: int = 2,
    keep_per_cluster: int = 1,
) -> torch.Tensor:
    """Keep only the `keep_per_cluster` strongest keypoints of each dense
    cluster; noise points always survive.  Returns the surviving mask [N]."""
    N = xy.shape[0]
    labels = dbscan_labels(xy, valid, eps, min_pts)
    in_cluster = labels >= 0
    # rank within cluster by response: sort by (label, -response)
    key = torch.where(in_cluster, labels.to(torch.float32), float(N)) * 1e6 \
        - torch.where(valid, response, -1.0)
    order = torch.sort(key, stable=True).indices
    sorted_labels = labels[order]
    rank_sorted = torch.arange(N, device=xy.device) \
        - _searchsorted_scan(sorted_labels, sorted_labels)
    rank = torch.zeros(N, dtype=torch.int64, device=xy.device) \
        .scatter_(0, order, rank_sorted)
    return valid & (~in_cluster | (rank < keep_per_cluster))

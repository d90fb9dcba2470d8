"""Spatially-uniform keypoint selection: grid-bucketed top-k.

Port of `aslam_tpu/ops/select.py`.  `lax.top_k` returns the lowest index
first among equal values and `torch.topk` promises no order, so every top-k
here is a stable descending sort cut to k.
"""

from __future__ import annotations

import torch

_NEG = -1e9


def topk_stable(x: torch.Tensor, k: int):
    """`lax.top_k` semantics: the k largest along the last axis, ties to the
    lowest index.  Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_topk(score: torch.Tensor, cell: int, k_cell: int, n_out: int):
    """Select up to n_out keypoints from a response map, spatially uniform:
    candidates rank by (rank within their cell, response).

    score: [H,W] float32 NMS'd response (0 = no corner).  Returns
    (xy [n_out,2] float32 (x, y), resp [n_out], valid [n_out] bool)."""
    H, W = score.shape
    ph = (-H) % cell
    pw = (-W) % cell
    s = torch.nn.functional.pad(score, (0, pw, 0, ph))
    gy, gx = (H + ph) // cell, (W + pw) // cell
    cells = s.reshape(gy, cell, gx, cell).permute(0, 2, 1, 3).reshape(
        gy * gx, cell * cell)
    k_cell = min(k_cell, cell * cell)
    top_vals, top_idx = topk_stable(cells, k_cell)              # [nc, k]

    dev = score.device
    cell_id = torch.arange(gy * gx, device=dev)
    py = top_idx // cell + ((cell_id // gx) * cell)[:, None]
    px = top_idx % cell + ((cell_id % gx) * cell)[:, None]

    vals = top_vals.reshape(-1)
    ys = py.reshape(-1).to(torch.float32)
    xs = px.reshape(-1).to(torch.float32)
    ranks = torch.arange(k_cell, device=dev).expand(top_idx.shape).reshape(-1)

    valid = vals > 0.0
    # primary: low rank (spatial spread), secondary: high response
    max_resp = 1e6
    key = torch.where(
        valid,
        -ranks.to(torch.float32) * max_resp + torch.clamp(vals, max=max_resp - 1),
        torch.full_like(vals, _NEG))
    n_out = min(n_out, key.shape[0])
    _, sel = topk_stable(key, n_out)

    out_xy = torch.stack([xs[sel], ys[sel]], dim=-1)
    out_valid = valid[sel] & (out_xy[:, 0] < W) & (out_xy[:, 1] < H)
    return out_xy, vals[sel], out_valid


def subpixel_refine(score: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Quadratic sub-pixel refinement on the raw (pre-NMS) response map: a
    1-D parabola through three samples per axis, vertex clamped to ±0.5 px."""
    H, W = score.shape
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 1, W - 2)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 1, H - 2)
    c = score[yi, xi]
    dx = score[yi, xi + 1] - score[yi, xi - 1]
    dxx = score[yi, xi + 1] - 2 * c + score[yi, xi - 1]
    dy = score[yi + 1, xi] - score[yi - 1, xi]
    dyy = score[yi + 1, xi] - 2 * c + score[yi - 1, xi]
    zero = torch.zeros_like(c)
    off_x = torch.where(torch.abs(dxx) > 1e-6, -0.5 * dx / dxx, zero)
    off_y = torch.where(torch.abs(dyy) > 1e-6, -0.5 * dy / dyy, zero)
    off = torch.stack([torch.clamp(off_x, -0.5, 0.5),
                       torch.clamp(off_y, -0.5, 0.5)], dim=-1)
    return xy + off

"""Spatially-uniform keypoint selection: grid-bucketed top-k.

Port of `aslam_tpu/ops/select.py`.  `lax.top_k` returns the lowest index
first among equal values and `torch.topk` promises no order, so every top-k
here is a stable descending sort cut to k.

Both functions take a leading batch axis ([..., H, W] maps, [..., K, 2]
keypoints): the sorts are per row and the gathers per lane, so each lane
selects exactly what it selects alone.
"""

from __future__ import annotations

import torch

from aslam_tpu_torch.ops.index import take_pixels

_NEG = -1e9


def topk_stable(x: torch.Tensor, k: int):
    """`lax.top_k` semantics: the k largest along the last axis, ties to the
    lowest index.  Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_topk(score: torch.Tensor, cell: int, k_cell: int, n_out: int):
    """Select up to n_out keypoints from a response map, spatially uniform:
    candidates rank by (rank within their cell, response).

    score: [..., H, W] float32 NMS'd response (0 = no corner).  Returns
    (xy [..., n_out, 2] float32 (x, y), resp [..., n_out], valid [..., n_out]
    bool)."""
    lead = score.shape[:-2]
    H, W = score.shape[-2:]
    ph = (-H) % cell
    pw = (-W) % cell
    s = torch.nn.functional.pad(score, (0, pw, 0, ph))
    gy, gx = (H + ph) // cell, (W + pw) // cell
    cells = s.reshape(lead + (gy, cell, gx, cell)).transpose(-3, -2).reshape(
        lead + (gy * gx, cell * cell))
    k_cell = min(k_cell, cell * cell)
    top_vals, top_idx = topk_stable(cells, k_cell)              # [..., nc, k]

    dev = score.device
    cell_id = torch.arange(gy * gx, device=dev)
    py = top_idx // cell + ((cell_id // gx) * cell)[:, None]
    px = top_idx % cell + ((cell_id % gx) * cell)[:, None]

    vals = top_vals.reshape(lead + (-1,))
    ys = py.reshape(lead + (-1,)).to(torch.float32)
    xs = px.reshape(lead + (-1,)).to(torch.float32)
    ranks = torch.arange(k_cell, device=dev).expand(top_idx.shape).reshape(
        lead + (-1,))

    valid = vals > 0.0
    # primary: low rank (spatial spread), secondary: high response
    max_resp = 1e6
    key = torch.where(
        valid,
        -ranks.to(torch.float32) * max_resp + torch.clamp(vals, max=max_resp - 1),
        torch.full_like(vals, _NEG))
    n_out = min(n_out, key.shape[-1])
    _, sel = topk_stable(key, n_out)

    out_xy = torch.stack([xs.gather(-1, sel), ys.gather(-1, sel)], dim=-1)
    out_valid = valid.gather(-1, sel) & (out_xy[..., 0] < W) \
        & (out_xy[..., 1] < H)
    return out_xy, vals.gather(-1, sel), out_valid


def subpixel_refine(score: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Quadratic sub-pixel refinement on the raw (pre-NMS) response map: a
    1-D parabola through three samples per axis, vertex clamped to ±0.5 px.
    score [..., H, W], xy [..., K, 2]."""
    H, W = score.shape[-2:]
    xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 1, W - 2)
    yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 1, H - 2)
    c = take_pixels(score, yi, xi)
    right, left = take_pixels(score, yi, xi + 1), take_pixels(score, yi, xi - 1)
    down, up = take_pixels(score, yi + 1, xi), take_pixels(score, yi - 1, xi)
    dx = right - left
    dxx = right - 2 * c + left
    dy = down - up
    dyy = down - 2 * c + up
    zero = torch.zeros_like(c)
    off_x = torch.where(torch.abs(dxx) > 1e-6, -0.5 * dx / dxx, zero)
    off_y = torch.where(torch.abs(dyy) > 1e-6, -0.5 * dy / dyy, zero)
    off = torch.stack([torch.clamp(off_x, -0.5, 0.5),
                       torch.clamp(off_y, -0.5, 0.5)], dim=-1)
    return xy + off

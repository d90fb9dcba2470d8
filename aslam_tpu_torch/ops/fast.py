"""FAST-9/16 corner detection as a dense whole-image computation.

Port of `aslam_tpu/ops/fast.py`.  The response, the 3x3 NMS and the
adaptive per-cell threshold grid keep the reference's semantics exactly.
Where the reference wrote a gather or a scatter-add as one-hot matmuls (a
TPU workaround), the port indexes and uses `bincount`; both are exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise from 12 o'clock,
# as (dy, dx) offsets.
RING_16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9: at least 9 contiguous ring pixels all brighter/darker


def fast_response(img: torch.Tensor, threshold) -> torch.Tensor:
    """FAST-9/16 V-score: max over contiguous 9-arcs of the minimum margin
    |p_i - p| - t within the arc; 0 where not a corner.

    img: [H,W] float32.  threshold: scalar or [H,W] map."""
    t = torch.as_tensor(threshold, dtype=img.dtype, device=img.device)
    ring = torch.stack([torch.roll(img, (-dy, -dx), (0, 1))
                        for dy, dx in RING_16])                 # [16,H,W]
    diff = ring - img[None]
    bright = diff - t
    dark = -diff - t

    def arc_score(m):
        # wrap-around windows of length 9, min inside, max over the 16
        m = torch.cat([m, m[:ARC_LEN - 1]], dim=0)              # [24,H,W]
        return m.unfold(0, ARC_LEN, 1).amin(dim=-1).amax(dim=0)

    score = torch.clamp(torch.maximum(arc_score(bright), arc_score(dark)),
                        min=0.0)
    H, W = img.shape
    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    border = (row >= 3) & (row < H - 3) & (col >= 3) & (col < W - 3)
    return torch.where(border, score, torch.zeros_like(score))


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression with a raster-order epsilon tie break, so
    a flat plateau yields exactly one keypoint."""
    H, W = score.shape
    eps = (torch.arange(H * W, dtype=torch.float32, device=score.device)
           .reshape(H, W) * (0.5 / (H * W)))
    keyed = torch.where(score > 0, score + eps, torch.zeros_like(score))
    # max_pool2d pads with -inf: the reduce_window(SAME, -inf) of the reference
    neighborhood_max = F.max_pool2d(keyed[None, None], 3, 1, 1)[0, 0]
    return torch.where(keyed >= neighborhood_max, score,
                       torch.zeros_like(score))


def _cell_index(n: int, g: int, device) -> torch.Tensor:
    return torch.clamp((torch.arange(n, device=device) * g) // n, max=g - 1)


def threshold_map_from_grid(grid_thresholds: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """Broadcast a [gy,gx] per-cell threshold grid to a full [H,W] map."""
    gy, gx = grid_thresholds.shape
    dev = grid_thresholds.device
    rows = _cell_index(height, gy, dev)
    cols = _cell_index(width, gx, dev)
    return grid_thresholds[rows[:, None], cols[None, :]]


def counts_per_grid_cell(score: torch.Tensor, gy: int, gx: int) -> torch.Tensor:
    """Count detected corners (score>0) per adaptive grid cell -> [gy,gx] int32."""
    H, W = score.shape
    dev = score.device
    cell = (_cell_index(H, gy, dev)[:, None] * gx
            + _cell_index(W, gx, dev)[None, :])
    # a scatter-add of the hit mask: unlike bincount of the hit pixels it
    # has a static shape, so it needs no host sync on the card
    counts = torch.zeros(gy * gx, dtype=torch.int64, device=dev).index_add_(
        0, cell.reshape(-1), (score > 0).reshape(-1).to(torch.int64))
    return counts.reshape(gy, gx).to(torch.int32)


def adaptive_threshold_update(
    grid_thresholds: torch.Tensor,
    counts: torch.Tensor,
    min_count: float,
    max_count: float,
    down: float = 0.7,
    up: float = 1.3,
    th_min: float = 2.0,
    th_max: float = 80.0,
) -> torch.Tensor:
    """Per-cell threshold controller: too few corners in a cell ->
    threshold *= down, too many -> *= up, clamped to [th_min, th_max]."""
    one = torch.ones_like(grid_thresholds)
    scale = torch.where(counts < min_count, one * down,
                        torch.where(counts > max_count, one * up, one))
    return torch.clamp(grid_thresholds * scale, th_min, th_max)

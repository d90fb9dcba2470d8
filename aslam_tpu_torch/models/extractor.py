"""Adaptive multi-scale ORB extractor — the feature front-end.

Port of `aslam_tpu/models/extractor.py` for the FAST detector, with the
adaptive threshold controller on or off.  Per frame:
  1. 8-level x1.2 image pyramid (ops/pyramid.py)
  2. with adaptive mode, `adaptive_iters - 1` counting passes of FAST + NMS
     on level 0 that update the [3,3] threshold grid within the frame
  3. per level: FAST-9 under the per-pixel threshold map, 3x3 NMS, a border
     strip cleared for the descriptor patches, grid top-k (quota per level
     = geometric allocation of n_features), sub-pixel refinement
  4. Gaussian blur + IC angle + rBRIEF (ops/orb.py)
  5. a global merge into [max_keypoints] arrays with a validity mask,
     coordinates in level-0 pixels
  6. the grid update from the per-cell corner counts of all levels.
The other detector families of the reference raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import ExtractorConfig
from aslam_tpu_torch.ops import desc as desc_ops
from aslam_tpu_torch.ops import fast, orb, pyramid, select

DETECTOR_ALIASES = {"ORB": "FAST", "ORB_SLAM2": "FAST", "BRISK": "FAST",
                    "AGAST": "FAST"}


class Features(NamedTuple):
    """Per-frame keypoint set, padded to config.max_keypoints."""

    xy: torch.Tensor        # [M,2] float32 level-0 pixel coords (x, y)
    response: torch.Tensor  # [M] float32
    angle: torch.Tensor     # [M] float32 radians
    octave: torch.Tensor    # [M] int32 pyramid level
    desc: torch.Tensor      # [M,8] int32 packed binary (uint32 bit patterns)
    valid: torch.Tensor     # [M] bool


def _check_detector(cfg: ExtractorConfig) -> None:
    det = cfg.detector.upper()
    if DETECTOR_ALIASES.get(det, det) != "FAST":
        raise NotImplementedError(
            f"detector {cfg.detector} is not ported yet; only FAST is")


def init_grid_thresholds(cfg: ExtractorConfig,
                         device: torch.device | str) -> torch.Tensor:
    """The adaptive [g,g] threshold grid at its initial FAST threshold."""
    _check_detector(cfg)
    g = cfg.adaptive_grid
    return torch.full((g, g), float(cfg.fast_threshold), dtype=torch.float32,
                      device=device)


def _extract_impl(img: torch.Tensor, grid_thresholds: torch.Tensor,
                  cfg: ExtractorConfig):
    """img [H,W] float32 -> (Features, new grid thresholds [g,g])."""
    _check_detector(cfg)
    dev = img.device
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    quotas = cfg.features_per_level
    scales = cfg.scale_factors
    th_lo, th_hi = float(cfg.adaptive_th_min), float(cfg.adaptive_th_max)
    g = cfg.adaptive_grid
    n_cells = g * g

    def update(grid, counts):
        return fast.adaptive_threshold_update(
            grid, counts, min_count=cfg.adaptive_min / n_cells,
            max_count=cfg.adaptive_max / n_cells, down=cfg.adaptive_down,
            up=cfg.adaptive_up, th_min=th_lo, th_max=th_hi)

    if cfg.adaptive and cfg.adaptive_iters > 1:
        # intra-frame controller passes, counting on level 0 only
        base = levels[0]
        h0, w0 = base.shape
        for _ in range(cfg.adaptive_iters - 1):
            th0 = fast.threshold_map_from_grid(grid_thresholds, h0, w0)
            counts = fast.counts_per_grid_cell(
                fast.nms_3x3(fast.fast_response(base, th0)), g, g)
            grid_thresholds = update(grid_thresholds, counts)

    all_xy, all_resp, all_valid, all_oct, all_desc, all_angle = \
        [], [], [], [], [], []
    total_counts = torch.zeros((g, g), dtype=torch.int32, device=dev)
    b = orb.PATCH_RADIUS + 1
    for l, img_l in enumerate(levels):
        h, w = img_l.shape
        th_map = fast.threshold_map_from_grid(grid_thresholds, h, w)
        resp_raw = fast.fast_response(img_l, th_map)
        if not cfg.adaptive:
            # static mode: cells with no corner retry at the minimum threshold
            weak_cells = fast.counts_per_grid_cell(resp_raw, g, g) == 0
            th_low_map = fast.threshold_map_from_grid(
                torch.where(weak_cells,
                            torch.full_like(grid_thresholds,
                                            float(cfg.fast_threshold_min)),
                            grid_thresholds), h, w)
            weak_px = fast.threshold_map_from_grid(
                weak_cells.to(torch.float32), h, w) > 0
            resp_raw = torch.where(weak_px, fast.fast_response(img_l, th_low_map),
                                   resp_raw)
        resp = fast.nms_3x3(resp_raw)
        # keep the descriptors' patches inside the image
        row = torch.arange(h, device=dev)[:, None]
        col = torch.arange(w, device=dev)[None, :]
        interior = (row >= b) & (row < h - b) & (col >= b) & (col < w - b)
        resp = torch.where(interior, resp, torch.zeros_like(resp))
        total_counts = total_counts + fast.counts_per_grid_cell(resp, g, g)

        n_l = max(int(quotas[l]), 1)
        xy_l, resp_l, valid_l = select.grid_topk(
            resp, cfg.cell_px, k_cell=cfg.cell_topk, n_out=n_l)
        # sub-pixel on the pre-NMS surface; descriptors use rounded coords
        xy_l = select.subpixel_refine(resp_raw, xy_l)
        desc_l, angle_l = desc_ops.describe(
            cfg.descriptor, pyramid.gaussian_blur(img_l), xy_l)

        all_xy.append(xy_l * scales[l])       # to level-0 coords
        all_resp.append(resp_l)
        all_valid.append(valid_l)
        all_oct.append(torch.full((xy_l.shape[0],), l, dtype=torch.int32,
                                  device=dev))
        all_desc.append(desc_l)
        all_angle.append(angle_l)

    xy = torch.cat(all_xy)
    resp = torch.cat(all_resp)
    valid = torch.cat(all_valid)
    octv = torch.cat(all_oct)
    desc = torch.cat(all_desc)
    angle = torch.cat(all_angle)

    M = cfg.max_keypoints
    n_cand = xy.shape[0]
    if n_cand >= M:
        # keep the M best by (valid, response)
        _, sel = select.topk_stable(
            torch.where(valid, resp, torch.full_like(resp, -1.0)), M)
        xy, resp, angle, octv, desc, valid = (
            xy[sel], resp[sel], angle[sel], octv[sel], desc[sel], valid[sel])
    else:
        pad = M - n_cand
        xy = torch.nn.functional.pad(xy, (0, 0, 0, pad))
        resp = torch.nn.functional.pad(resp, (0, pad))
        angle = torch.nn.functional.pad(angle, (0, pad))
        octv = torch.nn.functional.pad(octv, (0, pad))
        desc = torch.nn.functional.pad(desc, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))

    feats = Features(xy=xy, response=resp, angle=angle, octave=octv,
                     desc=desc, valid=valid)
    new_grid = update(grid_thresholds, total_counts) if cfg.adaptive \
        else grid_thresholds
    return feats, new_grid

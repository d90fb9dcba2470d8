"""Adaptive multi-scale extractor — the feature front-end facade.

Port of `aslam_tpu/models/extractor.py`, every detector family (FAST, GFTT,
HARRIS, DOG, HESSIAN, STAR, `ops/detectors.py`) and every descriptor family
(ORB, BRIEF, FREAK, LATCH, SIFT, `ops/desc.py`), with the adaptive threshold
controller on or off.  Per frame:
  1. 8-level x1.2 image pyramid (ops/pyramid.py)
  2. with adaptive mode, `adaptive_iters - 1` counting passes of the
     detector + NMS on level 0 that update the [3,3] threshold grid within
     the frame
  3. per level: the detector's response under the per-pixel threshold map,
     3x3 NMS, a border strip cleared for the descriptor patches, grid top-k
     (quota per level = geometric allocation of n_features), sub-pixel
     refinement
  4. Gaussian blur + the descriptor family (IC angle + rBRIEF for ORB)
  5. a global merge into [max_keypoints] arrays with a validity mask,
     coordinates in level-0 pixels
  6. the grid update from the per-cell corner counts of all levels, clamped
     to the family's [th_min, th_max] (`detector_params`).

`_extract_impl` takes one image [H,W] with its [g,g] grid, or a batch
[B,H,W] with [B,g,g] grids (batched VO, `models/batch_vo.py`): every step
above broadcasts over the leading axis, so a batch of any family runs the
launches of one image, and one image runs what it ran before the batch
axis existed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aslam_tpu_torch.config import ExtractorConfig
from aslam_tpu_torch.ops import desc as desc_ops
from aslam_tpu_torch.ops import detectors, fast, orb, pyramid, select
from aslam_tpu_torch.ops.index import take_rows


class Features(NamedTuple):
    """Per-frame keypoint set, padded to config.max_keypoints."""

    xy: torch.Tensor        # [M,2] float32 level-0 pixel coords (x, y)
    response: torch.Tensor  # [M] float32
    angle: torch.Tensor     # [M] float32 radians
    octave: torch.Tensor    # [M] int32 pyramid level
    desc: torch.Tensor      # [M,8] int32 packed binary (uint32 bit patterns),
                            # or [M,128] float32 (SIFT)
    valid: torch.Tensor     # [M] bool


class AdaptiveState(NamedTuple):
    """Per-cell detector thresholds carried across frames."""

    grid_thresholds: torch.Tensor  # [gy,gx] float32


def detector_params(cfg: ExtractorConfig) -> tuple[float, float, float]:
    """(initial threshold, clamp min, clamp max) for cfg.detector: FAST keeps
    the config's FAST fields, the other families their calibrated defaults
    (`ops/detectors.py::DETECTOR_DEFAULTS`)."""
    if detectors.canonical(cfg.detector) == "FAST":
        return (float(cfg.fast_threshold), float(cfg.adaptive_th_min),
                float(cfg.adaptive_th_max))
    d = detectors.defaults(cfg.detector)
    return d["threshold"], d["th_min"], d["th_max"]


def init_grid_thresholds(cfg: ExtractorConfig,
                         device: torch.device | str) -> torch.Tensor:
    """The adaptive [g,g] threshold grid at the family's initial threshold."""
    g = cfg.adaptive_grid
    return torch.full((g, g), detector_params(cfg)[0], dtype=torch.float32,
                      device=device)


def init_adaptive_state(cfg: ExtractorConfig,
                        device: torch.device | str = "cuda") -> AdaptiveState:
    return AdaptiveState(grid_thresholds=init_grid_thresholds(cfg, device))


def _extract_impl(img: torch.Tensor, grid_thresholds: torch.Tensor,
                  cfg: ExtractorConfig):
    """img [..., H, W] float32, grid [..., g, g] -> (Features with the same
    leading dims, new grid thresholds [..., g, g])."""
    dev = img.device
    lead = img.shape[:-2]
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    quotas = cfg.features_per_level
    scales = cfg.scale_factors
    det = detectors.canonical(cfg.detector)
    _, th_lo, th_hi = detector_params(cfg)
    g = cfg.adaptive_grid
    n_cells = g * g

    def update(grid, counts):
        return fast.adaptive_threshold_update(
            grid, counts, min_count=cfg.adaptive_min / n_cells,
            max_count=cfg.adaptive_max / n_cells, down=cfg.adaptive_down,
            up=cfg.adaptive_up, th_min=th_lo, th_max=th_hi)

    def response(img_l, th_map):
        return detectors.response(det, img_l, th_map)

    if cfg.adaptive and cfg.adaptive_iters > 1:
        # intra-frame controller passes, counting on level 0 only
        base = levels[0]
        h0, w0 = base.shape[-2:]
        for _ in range(cfg.adaptive_iters - 1):
            th0 = fast.threshold_map_from_grid(grid_thresholds, h0, w0)
            counts = fast.counts_per_grid_cell(
                fast.nms_3x3(response(base, th0)), g, g)
            grid_thresholds = update(grid_thresholds, counts)

    all_xy, all_resp, all_valid, all_oct, all_desc, all_angle = \
        [], [], [], [], [], []
    total_counts = torch.zeros(lead + (g, g), dtype=torch.int32, device=dev)
    b = orb.PATCH_RADIUS + 1
    for l, img_l in enumerate(levels):
        h, w = img_l.shape[-2:]
        th_map = fast.threshold_map_from_grid(grid_thresholds, h, w)
        resp_raw = response(img_l, th_map)
        if not cfg.adaptive:
            # static mode: cells with no corner retry at the minimum
            # threshold (FAST's fallback field, the other families' th_min)
            fallback_th = (float(cfg.fast_threshold_min) if det == "FAST"
                           else th_lo)
            weak_cells = fast.counts_per_grid_cell(resp_raw, g, g) == 0
            th_low_map = fast.threshold_map_from_grid(
                torch.where(weak_cells,
                            torch.full_like(grid_thresholds, fallback_th),
                            grid_thresholds), h, w)
            weak_px = fast.threshold_map_from_grid(
                weak_cells.to(torch.float32), h, w) > 0
            resp_raw = torch.where(weak_px, response(img_l, th_low_map),
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
        all_oct.append(torch.full(xy_l.shape[:-1], l, dtype=torch.int32,
                                  device=dev))
        all_desc.append(desc_l)
        all_angle.append(angle_l)

    xy = torch.cat(all_xy, -2)
    resp = torch.cat(all_resp, -1)
    valid = torch.cat(all_valid, -1)
    octv = torch.cat(all_oct, -1)
    desc = torch.cat(all_desc, -2)
    angle = torch.cat(all_angle, -1)

    M = cfg.max_keypoints
    n_cand = xy.shape[-2]
    if n_cand >= M:
        # keep the M best by (valid, response)
        _, sel = select.topk_stable(
            torch.where(valid, resp, torch.full_like(resp, -1.0)), M)
        xy, resp, angle, octv, desc, valid = (
            take_rows(x, sel) for x in (xy, resp, angle, octv, desc, valid))
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


class Extractor:
    """Stateful facade: owns the adaptive threshold grid across a video."""

    def __init__(self, cfg: ExtractorConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = init_adaptive_state(cfg, self.device)

    def extract(self, img) -> Features:
        """img: [H,W] gray (numpy or tensor) -> Features on the extractor's
        device (updates the adaptive state)."""
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.asarray(img, np.float32))
        img = img.to(self.device, torch.float32)
        feats, new_grid = _extract_impl(img, self.state.grid_thresholds,
                                        self.cfg)
        self.state = AdaptiveState(grid_thresholds=new_grid)
        return feats


def extract_features(img: torch.Tensor, cfg: ExtractorConfig,
                     state: AdaptiveState | None = None):
    """Functional entry: img [H,W] float32 tensor -> (Features,
    AdaptiveState), on the image's device."""
    if state is None:
        state = init_adaptive_state(cfg, img.device)
    feats, new_grid = _extract_impl(img, state.grid_thresholds, cfg)
    return feats, AdaptiveState(grid_thresholds=new_grid)

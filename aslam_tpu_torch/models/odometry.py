"""Frame-to-frame odometry: the ADAPTIVE_RBA policy.

Port of `rba_step`, `track_frame` and `track_sequence` of
`aslam_tpu/models/odometry.py`: 2-NN ratio match (through the
`hamming_top2` kernel on the card), duplicate resolution, Mahalanobis
RANSAC, pose composition T_cw2 = T12 T_cw1, then motion-only BA.  Every
step stays on the tensors' device; nothing is read back to the host.
`lax.scan` over frames becomes a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.models.frame import FrameData, _make_frame_impl
from aslam_tpu_torch.ops import ba, matching, ransac
from aslam_tpu_torch.utils.se3 import T_inv, transform_points


class OdometryResult(NamedTuple):
    T_cw2: torch.Tensor       # [4,4] estimated pose of frame 2
    T12: torch.Tensor         # [4,4] relative cam1->cam2
    match_idx: torch.Tensor   # [M] feature index in frame2 per frame1 feature
    inliers: torch.Tensor     # [M] bool over frame-1 features
    n_matches: torch.Tensor   # scalar int32
    n_inliers: torch.Tensor   # scalar int32
    rmse: torch.Tensor        # scalar float32 (RANSAC residual)
    ba_inliers: torch.Tensor  # scalar int32 (motion-only BA inlier count)


def rba_step(f1: FrameData, f2: FrameData, generator: torch.Generator | None,
             cfg: SystemConfig,
             draws: torch.Tensor | None = None) -> OdometryResult:
    """RANSAC + motion-only BA refinement.  `draws` [H,S] optionally fixes
    the RANSAC samples (see `ops/ransac.py`)."""
    cam = cfg.camera
    m = matching.knn_ratio_match(
        f1.feat.desc, f1.feat.valid, f2.feat.desc, f2.feat.valid,
        ratio=cfg.matcher.ratio_frame, max_dist=float(cfg.matcher.th_high))
    m = matching.resolve_duplicates(m, f2.feat.desc.shape[0])
    tgt = torch.clamp(m.target_idx, min=0).long()

    p1 = f1.p3d
    p2 = f2.p3d[tgt]
    pair_valid = m.valid & f1.has_depth & f2.has_depth[tgt]
    res = ransac.ransac_align(p1, p2, pair_valid, generator, cfg.ransac, cam,
                              draws=draws)

    T_cw2_init = res.T12 @ f1.T_cw
    # motion-only BA on the RANSAC inliers: world points from frame-1 depth,
    # observations from the frame-2 keypoints
    ba_res = ba.pose_only_ba(
        T_cw2_init, transform_points(T_inv(f1.T_cw), p1), f2.xy_und[tgt],
        f2.ur[tgt], f2.depth[tgt], res.inliers & pair_valid, cam, cfg.ba)
    use_ba = ba_res.n_inliers >= cfg.ransac.min_inliers
    T_cw2 = torch.where(use_ba, ba_res.T_cw, T_cw2_init)

    return OdometryResult(
        T_cw2=T_cw2,
        T12=T_cw2 @ T_inv(f1.T_cw),
        match_idx=m.target_idx,
        inliers=res.inliers,
        n_matches=torch.sum(m.valid.to(torch.int32)),
        n_inliers=res.n_inliers,
        rmse=res.rmse,
        ba_inliers=ba_res.n_inliers,
    )


def track_frame(prev: FrameData, img: torch.Tensor, depth_map: torch.Tensor,
                grid_thresholds: torch.Tensor,
                generator: torch.Generator | None, cfg: SystemConfig,
                draws: torch.Tensor | None = None):
    """One VO step, extraction + ADAPTIVE_RBA odometry
    -> (posed FrameData, new grid thresholds, OdometryResult)."""
    f, new_grid = _make_frame_impl(img, depth_map, grid_thresholds, cfg)
    res = rba_step(prev, f, generator, cfg, draws=draws)
    return f._replace(T_cw=res.T_cw2), new_grid, res


class SequenceResult(NamedTuple):
    T_cw: torch.Tensor        # [T,4,4] estimated pose per frame
    n_matches: torch.Tensor   # [T] int32
    n_inliers: torch.Tensor   # [T] int32
    rmse: torch.Tensor        # [T] float32


def track_sequence(prev: FrameData, imgs: torch.Tensor, depths: torch.Tensor,
                   grid_thresholds: torch.Tensor,
                   generator: torch.Generator | None, cfg: SystemConfig):
    """Chained VO over a chunk of frames: `track_frame` applied in turn,
    carrying the previous FrameData and the threshold grid.
    imgs [T,H,W] uint8 or float, depths [T,H,W] uint16 counts or float
    metres, on one device.  -> (last FrameData, final grid, SequenceResult)."""
    outs = []
    grid = grid_thresholds
    for i in range(imgs.shape[0]):
        prev, grid, res = track_frame(prev, imgs[i], depths[i], grid,
                                      generator, cfg)
        outs.append(res)
    return prev, grid, SequenceResult(
        T_cw=torch.stack([r.T_cw2 for r in outs]),
        n_matches=torch.stack([r.n_matches for r in outs]),
        n_inliers=torch.stack([r.n_inliers for r in outs]),
        rmse=torch.stack([r.rmse for r in outs]),
    )

"""Frame-to-frame odometry: the ADAPTIVE_RBA and ADAPTIVE_RICP policies.

Port of `aslam_tpu/models/odometry.py`.  Both policies share `ransac_step`:
2-NN ratio match (through the `hamming_top2` kernel on the card), duplicate
resolution, Mahalanobis RANSAC.  ADAPTIVE_RBA (`rba_step`, `track_frame`,
`track_sequence`) composes T_cw2 = T12 T_cw1 and refines it by motion-only
BA.  ADAPTIVE_RICP escalates to GICP (or point-to-plane ICP) when RANSAC is
poor (inliers < 20 or rmse*10 >= 7), warm-started from the RANSAC transform
unless rmse*10 >= 20 (then from the identity), and runs no motion-only BA:

  * `ricp_step` branches on the host: one `read_host` of the predicate, and
    one of `converged` when it escalated;
  * `ricp_fused` reads nothing: where the reference puts the refinement
    under `lax.cond`, it computes the refinement on every frame and selects
    with `torch.where`, so the frame keeps a fixed sequence of launches.

Every other step stays on the tensors' device.  `lax.scan` over frames
becomes a Python loop.

`ransac_step`, `rba_step` and `track_frame` also take batched frames (a
leading [B] on every field, `models/batch_vo.py`): B frame pairs per call,
with about the launches of one.  The ADAPTIVE_RICP policies stay one pair
per call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.device import read_host
from aslam_tpu_torch.models.frame import FrameData, _make_frame_impl
from aslam_tpu_torch.ops import ba, icp, matching, ransac
from aslam_tpu_torch.ops.index import take_rows
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


def ransac_step(f1: FrameData, f2: FrameData,
                generator: torch.Generator | None, cfg: SystemConfig,
                draws: torch.Tensor | None = None):
    """Match + RANSAC, the shared first stage of every policy.  `draws`
    [H,S] optionally fixes the RANSAC samples (see `ops/ransac.py`).
    -> (Matches, pair_valid [M] bool, RansacResult)."""
    m = matching.knn_ratio_match(
        f1.feat.desc, f1.feat.valid, f2.feat.desc, f2.feat.valid,
        ratio=cfg.matcher.ratio_frame, max_dist=float(cfg.matcher.th_high))
    m = matching.resolve_duplicates(m, f2.feat.desc.shape[-2])
    tgt = torch.clamp(m.target_idx, min=0).long()
    pair_valid = m.valid & f1.has_depth & take_rows(f2.has_depth, tgt)
    res = ransac.ransac_align(f1.p3d, take_rows(f2.p3d, tgt), pair_valid,
                              generator, cfg.ransac, cfg.camera, draws=draws)
    return m, pair_valid, res


def _icp_refine_step(f1: FrameData, f2: FrameData, pair_valid: torch.Tensor,
                     T_init: torch.Tensor, cfg: SystemConfig) -> icp.ICPResult:
    """Refine T12 from `T_init` by `cfg.icp.method`: frame 1's depth-valid
    matched keypoints (with normals from its depth map, for GICP) onto frame
    2's depth map."""
    cam = cfg.camera
    src_valid = f1.has_depth & pair_valid
    if cfg.icp.method == "gicp":
        nm = icp.normal_map(icp.backproject_depth(f1.depth_map, cam),
                            f1.depth_map > 0.05)
        H, W = f1.depth_map.shape
        xi = torch.clamp(torch.round(f1.feat.xy[:, 0]), 0, W - 1).long()
        yi = torch.clamp(torch.round(f1.feat.xy[:, 1]), 0, H - 1).long()
        return icp.gicp_refine(f1.p3d, nm[yi, xi], src_valid, f2.depth_map,
                               T_init, cam, cfg.icp)
    return icp.icp_refine(f1.p3d, src_valid, f2.depth_map, T_init, cam, cfg.icp)


def _escalation(res: ransac.RansacResult, cfg: SystemConfig):
    """The ADAPTIVE_RICP predicate on the device -> (escalate, warm) scalar
    bools: refine when RANSAC is poor; start from its transform unless its
    rmse is past `restart_rmse`."""
    escalate = (res.n_inliers < cfg.icp.escalate_min_inliers) | (
        res.rmse * 10.0 >= cfg.icp.escalate_rmse * 10.0)
    warm = res.rmse * 10.0 < cfg.icp.restart_rmse * 10.0
    return escalate, warm


def _ricp_result(f1, m, res, T12) -> "OdometryResult":
    return OdometryResult(
        T_cw2=T12 @ f1.T_cw,
        T12=T12,
        match_idx=m.target_idx,
        inliers=res.inliers,
        n_matches=torch.sum(m.valid.to(torch.int32)),
        n_inliers=res.n_inliers,
        rmse=res.rmse,
        ba_inliers=torch.zeros((), dtype=torch.int32, device=T12.device),
    )


def ricp_step(f1: FrameData, f2: FrameData, generator: torch.Generator | None,
              cfg: SystemConfig,
              draws: torch.Tensor | None = None) -> OdometryResult:
    """ADAPTIVE_RICP with the branch on the host.  Each call that escalates
    adds one to `ricp_step.escalated`, each refinement that converged one to
    `ricp_step.converged`."""
    m, pair_valid, res = ransac_step(f1, f2, generator, cfg, draws=draws)
    escalate, warm = read_host(*_escalation(res, cfg))
    T12 = res.T12
    if escalate:
        eye = torch.eye(4, dtype=T12.dtype, device=T12.device)
        icp_res = _icp_refine_step(f1, f2, pair_valid, T12 if warm else eye,
                                   cfg)
        ricp_step.escalated += 1
        if read_host(icp_res.converged)[0]:
            ricp_step.converged += 1
            T12 = icp_res.T12
        elif not warm:
            T12 = eye
    return _ricp_result(f1, m, res, T12)


ricp_step.escalated = 0
ricp_step.converged = 0


def ricp_fused(f1: FrameData, f2: FrameData, generator: torch.Generator | None,
               cfg: SystemConfig,
               draws: torch.Tensor | None = None) -> OdometryResult:
    """ADAPTIVE_RICP with no host read: the refinement runs on every frame
    and `torch.where` keeps it only where the predicate holds and it
    converged."""
    m, pair_valid, res = ransac_step(f1, f2, generator, cfg, draws=draws)
    escalate, warm = _escalation(res, cfg)
    eye = torch.eye(4, dtype=res.T12.dtype, device=res.T12.device)
    fallback = torch.where(warm, res.T12, eye)
    icp_res = _icp_refine_step(f1, f2, pair_valid, fallback, cfg)
    refined = torch.where(icp_res.converged, icp_res.T12, fallback)
    return _ricp_result(f1, m, res, torch.where(escalate, refined, res.T12))


def rba_step(f1: FrameData, f2: FrameData, generator: torch.Generator | None,
             cfg: SystemConfig,
             draws: torch.Tensor | None = None) -> OdometryResult:
    """RANSAC + motion-only BA refinement.  `draws` [H,S] optionally fixes
    the RANSAC samples (see `ops/ransac.py`)."""
    cam = cfg.camera
    m, pair_valid, res = ransac_step(f1, f2, generator, cfg, draws=draws)
    tgt = torch.clamp(m.target_idx, min=0).long()
    p1 = f1.p3d

    T_cw2_init = res.T12 @ f1.T_cw
    # motion-only BA on the RANSAC inliers: world points from frame-1 depth,
    # observations from the frame-2 keypoints
    ba_res = ba.pose_only_ba(
        T_cw2_init, transform_points(T_inv(f1.T_cw), p1),
        take_rows(f2.xy_und, tgt), take_rows(f2.ur, tgt),
        take_rows(f2.depth, tgt), res.inliers & pair_valid, cam, cfg.ba)
    use_ba = ba_res.n_inliers >= cfg.ransac.min_inliers
    T_cw2 = torch.where(use_ba[..., None, None], ba_res.T_cw, T_cw2_init)

    return OdometryResult(
        T_cw2=T_cw2,
        T12=T_cw2 @ T_inv(f1.T_cw),
        match_idx=m.target_idx,
        inliers=res.inliers,
        n_matches=torch.sum(m.valid.to(torch.int32), -1),
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

"""Tracking front-end: per-frame pose estimation against the map.

Port of `aslam_tpu/models/tracking.py`.  The per-frame program is
`track_step` (frame-to-frame odometry, association carry-over, tracking
against the local map, landmark statistics, the keyframe trigger's
distances); the device engine (`models/device_slam.py`) and the host class
`Tracking` both run it.  `bootstrap_track` acquires bindings with no prior
associations (after relocalization, at the start of a new sequence).  None
of these functions reads the device.

`Tracking` is the host state machine (NO_IMAGES -> OK / WEAK / LOST, and
NEW_SEQUENCE set by `SlamSystem`).  What it reads of the device, each
counted in `device.read_host.count`:

  * per tracked frame one packed vector: the 7 statistics, the first free
    keyframe slot, the live keyframe count, the pose and the pose relative
    to the reference keyframe;
  * on a LOST frame what relocalization reads, then one read of the
    re-acquired pose with its binding count, then one of the final pose;
  * on the first frame two (free slot, landmark count).

A keyframe insertion reads nothing of its own.  The RANSAC draws come from a
generator on the map's device; `Tracking.ransac_draws` optionally holds the
raw draws of the next tracked frames, in order (tests inject the
reference's).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.device import as_device, read_host, to_host
from aslam_tpu_torch.models import frame as frame_mod
from aslam_tpu_torch.models import mapstate as ms
from aslam_tpu_torch.models.extractor import init_grid_thresholds
from aslam_tpu_torch.models.frame import FrameData
from aslam_tpu_torch.models.odometry import rba_step, ricp_fused
from aslam_tpu_torch.ops import ba, matching
from aslam_tpu_torch.ops.index import set_rows
from aslam_tpu_torch.ops.select import topk_stable
from aslam_tpu_torch.utils import camera
from aslam_tpu_torch.utils.se3 import T_inv, pose_distance


def carry_associations(last_assoc: torch.Tensor, match_idx: torch.Tensor,
                       inliers: torch.Tensor) -> torch.Tensor:
    """Propagate landmark bindings [M] through frame-to-frame matches
    (last-frame feature -> current feature), keeping the larger id when two
    land on one feature."""
    M = last_assoc.shape[0]
    ok = (match_idx >= 0) & inliers & (last_assoc >= 0)
    tgt = torch.where(ok, match_idx.to(torch.int64), M)
    out = torch.full((M + 1,), -1, dtype=torch.int32, device=tgt.device)
    return out.scatter_reduce(0, tgt, torch.where(ok, last_assoc, -1),
                              "amax")[:M]


class LocalMapResult(NamedTuple):
    T_cw: torch.Tensor           # refined pose
    assoc: torch.Tensor          # [M] final landmark bindings (outliers dropped)
    n_tracked: torch.Tensor      # scalar int32 inlier landmark count
    visible_mask: torch.Tensor   # [L] frustum-visible landmarks
    found_mask: torch.Tensor     # [L] tracked-inlier landmarks
    local_kf_mask: torch.Tensor  # [K]
    n_overflow: torch.Tensor     # scalar int32: candidates over proj_match_cap


def _kf_mask(K: int, idx: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    return set_rows(torch.zeros(K, dtype=torch.bool, device=idx.device),
                    idx, on)


def track_local_map(m: ms.MapState, frame: FrameData, assoc: torch.Tensor,
                    cfg: SystemConfig,
                    prior_weight: float | torch.Tensor | None = None,
                    ) -> LocalMapResult:
    """Covisibility-voted local keyframes (one-hop expansion, cap
    local_map_max_kfs) -> their unbound landmarks in the frustum ->
    projection match -> pose-only BA over all bindings -> outlier bindings
    dropped.  The pose stays the frame's unless >= 10 bindings support it."""
    cam = cfg.camera
    K = m.kf_valid.shape[0]
    L = m.lm_pos.shape[0]
    M = assoc.shape[0]

    # 1. covisibility vote of the frame's bound landmarks
    a_ids = torch.clamp(assoc, min=0)
    a_ok = (assoc >= 0) & m.lm_valid[a_ids.to(torch.int64)]
    votes = ms.kf_votes_of_ids(m, a_ids, a_ok).to(torch.float32)
    kf_rank = torch.where(m.kf_valid & (votes > 0), votes, -1.0)
    k_cap = min(cfg.tracking.local_map_max_kfs, K)
    top_vals, top_idx = topk_stable(kf_rank, k_cap)
    local_kf = _kf_mask(K, top_idx, top_vals > 0)

    # 1b. one-hop expansion: non-voted KFs ranked by their strongest link to
    #     the top-8 voted members fill the remaining slots
    if cfg.tracking.local_map_expand:
        n_seed = min(8, k_cap)
        seed_rows = ms.covis_rows_fast(m, top_idx[:n_seed])
        seed_ok = (top_vals[:n_seed] > 0)[:, None]
        link = torch.amax(torch.where(seed_ok, seed_rows, 0), dim=0)
        exp_rank = torch.where(m.kf_valid & ~local_kf & (link > 0),
                               link.to(votes.dtype), -1.0)
        combined = torch.where(local_kf, votes + 1e6, exp_rank)
        top_vals, top_idx = topk_stable(combined, k_cap)
        local_kf = _kf_mask(K, top_idx, top_vals > 0)

    # 2. local landmarks not already bound
    local_lm = ms.landmark_mask_of_slots(m, top_idx, top_vals > 0)
    bound = set_rows(torch.zeros_like(m.lm_valid),
                     torch.where(assoc >= 0, assoc.to(torch.int64), L), True)
    search_lm = local_lm & ~bound

    # 3. frustum check + guided projection match over the compacted set
    vis, pred_uv, _, _ = camera.in_frustum(cam, frame.T_cw, m.lm_pos)
    cand = search_lm & vis
    cidx, cvalid, n_overflow = matching.compact_candidates(
        cand, min(cfg.map.proj_match_cap, L))
    pm = matching.projection_match(
        m.lm_desc[cidx], cvalid, pred_uv[cidx],
        frame.xy_und, frame.feat.desc, frame.feat.valid,
        frame.feat.octave, assoc < 0,
        radius=cfg.matcher.proj_radius,
        th_high=float(cfg.matcher.th_high),
        ratio=cfg.matcher.ratio_local,
    )
    new_tgt = torch.where(pm.valid, pm.target_idx.to(torch.int64), M)
    assoc2 = torch.cat([assoc, assoc.new_full((1,), -1)]).scatter_reduce(
        0, new_tgt, torch.where(pm.valid, cidx.to(torch.int32), -1),
        "amax")[:M]
    assoc2 = torch.where(assoc >= 0, assoc, assoc2)

    # 4. pose-only BA over all bound landmarks
    lm_idx = torch.where(assoc2 >= 0, assoc2, 0).to(torch.int64)
    obs_valid = (assoc2 >= 0) & m.lm_valid[lm_idx] & frame.feat.valid
    if prior_weight is None:
        prior_weight = cfg.tracking.pose_prior_weight
    res = ba.pose_only_ba(
        frame.T_cw, m.lm_pos[lm_idx], frame.xy_und, frame.ur, frame.depth,
        obs_valid, cam, cfg.ba, prior_weight=prior_weight)
    enough = torch.sum(obs_valid.to(torch.int32)) >= 10
    T_out = torch.where(enough, res.T_cw, frame.T_cw)

    # 5. drop outlier bindings; 6. visibility / found statistics
    assoc_final = torch.where(obs_valid & res.inliers, assoc2, -1)
    found = set_rows(torch.zeros_like(m.lm_valid),
                     torch.where(assoc_final >= 0,
                                 assoc_final.to(torch.int64), L), True)
    return LocalMapResult(
        T_cw=T_out,
        assoc=assoc_final,
        n_tracked=torch.sum((assoc_final >= 0).to(torch.int32)),
        visible_mask=cand | found,
        found_mask=found,
        local_kf_mask=local_kf,
        n_overflow=n_overflow,
    )


def bootstrap_track(m: ms.MapState, frame: FrameData, cfg: SystemConfig):
    """Acquire landmark bindings with no prior associations: the local map
    is the 10 keyframes nearest to the frame's (approximate) pose, searched
    by projection at twice the radius, then pose-only BA.
    -> (T_cw [4,4], assoc [M], n_tracked scalar int32)."""
    cam = cfg.camera
    K = m.kf_valid.shape[0]
    M = frame.xy_und.shape[0]
    L = m.lm_pos.shape[0]
    d_t, _ = pose_distance(m.kf_T_cw, frame.T_cw)
    rank = torch.where(m.kf_valid, -d_t, -torch.inf)
    top_vals, top_idx = topk_stable(rank, min(10, K))
    local_kf = _kf_mask(K, top_idx, top_vals > -torch.inf)

    search_lm = ms.landmark_mask_of_kfs(m, local_kf)
    vis, pred_uv, _, _ = camera.in_frustum(cam, frame.T_cw, m.lm_pos)
    cidx, cvalid, _ = matching.compact_candidates(
        search_lm & vis, min(cfg.map.proj_match_cap, L))
    pm = matching.projection_match(
        m.lm_desc[cidx], cvalid, pred_uv[cidx],
        frame.xy_und, frame.feat.desc, frame.feat.valid,
        frame.feat.octave, torch.ones_like(frame.feat.valid),
        radius=2.0 * cfg.matcher.proj_radius,   # wide: the pose is approximate
        th_high=float(cfg.matcher.th_high),
        ratio=cfg.matcher.ratio_local,
    )
    new_tgt = torch.where(pm.valid, pm.target_idx.to(torch.int64), M)
    assoc = torch.full((M + 1,), -1, dtype=torch.int32, device=new_tgt.device) \
        .scatter_reduce(0, new_tgt,
                        torch.where(pm.valid, cidx.to(torch.int32), -1),
                        "amax")[:M]
    lm_idx = torch.where(assoc >= 0, assoc, 0).to(torch.int64)
    obs_valid = (assoc >= 0) & m.lm_valid[lm_idx] & frame.feat.valid
    res = ba.pose_only_ba(
        frame.T_cw, m.lm_pos[lm_idx], frame.xy_und, frame.ur, frame.depth,
        obs_valid, cam, cfg.ba)
    assoc = torch.where(obs_valid & res.inliers, assoc, -1)
    return res.T_cw, assoc, torch.sum((assoc >= 0).to(torch.int32))


def update_lm_stats(m: ms.MapState, visible_mask: torch.Tensor,
                    found_mask: torch.Tensor) -> ms.MapState:
    return m._replace(
        lm_visible=m.lm_visible + visible_mask.to(torch.int32),
        lm_found=m.lm_found + found_mask.to(torch.int32))


def track_step(m: ms.MapState, last_frame: FrameData, last_assoc: torch.Tensor,
               frame: FrameData, last_kf_T: torch.Tensor,
               generator: torch.Generator | None, cfg: SystemConfig,
               draws: torch.Tensor | None = None):
    """The per-frame program: frame-to-frame odometry (ADAPTIVE_RBA, or
    ADAPTIVE_RICP under `cfg.use_gicp`), association carry-over, tracking
    against the local map, landmark statistics and the distances of the
    keyframe trigger.  `draws` optionally fixes the RANSAC samples (see
    `ops/ransac.py`).  -> (map, T_cw [4,4], assoc [M], stats [7] =
    [n_tracked, n_matches, ransac_inliers, kf_dist, kf_rot, rmse,
    proj_overflow])."""
    odometry = ricp_fused if cfg.use_gicp else rba_step
    odo = odometry(last_frame, frame, generator, cfg, draws=draws)
    frame = frame_mod.with_pose(frame, odo.T_cw2)
    assoc = carry_associations(last_assoc, odo.match_idx, odo.inliers)
    # the motion prior anchors the map solve only when odometry was healthy
    w_prior = torch.where(odo.n_inliers >= cfg.ransac.min_inliers,
                          cfg.tracking.pose_prior_weight, 0.0)
    lm_res = track_local_map(m, frame, assoc, cfg, prior_weight=w_prior)
    m = update_lm_stats(m, lm_res.visible_mask, lm_res.found_mask)
    dt, dr = pose_distance(last_kf_T, lm_res.T_cw)
    stats = torch.stack([
        lm_res.n_tracked.to(torch.float32), odo.n_matches.to(torch.float32),
        odo.n_inliers.to(torch.float32), dt, dr, odo.rmse,
        lm_res.n_overflow.to(torch.float32)])
    return m, lm_res.T_cw, lm_res.assoc, stats


def first_free_slot(m: ms.MapState) -> torch.Tensor:
    """0-d int64: the lowest keyframe row not in use (rows vacated by
    keyframe culling are reused); 0 when every row is taken."""
    return torch.argmin(m.kf_valid.to(torch.int32))


class Tracking:
    """Host-side orchestration of the per-frame pipeline, for a map on
    `device`."""

    def __init__(self, cfg: SystemConfig, device: torch.device | str,
                 seed: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        self.map = ms.init_map(cfg, self.device)
        self.grid = init_grid_thresholds(cfg.extractor, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.ransac_draws: list[torch.Tensor] = []
        self.state = "NO_IMAGES"
        self.n_kfs = 0
        self.kf_counter = 0
        self._n_lm: torch.Tensor | int = 0      # live landmarks, unread
        self.last_frame: FrameData | None = None
        self.last_assoc: torch.Tensor | None = None
        self.relocalizer = None  # set by SlamSystem when loop closing is on
        self.last_kf_T: torch.Tensor | None = None
        self.last_kf_id: int = -1
        self.poses: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self.new_kf_slots: list[int] = []
        self.stats: list[dict] = []
        # per-frame pose relative to the reference keyframe: T_cw(t) is
        # rebuilt at export time as T_cr(t) T_rw(final), so BA and loop
        # corrections propagate into the whole trajectory
        self.ref_kf_ids: list[int] = []
        self.rel_poses: list[np.ndarray] = []

    @property
    def next_lm(self) -> int:
        """Live landmark count as of the last keyframe insertion (one read
        when it has not been read yet)."""
        if isinstance(self._n_lm, torch.Tensor):
            self._n_lm = read_host(self._n_lm)[0]
        return self._n_lm

    @next_lm.setter
    def next_lm(self, n: int) -> None:
        self._n_lm = int(n)

    def make_frame(self, img, depth) -> FrameData:
        """Extraction: an image pair (numpy or tensors, sensor dtypes or
        float32 gray / metres) -> FrameData at the identity pose, carrying
        the adaptive threshold grid on."""
        frame, self.grid = frame_mod.make_frame(
            as_device(img, self.device), as_device(depth, self.device),
            self.cfg, self.grid)
        return frame

    def _insert_keyframe(self, frame: FrameData, assoc: torch.Tensor,
                         max_new: int, slot: int,
                         n_live: int) -> torch.Tensor:
        """`frame` into row `slot` (the first free one, read by the caller
        together with the live count `n_live`)."""
        kf_id = self.kf_counter
        self.map = ms.insert_keyframe(self.map, frame, assoc, slot, kf_id)
        self.map, assoc, _ = ms.create_landmarks(
            self.map, frame, assoc, slot, kf_id, max_new=max_new,
            th_depth=float(self.cfg.camera.th_depth))
        self._n_lm = torch.sum(self.map.lm_valid, dtype=torch.int32)
        self.n_kfs = n_live + 1
        self.last_kf_id = kf_id
        self.kf_counter += 1
        self.last_kf_T = frame.T_cw
        self.new_kf_slots.append(slot)
        return assoc

    def track(self, img, depth, t: float = 0.0):
        """Process one RGB-D frame -> (T_cw ndarray, info dict)."""
        return self.track_frame(self.make_frame(img, depth), t)

    def read_pose(self, frame: FrameData):
        """(T_cw, T_cr) of `frame` as numpy, one read."""
        T_cr = frame.T_cw @ T_inv(self.last_kf_T)
        both = to_host(torch.stack([frame.T_cw, T_cr]))
        return both[0], both[1]

    def track_frame(self, frame: FrameData, t: float = 0.0):
        """`track` from the extracted frame on."""
        cfg = self.cfg
        info = {"new_kf": False}
        M = cfg.extractor.max_keypoints

        if self.state == "NO_IMAGES":
            slot, n_live = read_host(first_free_slot(self.map),
                                     torch.sum(self.map.kf_valid))
            assoc = torch.full((M,), -1, dtype=torch.int32, device=self.device)
            T = np.eye(4, dtype=np.float32)
            assoc = self._insert_keyframe(frame, assoc, M, slot, n_live)
            self.state = "OK"
            info["new_kf"] = True
            info["n_tracked"] = read_host(torch.sum(assoc >= 0))[0]
            T_cr = T.copy()
        else:
            draws = self.ransac_draws.pop(0) if self.ransac_draws else None
            self.map, T_cw, assoc, stats_d = track_step(
                self.map, self.last_frame, self.last_assoc, frame,
                self.last_kf_T, self.generator, cfg, draws=draws)
            frame = frame_mod.with_pose(frame, T_cw)
            # the one read of a tracked frame
            packed = to_host(torch.cat([
                stats_d,
                torch.stack([first_free_slot(self.map),
                             torch.sum(self.map.kf_valid)]).to(torch.float32),
                T_cw.reshape(-1),
                (T_cw @ T_inv(self.last_kf_T)).reshape(-1)]))
            stats = packed[:7]
            slot, n_live = int(packed[7]), int(packed[8])
            T = packed[9:25].reshape(4, 4)
            T_cr = packed[25:41].reshape(4, 4)

            n_tracked = int(stats[0])
            n_inliers = int(stats[2])
            info.update(n_tracked=n_tracked, n_matches=int(stats[1]),
                        ransac_inliers=n_inliers, proj_overflow=int(stats[6]))

            # Two failure modes.  WEAK: the local map gave fewer than
            # min_matches_tracked bindings but the odometry is healthy (the
            # camera enters unmapped territory): keep the pose and keep
            # inserting keyframes, so that the map grows into it.  LOST: the
            # odometry itself failed (sensor dropout, blur, no depth):
            # relocalize, else the motion model and re-acquisition.
            odo_ok = n_inliers >= cfg.ransac.min_inliers
            moved = False
            if n_tracked < cfg.tracking.min_matches_tracked and odo_ok:
                self.state = "WEAK"
            elif n_tracked < cfg.tracking.min_matches_tracked:
                self.state = "LOST"
                if self.relocalizer is not None:
                    T_reloc = self.relocalizer.relocalize(self.map, frame)
                    if T_reloc is not None:
                        frame = frame_mod.with_pose(
                            frame, torch.from_numpy(T_reloc).to(self.device))
                        assoc = torch.full_like(assoc, -1)
                        self.state = "OK"
                        info["relocalized"] = True
                        moved = True
                if (self.state == "LOST"
                        and cfg.tracking.lost_policy == "motion_model"
                        and len(self.poses) >= 2):
                    # no relocalizer, or it failed: constant-velocity
                    # extrapolation in place of the failed estimate, then
                    # re-acquire map bindings at the predicted pose.  Without
                    # this the covisibility vote of track_local_map has no
                    # seed and the system would stay LOST for good.
                    T_pred = (self.poses[-1] @ np.linalg.inv(self.poses[-2])
                              @ self.poses[-1])
                    frame = frame_mod.with_pose(
                        frame, torch.from_numpy(
                            T_pred.astype(np.float32)).to(self.device))
                    T_b, assoc_b, n_b = bootstrap_track(self.map, frame, cfg)
                    if read_host(n_b)[0] >= cfg.tracking.min_matches_tracked:
                        frame = frame_mod.with_pose(frame, T_b)
                        assoc = assoc_b
                        self.state = "OK"
                        info["reacquired"] = True
                    else:
                        assoc = torch.full_like(assoc, -1)
                        info["motion_model"] = True
                    moved = True
            else:
                self.state = "OK"
            if moved:
                T, T_cr = self.read_pose(frame)

            # keyframe decision; the capacity check is on live keyframes
            # (culled rows are reusable)
            need = (stats[3] > cfg.tracking.kf_min_trans
                    or stats[4] > cfg.tracking.kf_min_rot)
            if info.get("relocalized") or self.state == "LOST":
                # the pose delta from before a relocalization means nothing,
                # and a LOST frame must not spend a keyframe on an
                # extrapolated pose
                need = False
            if need and self.n_kfs < cfg.map.max_keyframes:
                assoc = self._insert_keyframe(
                    frame, assoc, cfg.tracking.max_vo_points, slot, n_live)
                info["new_kf"] = True
                # the frame is its own reference keyframe
                T_cr = T @ np.linalg.inv(T)

        self.last_frame = frame
        self.last_assoc = assoc
        self.poses.append(T)
        self.timestamps.append(t)
        self.stats.append(info)
        self.record_relative_pose(T_cr)
        return T, info

    def record_relative_pose(self, T_cr: np.ndarray) -> None:
        """Append this frame's (reference-keyframe id, T_cr) record."""
        self.ref_kf_ids.append(self.last_kf_id)
        self.rel_poses.append(np.asarray(T_cr))

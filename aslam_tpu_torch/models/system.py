"""SLAM system facade of the host engine: tracking + local mapping (+ loop
closing), multi-sequence anchoring and the trajectory exports.

Port of `aslam_tpu/models/system.py`.  Frames go through `Tracking`; each
inserted keyframe is refined by `LocalMapping` and handed to `LoopClosing`,
and the tracker's reference pose is refreshed from the refined map.  The
stages run in turn on the caller's thread: every map update returns a new
map, so nothing is locked.

Host reads beyond what those classes read themselves: one per anchored
sequence (its pose), and the exports.
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.device import to_host
from aslam_tpu_torch.models import frame as frame_mod
from aslam_tpu_torch.models import mapstate as ms
from aslam_tpu_torch.models.localmapping import LocalMapping
from aslam_tpu_torch.models.loopclosing import LoopClosing
from aslam_tpu_torch.models.tracking import Tracking, bootstrap_track
from aslam_tpu_torch.utils import trajectory


class SlamSystem:
    def __init__(self, cfg: SystemConfig | None = None,
                 device: torch.device | str = "cuda", seed: int = 0):
        self.cfg = cfg or SystemConfig()
        self.device = torch.device(device)
        self.tracking = Tracking(self.cfg, self.device, seed=seed)
        self.local_mapping = LocalMapping(self.cfg)
        self.loop_closing = None
        if self.cfg.use_loop_closing:
            self.loop_closing = LoopClosing(self.cfg, self.device)
            self.tracking.relocalizer = self.loop_closing

    def process(self, img, depth, t: float = 0.0):
        """One RGB-D frame -> (T_cw ndarray, info dict)."""
        return self.process_frame(self.tracking.make_frame(img, depth), t)

    def process_frame(self, frame: frame_mod.FrameData, t: float = 0.0):
        """`process` from the extracted frame on."""
        tr = self.tracking
        if tr.state == "NEW_SEQUENCE":
            return self._anchor_new_sequence(frame, t)
        T, info = tr.track_frame(frame, t)
        if info.get("new_kf"):
            slot = tr.new_kf_slots[-1]
            kf_id = tr.kf_counter - 1
            tr.map = self.local_mapping.process_keyframe(
                tr.map, slot, kf_id, tr.n_kfs)
            if self.loop_closing is not None:
                tr.map = self.loop_closing.process_keyframe(tr.map, slot, kf_id)
            # local BA or a loop correction moved the reference keyframe:
            # the keyframe trigger and the recorded relative poses measure
            # from its current pose
            tr.last_kf_T = tr.map.kf_T_cw[slot]
        return T, info

    def new_sequence(self) -> None:
        """Start a new input sequence into the same map.  The tracking state
        resets; the first frame of the new sequence is anchored by
        relocalization against the map (with loop closing and a
        vocabulary), else it continues from the last keyframe's pose."""
        tr = self.tracking
        tr.last_frame = None
        tr.last_assoc = None
        tr.state = "NEW_SEQUENCE"

    def _anchor_new_sequence(self, frame: frame_mod.FrameData, t_stamp: float):
        tr = self.tracking
        T0 = None
        if self.loop_closing is not None:
            T0 = self.loop_closing.relocalize(tr.map, frame)
        relocalized = T0 is not None
        if relocalized:
            T0 = torch.from_numpy(T0).to(self.device)
        elif tr.last_kf_T is not None:
            T0 = tr.last_kf_T
        else:
            T0 = torch.eye(4, device=self.device)
        if tr.last_kf_T is None:
            tr.last_kf_T = torch.eye(4, device=self.device)
        frame = frame_mod.with_pose(frame, T0)
        # bindings from the existing map, so that tracking has a
        # covisibility seed
        T_b, assoc, n_b = bootstrap_track(tr.map, frame, self.cfg)
        # the refined pose needs >= 10 bindings behind it
        frame = frame_mod.with_pose(frame, torch.where(n_b >= 10, T_b, T0))
        T, T_cr = tr.read_pose(frame)
        tr.last_frame = frame
        tr.last_assoc = assoc
        tr.state = "OK"
        tr.poses.append(T)
        tr.timestamps.append(t_stamp)
        tr.stats.append({"new_sequence": True})
        tr.record_relative_pose(T_cr)
        return T, {"new_sequence": True, "relocalized": relocalized}

    # -- exports ---------------------------------------------------------
    def rebuilt_trajectory(self) -> np.ndarray:
        """`rebuild_trajectory` over the session (three reads of the
        keyframe table)."""
        tr = self.tracking
        m = tr.map
        return trajectory.rebuild_trajectory(
            to_host(m.kf_valid), to_host(m.kf_id), to_host(m.kf_T_cw),
            self.local_mapping.culled, tr.ref_kf_ids, tr.rel_poses, tr.poses)

    def save_trajectory(self, path: str, corrected: bool = True) -> None:
        poses = (self.rebuilt_trajectory()
                 if corrected and self.tracking.rel_poses
                 else np.stack(self.tracking.poses))
        trajectory.save_tum_trajectory(
            path, np.asarray(self.tracking.timestamps), poses)

    def save_keyframe_trajectory(self, path: str) -> None:
        m = self.tracking.map
        valid = to_host(m.kf_valid)
        poses = to_host(m.kf_T_cw)[valid]
        ids = to_host(m.kf_id)[valid]
        order = np.argsort(ids)
        trajectory.save_tum_trajectory(path, ids[order].astype(np.float64),
                                       poses[order])

    def save_observation_histogram(self, path: str) -> None:
        """Histogram.csv: how many landmarks have n observing keyframes."""
        m = self.tracking.map
        obs = to_host(ms.observation_counts(m))
        counts = np.bincount(obs[to_host(m.lm_valid)], minlength=1)
        with open(path, "w") as f:
            f.write("n_observations,n_landmarks\n")
            for n, c in enumerate(counts):
                f.write(f"{n},{int(c)}\n")

    @property
    def map(self) -> ms.MapState:
        return self.tracking.map


"""Batched visual odometry: B independent sequences per frame step.

Port of `aslam_tpu/models/batch_vo.py`.  The reference `vmap`s the frame
pipeline over a sequence axis; here the VO path's functions broadcast over a
leading [B] dimension instead (`torch.func.vmap` cannot see through the
ctypes kernel call and loops where an op has no batching rule).  So one
batched step issues about the launches of one single-frame step, whatever B
is: extraction, matching (one `hamming_top2` launch for the B pairs),
RANSAC and motion-only BA each take the lanes together.  Per module:

  * `utils/se3.py`, `utils/camera.py`, `ops/linalg.py` broadcast already;
  * `ops/{pyramid,fast,detectors,select,orb,desc,hamming,matching,ransac,
    ba}.py`, `models/extractor.py::_extract_impl`, `models/frame.py::
    _make_frame_impl` and `models/odometry.py::{ransac_step,rba_step,
    track_frame}` take [..., H, W] images and [..., K] keypoints, with the
    single-frame call as the leading dims absent.  Gathers and scatters
    index per lane (lane offsets, exact); a single frame runs what it ran
    before, bit for bit.

Every detector and descriptor family runs batched.  A lane's results equal
its single-frame chain's up to the rounding of batched matmuls (the pyramid
resize, the IC angle, the BA's normal equations), which can move a
near-tied keypoint or descriptor bit.

The RANSAC samples come from one `torch.Generator` on the device, [B,H,S]
per step in one launch, so `process_chunk` and T `process` calls draw the
same numbers and give the same bits.  Every entry takes optional `draws`
instead ([B,H,S] per step, [B,T,H,S] per chunk), as the single-frame
functions do.
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.device import as_device
from aslam_tpu_torch.models import frame as frame_mod
from aslam_tpu_torch.models.extractor import init_grid_thresholds
from aslam_tpu_torch.models.odometry import (OdometryResult, SequenceResult,
                                             rba_step, track_frame)


def batch_frame(imgs: torch.Tensor, depths: torch.Tensor,
                grids: torch.Tensor, cfg: SystemConfig):
    """imgs, depths [B,H,W], grids [B,g,g] -> (batched FrameData at the
    identity pose, new grids [B,g,g])."""
    if imgs.dim() != 3 or grids.dim() != 3:
        raise ValueError(f"batch_frame takes [B,H,W] images and [B,g,g] "
                         f"grids, got {tuple(imgs.shape)} and "
                         f"{tuple(grids.shape)}")
    return frame_mod._make_frame_impl(imgs, depths, grids, cfg)


def batch_rba(frames_prev: frame_mod.FrameData,
              frames_cur: frame_mod.FrameData,
              generator: torch.Generator | None, cfg: SystemConfig,
              draws: torch.Tensor | None = None) -> OdometryResult:
    """Frame-to-frame odometry (ADAPTIVE_RBA) over the sequence batch:
    every field of the result has a leading [B]."""
    return rba_step(frames_prev, frames_cur, generator, cfg, draws=draws)


def batch_track_sequence(prev: frame_mod.FrameData, imgs: torch.Tensor,
                         depths: torch.Tensor, grids: torch.Tensor,
                         generator: torch.Generator | None,
                         cfg: SystemConfig,
                         draws: torch.Tensor | None = None):
    """B sequences x T frames: imgs, depths [B,T,H,W], prev a batched
    FrameData, grids [B,g,g], draws optionally [B,T,H,S].  A Python loop
    over T of batched `track_frame` steps.  -> (last frames, grids,
    SequenceResult with leading [B,T] axes)."""
    outs = []
    for i in range(imgs.shape[1]):
        prev, grids, res = track_frame(
            prev, imgs[:, i].contiguous(), depths[:, i].contiguous(), grids,
            generator, cfg, draws=None if draws is None else draws[:, i])
        outs.append(res)
    return prev, grids, SequenceResult(
        T_cw=torch.stack([r.T_cw2 for r in outs], 1),
        n_matches=torch.stack([r.n_matches for r in outs], 1),
        n_inliers=torch.stack([r.n_inliers for r in outs], 1),
        rmse=torch.stack([r.rmse for r in outs], 1),
    )


class BatchVisualOdometry:
    """Track B sequences in lockstep; poses stay on the device until
    `trajectories()` reads them back once."""

    def __init__(self, cfg: SystemConfig, batch: int,
                 device: torch.device | str = "cuda", seed: int = 0,
                 generator: torch.Generator | None = None):
        """`generator` draws the RANSAC samples; it must live on `device`
        (one seeded with `seed` when None)."""
        self.cfg = cfg
        self.batch = batch
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        g = init_grid_thresholds(cfg.extractor, self.device)
        self.grids = g.expand((batch,) + g.shape).contiguous()
        self.prev: frame_mod.FrameData | None = None
        self.pose_buf: list[torch.Tensor] = []
        # the last step's odometry, [B] per field, on the device (not read)
        self.last: OdometryResult | None = None

    def process(self, imgs, depths, draws: torch.Tensor | None = None):
        """imgs, depths [B,H,W] (uint8 / uint16 / float, numpy or tensor);
        draws optionally [B,H,S] -> T_cw [B,4,4] on the device."""
        imgs, depths = as_device(imgs, self.device), as_device(depths,
                                                               self.device)
        frames, self.grids = batch_frame(imgs, depths, self.grids, self.cfg)
        if self.prev is not None:
            self.last = batch_rba(self.prev, frames, self.generator,
                                  self.cfg, draws=draws)
            frames = frames._replace(T_cw=self.last.T_cw2)
            self.pose_buf.append(self.last.T_cw2)
        self.prev = frames
        return frames.T_cw

    def process_chunk(self, imgs, depths, draws: torch.Tensor | None = None):
        """imgs, depths [B,T,H,W], uploaded once; draws optionally
        [B,T',H,S] for the T' frames the chunk tracks (T - 1 when it starts
        the sequences).  Equal to T `process` calls, bit for bit."""
        imgs, depths = as_device(imgs, self.device), as_device(depths,
                                                               self.device)
        start = 0
        if self.prev is None:
            self.process(imgs[:, 0].contiguous(),
                         depths[:, 0].contiguous())
            start = 1
        if imgs.shape[1] - start <= 0:
            return self.prev.T_cw
        last, self.grids, seq = batch_track_sequence(
            self.prev, imgs[:, start:], depths[:, start:], self.grids,
            self.generator, self.cfg, draws=draws)
        self.prev = last
        self.pose_buf.extend(seq.T_cw.unbind(1))
        return last.T_cw

    def trajectories(self) -> np.ndarray:
        """[F-1, B, 4, 4] pose chain of the tracked frames (one readback)."""
        return torch.stack(self.pose_buf).cpu().numpy()

"""Visual-odometry driver: frame-to-frame tracking without mapping.

Port of `aslam_tpu/models/vo.py::VisualOdometry`, the engine of the CLI's
`--mode vo` (config 1).  Host Python feeds one RGB-D frame at a time; the
frame goes to the device in its sensor dtypes (uint8 gray, uint16 depth
counts) and all the math is `track_frame`.
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.models import frame as frame_mod
from aslam_tpu_torch.models.extractor import init_grid_thresholds
from aslam_tpu_torch.models.odometry import track_frame


class VisualOdometry:
    def __init__(self, cfg: SystemConfig, device: torch.device | str,
                 generator: torch.Generator | None = None):
        """`generator` draws the RANSAC samples; it must live on `device`
        (a fresh one seeded with 0 when None)."""
        self.cfg = cfg
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self.generator = generator
        self.grid = init_grid_thresholds(cfg.extractor, self.device)
        self.prev: frame_mod.FrameData | None = None
        self.poses: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self.stats: list[dict] = []

    def process(self, img: np.ndarray, depth: np.ndarray,
                t: float = 0.0) -> np.ndarray:
        """Feed one RGB-D frame; returns the estimated T_cw [4,4]."""
        img_d = torch.from_numpy(np.array(img)).to(self.device)
        depth_d = torch.from_numpy(np.array(depth)).to(self.device)
        if self.prev is None:
            f, self.grid = frame_mod.make_frame(img_d, depth_d, self.cfg,
                                                self.grid)
        else:
            f, self.grid, res = track_frame(self.prev, img_d, depth_d,
                                            self.grid, self.generator, self.cfg)
            # four scalars read back per frame, as the returned pose is
            self.stats.append({
                "n_matches": int(res.n_matches),
                "n_inliers": int(res.n_inliers),
                "rmse": float(res.rmse),
                "ba_inliers": int(res.ba_inliers),
            })
        self.prev = f
        T = f.T_cw.cpu().numpy()
        self.poses.append(T)
        self.timestamps.append(t)
        return T

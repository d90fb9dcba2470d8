"""Carry the JAX package's values across into the port's tensors.

The inputs are numpy arrays (`np.asarray` of the JAX arrays), or objects
whose attributes are; nothing here imports jax.  The tests use these so
that both sides start from the same frame:

  * `frame_data`: a FrameData-shaped object -> the port's FrameData, with
    the uint32 descriptor words viewed as int32;
  * `grid_thresholds`: the adaptive [g,g] grid;
  * `system_config`: a SystemConfig given as its field dict
    (`dataclasses.asdict`).
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch import config as cfg_mod
from aslam_tpu_torch.models.extractor import Features
from aslam_tpu_torch.models.frame import FrameData


def tensor(a, device: torch.device | str) -> torch.Tensor:
    """numpy array -> tensor on `device`; uint32 words become int32 views."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def features(f, device: torch.device | str) -> Features:
    return Features(*(tensor(getattr(f, name), device)
                      for name in Features._fields))


def frame_data(f, device: torch.device | str) -> FrameData:
    return FrameData(feat=features(f.feat, device),
                     **{name: tensor(getattr(f, name), device)
                        for name in FrameData._fields if name != "feat"})


def grid_thresholds(g, device: torch.device | str) -> torch.Tensor:
    return tensor(np.asarray(g, np.float32), device)


_SECTIONS = {
    "camera": cfg_mod.CameraModel,
    "extractor": cfg_mod.ExtractorConfig,
    "matcher": cfg_mod.MatcherConfig,
    "ransac": cfg_mod.RansacConfig,
    "icp": cfg_mod.ICPConfig,
    "ba": cfg_mod.BAConfig,
    "tracking": cfg_mod.TrackingConfig,
    "map": cfg_mod.MapConfig,
    "loop": cfg_mod.LoopConfig,
    "mesh": cfg_mod.MeshConfig,
}


def system_config(fields: dict) -> cfg_mod.SystemConfig:
    """A SystemConfig field dict (nested dicts per section) -> the port's."""
    kw = {k: (_SECTIONS[k](**v) if k in _SECTIONS else v)
          for k, v in fields.items()}
    return cfg_mod.SystemConfig(**kw)

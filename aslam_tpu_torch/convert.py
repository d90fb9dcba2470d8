"""Carry the JAX package's values across into the port's tensors.

The inputs are numpy arrays (`np.asarray` of the JAX arrays), or objects
whose attributes are; nothing here imports jax.  The tests use these so
that both sides start from the same frame:

  * `frame_data`: a FrameData-shaped object -> the port's FrameData, with
    the uint32 descriptor words viewed as int32;
  * `grid_thresholds`: the adaptive [g,g] grid;
  * `map_state` / `slam_state`: a MapState / SlamState-shaped object ->
    the port's (the SlamState's host counters become Python ints);
  * `system_config`: a SystemConfig given as its field dict
    (`dataclasses.asdict`);
  * `icp_result`, `pose_graph`, `vocabulary`, `database_state`: the
    NamedTuples of the ICP and loop-closing slice;
  * `loop_closing_state`: the vocabulary, database and host-side gate state
    of a reference `LoopClosing` into the port's object, so that it
    continues from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch import config as cfg_mod
from aslam_tpu_torch.models.extractor import Features
from aslam_tpu_torch.models.frame import FrameData
from aslam_tpu_torch.models.mapstate import MapState


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


def map_state(m, device: torch.device | str) -> MapState:
    return MapState(**{name: tensor(getattr(m, name), device)
                       for name in MapState._fields})


def slam_state(s, device: torch.device | str):
    from aslam_tpu_torch.models.device_slam import SlamState

    host = ("kf_counter", "recent_n")
    fields = {name: tensor(getattr(s, name), device)
              for name in SlamState._fields
              if name not in host + ("m", "last_frame")}
    return SlamState(m=map_state(s.m, device),
                     last_frame=frame_data(s.last_frame, device),
                     **{name: int(np.asarray(getattr(s, name)))
                        for name in host}, **fields)


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


def _named(cls, x, device):
    return cls(**{name: tensor(getattr(x, name), device)
                  for name in cls._fields})


def icp_result(r, device: torch.device | str):
    from aslam_tpu_torch.ops.icp import ICPResult

    return _named(ICPResult, r, device)


def pose_graph(pg, device: torch.device | str):
    from aslam_tpu_torch.ops.pose_graph import PoseGraph

    return _named(PoseGraph, pg, device)


def vocabulary(v, device: torch.device | str):
    """A Vocabulary-shaped object (level_cents: uint32 arrays, idf)."""
    from aslam_tpu_torch.ops.bow import Vocabulary

    return Vocabulary(level_cents=tuple(tensor(c, device)
                                        for c in v.level_cents),
                      idf=tensor(np.asarray(v.idf, np.float32), device))


def database_state(db, device: torch.device | str):
    from aslam_tpu_torch.models.loopclosing import DatabaseState

    return _named(DatabaseState, db, device)


def loop_closing_state(lc_ref, lc_port) -> None:
    """Carry a reference LoopClosing's vocabulary, database, consistency
    groups and loop bookkeeping into the port's `lc_port`, in place."""
    dev = lc_port.device
    lc_port.vocab = (None if lc_ref.vocab is None
                     else vocabulary(lc_ref.vocab, dev))
    lc_port.db = database_state(lc_ref.db, dev)
    lc_port.trained_on_kfs = int(lc_ref.trained_on_kfs)
    lc_port.last_loop_kf_id = int(lc_ref.last_loop_kf_id)
    lc_port.consistent_groups = [(set(int(i) for i in g), int(c))
                                 for g, c in lc_ref.consistent_groups]
    lc_port.loops = [(int(q), int(c)) for q, c in lc_ref.loops]
    lc_port.consistent_revisits = [(int(q), int(c))
                                   for q, c in lc_ref.consistent_revisits]

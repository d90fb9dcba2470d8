"""Map checkpoint / resume of the host engine.

Port of `aslam_tpu/utils/checkpoint.py`, with the same field names and npz
layout: one compressed npz of the MapState's arrays, a JSON sidecar of the
host counters, and with loop closing the vocabulary and the BoW database
beside them.  So `load_map` / `load_system` also read a checkpoint the JAX
package wrote: descriptors stored as uint32 words come back as the port's
int32 words with the same bits.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.convert import tensor
from aslam_tpu_torch.device import to_host
from aslam_tpu_torch.models import mapstate as ms
from aslam_tpu_torch.models.mapstate import MapState
from aslam_tpu_torch.ops import bow

_META_SUFFIX = ".meta.json"


def _words_u32(name: str, a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if name.endswith("desc") else a


def save_map(path: str, m: MapState, counters: dict | None = None) -> None:
    """One read per field (a checkpoint is written outside the frame loop)."""
    arrays = {f: _words_u32(f, to_host(getattr(m, f))) for f in m._fields}
    np.savez_compressed(path, **arrays)
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(counters or {}, f)


def load_map(path: str, device: torch.device | str,
             cfg: SystemConfig | None = None) -> tuple[MapState, dict]:
    """-> (MapState on `device`, counters).  A checkpoint from before the
    observer index existed gets it rebuilt from `kf_lm`, at
    `cfg.map.max_obs_per_lm` entries per landmark (the reference hardcodes
    16 there)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    fields = {f: tensor(data[f], device) for f in MapState._fields if f in data}
    if "lm_obs_kf" not in fields:
        L = fields["lm_pos"].shape[0]
        O = (cfg or SystemConfig()).map.max_obs_per_lm
        fields["lm_obs_kf"] = torch.full((L, O), -1, dtype=torch.int32,
                                         device=device)
        fields["lm_obs_feat"] = torch.zeros((L, O), dtype=torch.int32,
                                            device=device)
        fields["lm_obs_ptr"] = torch.zeros((L,), dtype=torch.int32,
                                           device=device)
        m = ms.rebuild_observer_index(MapState(**fields))
    else:
        m = MapState(**fields)
    base = path.removesuffix(".npz")
    counters = {}
    for candidate in (path + _META_SUFFIX, base + _META_SUFFIX):
        if os.path.exists(candidate):
            with open(candidate) as f:
                counters = json.load(f)
            break
    return m, counters


def save_system(path_prefix: str, slam) -> None:
    """Persist a SlamSystem: the map, the tracking counters and, when loop
    closing has a vocabulary, the vocabulary and the BoW database."""
    t = slam.tracking
    lc = slam.loop_closing
    save_map(path_prefix, t.map, {
        "n_kfs": t.n_kfs,
        "next_lm": t.next_lm,
        "kf_counter": t.kf_counter,
        "state": t.state,
        "last_loop_kf_id": lc.last_loop_kf_id if lc else None,
        "vocab_trained_on_kfs": lc.trained_on_kfs if lc else None,
    })
    if lc is not None and lc.vocab is not None:
        base = path_prefix.removesuffix(".npz")
        bow.save_vocabulary(base + ".vocab.npz", lc.vocab)
        np.savez_compressed(
            base + ".loopdb.npz",
            **{f: to_host(getattr(lc.db, f)) for f in lc.db._fields})


def load_system(path_prefix: str, slam) -> None:
    """Restore `save_system`'s output into a fresh SlamSystem, on its
    device.  The per-frame state (last frame, associations) is not
    persisted: the next frame re-anchors against the restored map as a new
    sequence does (relocalization + `bootstrap_track`)."""
    from aslam_tpu_torch.models.loopclosing import DatabaseState

    t = slam.tracking
    m, counters = load_map(path_prefix, slam.device, slam.cfg)
    if m.kf_lm.shape != t.map.kf_lm.shape or m.lm_pos.shape != t.map.lm_pos.shape:
        raise ValueError(
            f"checkpoint {path_prefix}: map of {tuple(m.kf_lm.shape)} keyframe "
            f"features and {m.lm_pos.shape[0]} landmarks does not fit the "
            f"configured {tuple(t.map.kf_lm.shape)} and "
            f"{t.map.lm_pos.shape[0]}")
    t.map = m
    t.n_kfs = counters.get("n_kfs", 0)
    t.next_lm = counters.get("next_lm", 0)
    t.kf_counter = counters.get("kf_counter", 0)
    state = counters.get("state", "NO_IMAGES")
    if state != "NO_IMAGES":
        state = "NEW_SEQUENCE"
        kf_valid = to_host(m.kf_valid)
        if t.last_kf_T is None and kf_valid.any():
            ids = to_host(m.kf_id)
            last = int(np.nonzero(kf_valid)[0][np.argmax(ids[kf_valid])])
            t.last_kf_T = m.kf_T_cw[last]
            t.last_kf_id = int(ids[last])
    t.state = state

    lc = slam.loop_closing
    if lc is not None:
        base = path_prefix.removesuffix(".npz")
        if os.path.exists(base + ".vocab.npz"):
            lc.vocab = bow.load_vocabulary(base + ".vocab.npz", slam.device)
        if os.path.exists(base + ".loopdb.npz"):
            data = np.load(base + ".loopdb.npz")
            lc.db = DatabaseState(**{f: tensor(data[f], slam.device)
                                     for f in DatabaseState._fields})
        if counters.get("last_loop_kf_id") is not None:
            lc.last_loop_kf_id = counters["last_loop_kf_id"]
        if counters.get("vocab_trained_on_kfs") is not None:
            lc.trained_on_kfs = counters["vocab_trained_on_kfs"]

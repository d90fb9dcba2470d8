"""Device-resident SLAM: feature extraction, odometry, tracking against the
local map, keyframe insertion and the inline local mapping, per frame.

Port of `aslam_tpu/models/device_slam.py`: config 2, config 3
(`use_gicp`: the odometry is `ricp_fused`, RANSAC then GICP where RANSAC is
poor, with no host read of its own) and loop closing (`use_loop_closing`: at
the sync cadence the host reads the insertion ring once and hands the fresh
keyframes to `LoopClosing.process_keyframes_batch`).  The reference keeps
every branch on the device under `lax.cond`; here each branch is a host `if`
on a value the host either knows or reads:

  * the keyframe id is a host mirror of the reference's `kf_counter`;
  * the keyframe-insertion branch reads `need_kf` and the first free slot
    together: one `read_host` per tracked frame;
  * inside the inserted keyframe's mapping, the cadence gates on `kf_id`
    are host arithmetic, and the local-BA gate (> 2 live keyframes) reads
    one scalar when the cadence lets it run.

`lax.scan` over a chunk becomes a Python loop over `slam_step` with one
`torch.Generator` for the RANSAC draws, so a chunked run equals the
frame-by-frame run as long as the sync cadence does nothing between frames
(with loop closing, or without inline mapping, a chunk syncs at its end
where the stream syncs inside it).

`save` writes the whole session (state, trajectory buffers, culled
registry, the generators' states, loop closing's vocabulary, database and
gates) so that `resume`, in a fresh object, continues draw for draw as the
uninterrupted run would; the file carries a fingerprint of the config's
capacities and `resume` refuses one that does not match.  `new_sequence`
anchors the first frame of another sequence in the same map.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.device import as_device, read_host, to_host
from aslam_tpu_torch.models import frame as frame_mod
from aslam_tpu_torch.models import mapstate as ms
from aslam_tpu_torch.models.extractor import Features, init_grid_thresholds
from aslam_tpu_torch.models.localmapping import (empty_cull_info,
                                                 map_keyframe_body,
                                                 map_keyframe_fused)
from aslam_tpu_torch.models.loopclosing import LoopClosing
from aslam_tpu_torch.models.tracking import (bootstrap_track, first_free_slot,
                                             track_step)
from aslam_tpu_torch.utils.se3 import T_inv
from aslam_tpu_torch.utils.trajectory import rebuild_trajectory


class SlamState(NamedTuple):
    m: ms.MapState
    last_frame: frame_mod.FrameData
    last_assoc: torch.Tensor     # [M]
    last_kf_T: torch.Tensor      # [4,4]
    grid_thresholds: torch.Tensor
    n_kfs: torch.Tensor          # scalar int32 live keyframes
    next_lm: torch.Tensor        # scalar int32
    kf_counter: int              # host mirror: id of the next keyframe
    # insertion ring: slots / ids of keyframes inserted since the last sync
    recent_slots: torch.Tensor   # [R] int32
    recent_ids: torch.Tensor     # [R] int32
    recent_n: int                # host mirror: raw count (> R = overflow)


def init_slam(cfg: SystemConfig, img: torch.Tensor, depth: torch.Tensor,
              ring: int = 128) -> SlamState:
    """Bootstrap: the first frame becomes KF 0 in slot 0, with landmarks from
    every valid-depth keypoint."""
    dev = img.device
    frame, grid = frame_mod.make_frame(img, depth, cfg,
                                       init_grid_thresholds(cfg.extractor, dev))
    M = cfg.extractor.max_keypoints
    m = ms.init_map(cfg, dev)
    assoc = torch.full((M,), -1, dtype=torch.int32, device=dev)
    m = ms.insert_keyframe(m, frame, assoc, 0, 0)
    m, assoc, n_created = ms.create_landmarks(
        m, frame, assoc, 0, 0, max_new=M, th_depth=float(cfg.camera.th_depth))
    ring_init = torch.full((ring,), -1, dtype=torch.int32, device=dev)
    ring_init[0].fill_(0)
    return SlamState(
        m=m, last_frame=frame, last_assoc=assoc, last_kf_T=frame.T_cw,
        grid_thresholds=grid,
        n_kfs=torch.ones((), dtype=torch.int32, device=dev),
        next_lm=n_created, kf_counter=1,
        recent_slots=ring_init, recent_ids=ring_init.clone(), recent_n=1)


def slam_step(state: SlamState, img: torch.Tensor, depth: torch.Tensor,
              generator: torch.Generator | None, cfg: SystemConfig,
              inline_mapping: bool = True,
              draws: torch.Tensor | None = None):
    """One frame.  -> (state', T_cw [4,4], stats [9], ref_id int, T_cr
    [4,4], CullInfo [3]).  stats = [n_tracked, n_matches, ransac_inliers,
    kf_dist, kf_rot, rmse, inserted_kf, n_kfs, proj_overflow]; (ref_id,
    T_cr) is the pose relative to the reference keyframe.  `draws`
    optionally fixes the RANSAC samples (see ops/ransac.py).  With
    `inline_mapping` the keyframe's whole local mapping runs inside the
    insertion branch."""
    frame, new_grid = frame_mod._make_frame_impl(img, depth,
                                                 state.grid_thresholds, cfg)
    return slam_step_frame(state, frame, new_grid, generator, cfg,
                           inline_mapping=inline_mapping, draws=draws)


def slam_step_frame(state: SlamState, frame: frame_mod.FrameData,
                    new_grid: torch.Tensor, generator: torch.Generator | None,
                    cfg: SystemConfig, inline_mapping: bool = True,
                    draws: torch.Tensor | None = None):
    """`slam_step` from the frame on: for a FrameData made already (the
    parity tests pass the reference's)."""
    dev = frame.T_cw.device
    m, T_cw, assoc, s7 = track_step(
        state.m, state.last_frame, state.last_assoc, frame, state.last_kf_T,
        generator, cfg, draws=draws)
    frame = frame_mod.with_pose(frame, T_cw)
    dt, dr = s7[3], s7[4]
    # capacity = any free slot (culling frees rows for reuse)
    need_kf = ((dt > cfg.tracking.kf_min_trans)
               | (dr > cfg.tracking.kf_min_rot)) & ~torch.all(m.kf_valid)
    need, slot = read_host(need_kf, first_free_slot(m))

    st = state
    if need:
        kf_id = st.kf_counter
        m = ms.insert_keyframe(m, frame, assoc, slot, kf_id)
        m, assoc, n_created = ms.create_landmarks(
            m, frame, assoc, slot, kf_id, max_new=cfg.tracking.max_vo_points,
            th_depth=float(cfg.camera.th_depth))
        if inline_mapping:
            m, cull = map_keyframe_body(m, slot, kf_id, cfg)
        else:
            cull = empty_cull_info(dev)
        idx = min(st.recent_n, st.recent_slots.shape[0] - 1)
        rs, ri = st.recent_slots.clone(), st.recent_ids.clone()
        rs[idx].fill_(slot)
        ri[idx].fill_(kf_id)
        # mapping may have refined the new KF's pose: the keyframe trigger
        # measures from the refined one
        st = st._replace(next_lm=st.next_lm + n_created,
                         kf_counter=kf_id + 1, last_kf_T=m.kf_T_cw[slot],
                         recent_slots=rs, recent_ids=ri,
                         recent_n=st.recent_n + 1)
    else:
        cull = empty_cull_info(dev)
    # inline mapping can cull keyframes: count live rows
    n_kfs = torch.sum(m.kf_valid, dtype=torch.int32)
    st = st._replace(m=m, last_frame=frame, last_assoc=assoc,
                     grid_thresholds=new_grid, n_kfs=n_kfs)
    stats = torch.cat([
        s7[:6], torch.stack([need_kf.to(torch.float32),
                             n_kfs.to(torch.float32)]), s7[6:]])
    T_cr = frame.T_cw @ T_inv(st.last_kf_T)
    return st, frame.T_cw, stats, st.kf_counter - 1, T_cr, cull


def slam_scan(state: SlamState, generator: torch.Generator | None,
              imgs: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig,
              inline_mapping: bool = True):
    """`slam_step` over a chunk [T,H,W], in turn.  -> (state', T_cw
    [T,4,4], stats [T,9], ref_ids [T] (list of int), T_cr [T,4,4],
    CullInfo [T,3])."""
    outs = []
    for i in range(imgs.shape[0]):
        state, *out = slam_step(state, imgs[i], depths[i], generator, cfg,
                                inline_mapping=inline_mapping)
        outs.append(out)
    Ts, stats, ref_ids, T_crs, culls = zip(*outs)
    return (state, torch.stack(Ts), torch.stack(stats), list(ref_ids),
            torch.stack(T_crs),
            ms.CullInfo(*(torch.stack(x) for x in zip(*culls))))


def _drain_ring(state: SlamState) -> SlamState:
    """Reset the insertion ring (after the host has read it)."""
    return state._replace(recent_slots=torch.full_like(state.recent_slots, -1),
                          recent_ids=torch.full_like(state.recent_ids, -1),
                          recent_n=0)


def _pack_ring(state: SlamState) -> torch.Tensor:
    """[2R+2] int32: slots ++ ids ++ [count, n_kfs], for one host read."""
    return torch.cat([
        state.recent_slots, state.recent_ids,
        torch.full((1,), state.recent_n, dtype=torch.int32,
                   device=state.n_kfs.device),
        state.n_kfs.reshape(1)])


_HOST_FIELDS = ("kf_counter", "recent_n")       # Python ints in SlamState
_NESTED = {"m": ms.MapState, "last_frame": frame_mod.FrameData,
           "feat": Features}


def _flatten(nt, prefix: str) -> dict[str, np.ndarray]:
    """A NamedTuple of tensors, ints and NamedTuples -> {dotted field path:
    numpy array}, one read per tensor.  Keyed by path, not by position, so
    a field added later cannot shift what an older file holds."""
    out = {}
    for name, v in zip(nt._fields, nt):
        key = f"{prefix}.{name}"
        if name in _NESTED:
            out.update(_flatten(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = to_host(v)
        else:
            out[key] = np.int64(v)
    return out


def _unflatten(cls, data, prefix: str, device):
    fields = {}
    for name in cls._fields:
        key = f"{prefix}.{name}"
        if name in _NESTED:
            fields[name] = _unflatten(_NESTED[name], data, key, device)
        elif key not in data:
            raise KeyError(f"session file lacks {key}")
        elif name in _HOST_FIELDS:
            fields[name] = int(data[key])
        else:
            fields[name] = torch.from_numpy(data[key]).to(device)
    return cls(**fields)


class DeviceSlam:
    """Host wrapper: streams frames into `slam_step` (`process`) or chunks
    into `slam_scan` (`process_chunk`).  Frames go to the device in their
    sensor dtypes (uint8 gray, uint16 depth counts).  With `inline_mapping`
    (default) mapping runs inside the keyframe's step and the sync cadence
    serves loop closing only (nothing to do and nothing read without it);
    otherwise each sync drains the insertion ring with one read, maps the
    fresh keyframes in order, then runs loop detection over them.  The
    RANSAC draws come from a generator on `device` seeded with `seed`."""

    def __init__(self, cfg: SystemConfig, device: torch.device | str,
                 seed: int = 0, sync_every: int = 8, ring: int = 128,
                 inline_mapping: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sync_every = sync_every
        self.ring = ring
        self.inline_mapping = inline_mapping
        self.state: SlamState | None = None
        self.pose_buf: list[torch.Tensor] = []
        self.stats_buf: list[torch.Tensor] = []
        self.ref_ids: list[int] = []
        self.rel_pose_buf: list[torch.Tensor] = []
        self.timestamps: list[float] = []
        self.n_processed = 0
        self.last_mapped_id = 0      # kf_id high-water mark through mapping
        self.last_n_kfs = 1          # live KF count as of the last sync read
        self._cull_pending: list[ms.CullInfo] = []
        self.sync_reads: list[int] = []   # host reads of each sync that ran
        self.loop_closing = (LoopClosing(cfg, self.device)
                             if cfg.use_loop_closing else None)

    def process(self, img, depth, t: float = 0.0):
        img, depth = as_device(img, self.device), as_device(depth, self.device)
        if self.state is None:
            self._bootstrap(img, depth, t)
            return
        self.state, T, stats, ref_id, T_cr, cull = slam_step(
            self.state, img, depth, self.generator, self.cfg,
            inline_mapping=self.inline_mapping)
        self.pose_buf.append(T[None])
        self.stats_buf.append(stats[None])
        self.ref_ids.append(ref_id)
        self.rel_pose_buf.append(T_cr[None])
        if self.inline_mapping:
            self._cull_pending.append(cull)
        self.timestamps.append(t)
        self.n_processed += 1
        if self.n_processed % self.sync_every == 0:
            self._background_mapping()

    def _bootstrap(self, img, depth, t):
        self.state = init_slam(self.cfg, img, depth, ring=self.ring)
        self.pose_buf.append(self.state.last_frame.T_cw[None])
        # no stats row for the bootstrap frame
        self.ref_ids.append(0)
        self.rel_pose_buf.append(torch.eye(4, device=self.device)[None])
        self.timestamps.append(t)
        self.n_processed += 1

    def process_chunk(self, imgs, depths, ts=None):
        """A chunk of frames through `slam_scan`: equal to `process` per
        frame, minus the per-frame mapping-cadence checks (mapping syncs once
        per chunk)."""
        n = len(imgs)
        ts = [0.0] * n if ts is None else list(ts)
        imgs, depths = as_device(imgs, self.device), as_device(depths,
                                                                 self.device)
        start = 0
        if self.state is None:
            self._bootstrap(imgs[0], depths[0], ts[0])
            start = 1
        if start >= n:
            return
        self.state, Ts, stats, ref_ids, T_crs, culls = slam_scan(
            self.state, self.generator, imgs[start:], depths[start:],
            self.cfg, inline_mapping=self.inline_mapping)
        self.pose_buf.append(Ts)
        self.stats_buf.append(stats)
        self.ref_ids.extend(ref_ids)
        self.rel_pose_buf.append(T_crs)
        if self.inline_mapping:
            self._cull_pending.append(culls)
        self.timestamps.extend(ts[start:])
        before = self.n_processed
        self.n_processed += n - start
        if self.n_processed // self.sync_every != before // self.sync_every:
            self._background_mapping()

    def _background_mapping(self):
        """The sync cadence.  Inline mode without loop closing: nothing to
        do and nothing read.  Otherwise one read of the insertion ring, the
        fused mapping of each fresh keyframe in id order (unless inline),
        then batched loop detection over the fresh keyframes."""
        if self.state is None:
            return
        if self.inline_mapping and self.loop_closing is None:
            return
        R = self.ring
        reads_before = read_host.count
        packed = read_host(_pack_ring(self.state))
        slots, ids = np.asarray(packed[:R]), np.asarray(packed[R:2 * R])
        count = packed[2 * R]
        self.last_n_kfs = packed[2 * R + 1]
        if count > R:
            raise RuntimeError(
                f"insertion ring overflow ({count} > {R}): raise `ring` "
                f"or lower `sync_every`/chunk length")
        self.state = _drain_ring(self.state)
        live = (slots >= 0) & (ids > self.last_mapped_id)
        fresh = np.argsort(ids[live], kind="stable")
        f_slots, f_ids = slots[live][fresh], ids[live][fresh]
        m = self.state.m
        if not self.inline_mapping:
            for slot, kf_id in zip(f_slots, f_ids):
                m, cull = map_keyframe_fused(m, int(slot), int(kf_id),
                                             self.cfg)
                self._cull_pending.append(cull)
        if len(f_ids):
            self.last_mapped_id = max(self.last_mapped_id, int(f_ids[-1]))
        if self.loop_closing is not None and len(f_slots):
            m = self.loop_closing.process_keyframes_batch(
                m, f_slots.tolist(), f_ids.tolist(), n_live=self.last_n_kfs)
        if len(f_slots):
            # mapping or a loop moved keyframes: re-anchor the tracker's
            # reference pose to the refined map
            self.state = self.state._replace(
                m=m, last_kf_T=m.kf_T_cw[int(f_slots[-1])])
        else:
            self.state = self.state._replace(m=m)
        self.sync_reads.append(read_host.count - reads_before)

    @property
    def kfs_mapped(self) -> int:
        """Keyframes through the mapping refinement.  Inline mode: every
        inserted KF is mapped at insertion (one read, export-time use)."""
        if self.inline_mapping:
            return read_host(self.state.n_kfs)[0] if self.state else 0
        return self.last_mapped_id + 1

    def culled_registry(self) -> dict:
        """kf_id -> (parent_kf_id, T_cp) for every culled keyframe."""
        culled: dict[int, tuple[int, np.ndarray]] = {}
        for rec in self._cull_pending:
            did = rec.culled.reshape(-1).cpu().numpy()
            kid = rec.kf_id.reshape(-1).cpu().numpy()
            pid = rec.parent_kf_id.reshape(-1).cpu().numpy()
            tcp = rec.T_cp.reshape(-1, 4, 4).cpu().numpy()
            for j in np.nonzero(did)[0]:
                culled[int(kid[j])] = (int(pid[j]), tcp[j])
        return culled

    def finish(self):
        """Flush mapping and pull the trajectory [N,4,4] and stats [N-1,9]."""
        self._background_mapping()
        traj = torch.cat(self.pose_buf).cpu().numpy()
        stats = (torch.cat(self.stats_buf).cpu().numpy() if self.stats_buf
                 else np.zeros((0, 9), np.float32))
        return traj, stats

    def rebuilt_trajectory(self) -> np.ndarray:
        """The trajectory rebuilt from the final keyframe poses: T_cw(t) =
        T_cr(t) T_rw(final), walking the culled-KF parent chain to a
        surviving ancestor; a frame with none keeps its tracked pose.  Call
        after finish()."""
        m = self.state.m
        return rebuild_trajectory(
            m.kf_valid.cpu().numpy(), m.kf_id.cpu().numpy(),
            m.kf_T_cw.cpu().numpy(), self.culled_registry(), self.ref_ids,
            torch.cat(self.rel_pose_buf).cpu().numpy(),
            torch.cat(self.pose_buf).cpu().numpy())

    # -- sessions --------------------------------------------------------
    def fingerprint(self) -> dict:
        """What a session file must agree on to be resumed: the capacities
        that shape the state, and the switches that shape the run."""
        cfg = self.cfg
        return {
            "max_keyframes": cfg.map.max_keyframes,
            "max_landmarks": cfg.map.max_landmarks,
            "max_obs_per_lm": cfg.map.max_obs_per_lm,
            "max_keypoints": cfg.extractor.max_keypoints,
            "image": [cfg.camera.height, cfg.camera.width],
            "ring": self.ring,
            "inline_mapping": self.inline_mapping,
            "use_loop_closing": cfg.use_loop_closing,
            "vocab": [cfg.loop.vocab_branching, cfg.loop.vocab_depth],
            "generator": self.device.type,
        }

    def save(self, prefix: str) -> None:
        """Checkpoint the whole session mid-run into `prefix`.session.npz
        (and, with a vocabulary, `prefix`.vocab.npz and .loopdb.npz): enough
        for `resume` in a fresh process to continue it and still export the
        complete corrected trajectory.  Flushes the sync cadence first.
        The culled registry is written in either mapping mode (the
        reference drops it when mapping is not inline)."""
        self._background_mapping()
        culled = self.culled_registry()
        traj, stats = (torch.cat(self.pose_buf), torch.cat(self.stats_buf)
                       if self.stats_buf else
                       torch.zeros(0, 9, device=self.device))
        lc = self.loop_closing
        lc_state = None if lc is None else {
            "loops": lc.loops, "consistent_revisits": lc.consistent_revisits,
            "last_loop_kf_id": lc.last_loop_kf_id,
            "trained_on_kfs": lc.trained_on_kfs,
            "consistent_groups": [[sorted(g), c]
                                  for g, c in lc.consistent_groups]}
        np.savez_compressed(
            prefix + ".session.npz",
            fingerprint=np.asarray(json.dumps(self.fingerprint())),
            **_flatten(self.state, "state"),
            poses=to_host(traj), stats=to_host(stats),
            ref_ids=np.asarray(self.ref_ids, np.int64),
            rels=to_host(torch.cat(self.rel_pose_buf)),
            ts=np.asarray(self.timestamps, np.float64),
            n_processed=np.int64(self.n_processed),
            last_mapped_id=np.int64(self.last_mapped_id),
            last_n_kfs=np.int64(self.last_n_kfs),
            culled_ids=np.asarray(list(culled.keys()), np.int64),
            culled_parents=np.asarray([v[0] for v in culled.values()],
                                      np.int64),
            culled_T=(np.stack([v[1] for v in culled.values()]) if culled
                      else np.zeros((0, 4, 4), np.float32)),
            generator=self.generator.get_state().numpy(),
            loop_generator=(lc.generator.get_state().numpy() if lc
                            else np.zeros(0, np.uint8)),
            loop_state=np.asarray(json.dumps(lc_state)),
        )
        if lc is not None and lc.vocab is not None:
            from aslam_tpu_torch.ops import bow

            bow.save_vocabulary(prefix + ".vocab.npz", lc.vocab)
            np.savez_compressed(
                prefix + ".loopdb.npz",
                **{f: to_host(getattr(lc.db, f)) for f in lc.db._fields})

    @classmethod
    def resume(cls, prefix: str, cfg: SystemConfig,
               device: torch.device | str, **kwargs) -> "DeviceSlam":
        """Rebuild a session from `save`'s output on `device`, in a fresh
        object (a fresh process will do).  Raises ValueError when the file's
        fingerprint differs from this configuration's."""
        slam = cls(cfg, device, **kwargs)
        data = np.load(prefix + ".session.npz")
        saved, own = json.loads(str(data["fingerprint"])), slam.fingerprint()
        if saved != own:
            diff = {k: (saved.get(k), own[k]) for k in own
                    if saved.get(k) != own[k]}
            raise ValueError(f"session {prefix} does not fit this "
                             f"configuration (file, here): {diff}")
        dev = slam.device
        slam.state = _unflatten(SlamState, data, "state", dev)
        slam.pose_buf = [torch.from_numpy(data["poses"]).to(dev)]
        if len(data["stats"]):
            slam.stats_buf = [torch.from_numpy(data["stats"]).to(dev)]
        slam.ref_ids = data["ref_ids"].tolist()
        slam.rel_pose_buf = [torch.from_numpy(data["rels"]).to(dev)]
        slam.timestamps = data["ts"].tolist()
        slam.n_processed = int(data["n_processed"])
        slam.last_mapped_id = int(data["last_mapped_id"])
        slam.last_n_kfs = int(data["last_n_kfs"])
        slam.generator.set_state(torch.from_numpy(data["generator"]))
        # the culled registry comes back as one record, read already
        ids = data["culled_ids"]
        if len(ids):
            slam._cull_pending = [ms.CullInfo(
                culled=torch.ones(len(ids), dtype=torch.bool),
                kf_id=torch.from_numpy(ids.astype(np.int32)),
                parent_kf_id=torch.from_numpy(
                    data["culled_parents"].astype(np.int32)),
                T_cp=torch.from_numpy(data["culled_T"]))]
        lc = slam.loop_closing
        if lc is not None:
            from aslam_tpu_torch.models.loopclosing import DatabaseState
            from aslam_tpu_torch.ops import bow

            st = json.loads(str(data["loop_state"]))
            lc.loops = [tuple(x) for x in st["loops"]]
            lc.consistent_revisits = [tuple(x)
                                      for x in st["consistent_revisits"]]
            lc.last_loop_kf_id = st["last_loop_kf_id"]
            lc.trained_on_kfs = st["trained_on_kfs"]
            lc.consistent_groups = [(set(g), c)
                                    for g, c in st["consistent_groups"]]
            lc.generator.set_state(torch.from_numpy(data["loop_generator"]))
            if os.path.exists(prefix + ".vocab.npz"):
                lc.vocab = bow.load_vocabulary(prefix + ".vocab.npz", dev)
                db = np.load(prefix + ".loopdb.npz")
                lc.db = DatabaseState(**{
                    f: torch.from_numpy(db[f]).to(dev)
                    for f in DatabaseState._fields})
        return slam

    def new_sequence(self, img, depth, t: float = 0.0) -> bool:
        """Start a new input sequence into the same map: relocalize its
        first frame against the map (loop closing's BoW database, when
        there is one), else continue from the reference keyframe's pose;
        then acquire landmark bindings by a wide projection search.  -> True
        when the frame re-anchored on at least 10 bindings (one host read,
        beside relocalization's)."""
        self._background_mapping()   # flush before touching the map
        st = self.state
        frame, grid = frame_mod.make_frame(
            as_device(img, self.device), as_device(depth, self.device),
            self.cfg, st.grid_thresholds)
        T0 = None
        if self.loop_closing is not None:
            T0 = self.loop_closing.relocalize(st.m, frame)
        T0 = (st.last_kf_T if T0 is None
              else torch.from_numpy(T0).to(self.device))
        frame = frame_mod.with_pose(frame, T0)
        T_b, assoc, n_b = bootstrap_track(st.m, frame, self.cfg)
        ok = read_host(n_b)[0] >= 10
        if ok:
            frame = frame_mod.with_pose(frame, T_b)
        self.state = st._replace(last_frame=frame, last_assoc=assoc,
                                 grid_thresholds=grid)
        self.pose_buf.append(frame.T_cw[None])
        self.stats_buf.append(torch.zeros(1, 9, device=self.device))
        self.ref_ids.append(st.kf_counter - 1)
        self.rel_pose_buf.append((frame.T_cw @ T_inv(st.last_kf_T))[None])
        self.timestamps.append(t)
        self.n_processed += 1
        return ok

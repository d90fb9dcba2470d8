"""MapState: the world model as a tuple of fixed-capacity tensors.

Port of `aslam_tpu/models/mapstate.py`.  Source of truth:

  kf_* rows      one per keyframe slot (pose + keypoint arrays)
  kf_lm [K,M]    landmark id per keyframe feature (-1 = none): the
                 observation edge list in COO-by-row form
  lm_* rows      one per landmark slot (position, descriptor, stats)
  lm_obs_*       landmark -> observer reverse index, up to O (kf_slot,
                 feat) entries per landmark, ring-overwritten past O.  An
                 entry counts only while kf_valid[kf] & kf_lm[kf, feat] == l
                 still holds, so culls and redirects never touch the lists.

Every function is out of place: it returns new tensors and leaves the map
it was given as it was.  None reads the device.  Keyframe slots and ids
arrive as Python ints (the host decides them, see models/device_slam.py).
Descriptors are int32 words holding the reference's uint32 bit patterns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.models.frame import FrameData
from aslam_tpu_torch.ops import hamming
from aslam_tpu_torch.ops.index import (index_add_ordered, nonzero_static,
                                       pick, set_rows)
from aslam_tpu_torch.ops.matching import compact_candidates
from aslam_tpu_torch.ops.select import topk_stable
from aslam_tpu_torch.utils import camera
from aslam_tpu_torch.utils.se3 import T_inv, transform_points


class MapState(NamedTuple):
    # keyframes
    kf_T_cw: torch.Tensor     # [K,4,4]
    kf_valid: torch.Tensor    # [K] bool
    kf_id: torch.Tensor       # [K] int32 insertion order (monotonic)
    kf_xy: torch.Tensor       # [K,M,2] undistorted keypoint coords
    kf_ur: torch.Tensor       # [K,M]
    kf_z: torch.Tensor        # [K,M] keypoint depth
    kf_desc: torch.Tensor     # [K,M,8] int32 (uint32 bit patterns)
    kf_octave: torch.Tensor   # [K,M] int32
    kf_kp_valid: torch.Tensor # [K,M] bool
    kf_lm: torch.Tensor       # [K,M] int32 landmark id, -1 = none
    # landmarks
    lm_pos: torch.Tensor      # [L,3] world position
    lm_desc: torch.Tensor     # [L,8] int32 distinctive descriptor
    lm_valid: torch.Tensor    # [L] bool
    lm_first_kf: torch.Tensor # [L] int32 kf_id at creation
    lm_visible: torch.Tensor  # [L] int32 frustum-visible count
    lm_found: torch.Tensor    # [L] int32 tracked-inlier count
    # observer reverse index
    lm_obs_kf: torch.Tensor   # [L,O] int32 KF slot (-1 = empty)
    lm_obs_feat: torch.Tensor # [L,O] int32 feature index
    lm_obs_ptr: torch.Tensor  # [L] int32 ring write cursor


class CullInfo(NamedTuple):
    """Parent-chain record of a culled keyframe, for trajectory recovery:
    the victim's pose relative to the surviving KF most covisible with it."""

    culled: torch.Tensor        # bool: did a cull happen
    kf_id: torch.Tensor         # int32 victim kf_id (-1 if none)
    parent_kf_id: torch.Tensor  # int32 parent kf_id (-1 if none)
    T_cp: torch.Tensor          # [4,4] victim pose relative to parent


def init_map(cfg: SystemConfig, device: torch.device | str) -> MapState:
    K = cfg.map.max_keyframes
    L = cfg.map.max_landmarks
    M = cfg.extractor.max_keypoints
    O = cfg.map.max_obs_per_lm
    i32, f32 = torch.int32, torch.float32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_T_cw=torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_id=full((K,), -1, i32),
        kf_xy=full((K, M, 2), 0.0, f32),
        kf_ur=full((K, M), -1.0, f32),
        kf_z=full((K, M), 0.0, f32),
        kf_desc=full((K, M, 8), 0, i32),
        kf_octave=full((K, M), 0, i32),
        kf_kp_valid=full((K, M), False, torch.bool),
        kf_lm=full((K, M), -1, i32),
        lm_pos=full((L, 3), 0.0, f32),
        lm_desc=full((L, 8), 0, i32),
        lm_valid=full((L,), False, torch.bool),
        lm_first_kf=full((L,), -1, i32),
        lm_visible=full((L,), 0, i32),
        lm_found=full((L,), 0, i32),
        lm_obs_kf=full((L, O), -1, i32),
        lm_obs_feat=full((L, O), 0, i32),
        lm_obs_ptr=full((L,), 0, i32),
    )


def _long(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _where_i(cond: torch.Tensor, a: torch.Tensor, b: int) -> torch.Tensor:
    """torch.where(cond, a, b) as an int64 index."""
    return torch.where(cond, _long(a), b)


# ----------------------------------------------------------------- derived

def _live_ids(m: MapState) -> torch.Tensor:
    """[K*M] int64 landmark id of every live observation, L where none."""
    L = m.lm_pos.shape[0]
    ok = m.kf_kp_valid & m.kf_valid[:, None] & (m.kf_lm >= 0)
    return _where_i(ok, m.kf_lm, L).reshape(-1)


def observation_counts(m: MapState) -> torch.Tensor:
    """[L] int32: number of observing keyframes per landmark."""
    L = m.lm_pos.shape[0]
    flat = _live_ids(m)
    return torch.zeros(L + 1, dtype=torch.int32, device=flat.device) \
        .index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))[:L]


def observation_counts_weighted(m: MapState) -> torch.Tensor:
    """[L] int32: observations with valid depth count twice (pseudo-stereo,
    two constraints), monocular ones once."""
    L = m.lm_pos.shape[0]
    flat = _live_ids(m)
    w = torch.where(m.kf_z > 0, 2, 1).to(torch.int32).reshape(-1)
    return torch.zeros(L + 1, dtype=torch.int32, device=flat.device) \
        .index_add_(0, flat, w)[:L]


def landmark_mask_of_kfs(m: MapState, kf_mask: torch.Tensor) -> torch.Tensor:
    """[L] bool: landmarks observed by any keyframe in `kf_mask` [K]: one
    scatter over the [K,M] table."""
    L = m.lm_pos.shape[0]
    ok = m.kf_kp_valid & (m.kf_valid & kf_mask)[:, None] & (m.kf_lm >= 0)
    flat = _where_i(ok, m.kf_lm, L).reshape(-1)
    return set_rows(torch.zeros_like(m.lm_valid), flat, True) & m.lm_valid


def kf_votes(m: MapState, lm_mask: torch.Tensor) -> torch.Tensor:
    """[K] int32: per-keyframe count of observed landmarks inside `lm_mask`
    [L]: one gather over the [K,M] table."""
    L = m.lm_pos.shape[0]
    pad = torch.cat([lm_mask & m.lm_valid, lm_mask.new_zeros(1)])
    hit = pad[_where_i(m.kf_lm >= 0, m.kf_lm, L)] & m.kf_kp_valid \
        & m.kf_valid[:, None]
    return torch.sum(hit, dim=1, dtype=torch.int32)


def covis_row(m: MapState, slot: int) -> torch.Tensor:
    """[K] int32: shared-landmark counts of keyframe `slot` with every
    keyframe, O(K*M) over the observation table (`covis_row_fast` walks the
    observer index instead)."""
    L = m.lm_pos.shape[0]
    row = m.kf_lm[slot]
    ok = m.kf_kp_valid[slot] & (row >= 0)
    lmask = set_rows(torch.zeros_like(m.lm_valid), _where_i(ok, row, L),
                     True) & m.lm_valid
    votes = kf_votes(m, lmask) * m.kf_valid[slot]
    return _set_row(votes, slot, 0)


def covis_rows(m: MapState, slots) -> torch.Tensor:
    """[S,K] int32 `covis_row` of each slot (a sequence of ints)."""
    return torch.stack([covis_row(m, int(s)) for s in slots])


# ------------------------------------------------------------ observer index

def append_observations(m: MapState, lm_ids: torch.Tensor,
                        feat_idx: torch.Tensor, slot,
                        mask: torch.Tensor) -> MapState:
    """Record (slot, feat_idx[i]) as an observer of landmark lm_ids[i] for
    every masked i (ring append).  Caller contract: each (kf, feat) binding
    is appended once, and masked lm_ids hold no duplicates."""
    L, O = m.lm_obs_kf.shape
    tgt = _where_i(mask, lm_ids, L)
    ptr_pad = torch.cat([m.lm_obs_ptr, m.lm_obs_ptr.new_zeros(1)])
    pos = _long(ptr_pad[tgt] % O)
    okf = set_rows(m.lm_obs_kf, (tgt, pos),
                   torch.where(mask, slot, -1).to(torch.int32))
    ofe = set_rows(m.lm_obs_feat, (tgt, pos), feat_idx.to(torch.int32))
    ptr = ptr_pad.index_add(0, tgt, mask.to(torch.int32))[:L]
    return m._replace(lm_obs_kf=okf, lm_obs_feat=ofe, lm_obs_ptr=ptr)


def observer_entries(m: MapState, lm_ids: torch.Tensor, valid: torch.Tensor):
    """The observer lists of `lm_ids` [N] resolved against the current
    bindings -> (obs_kf [N,O] int32, obs_feat [N,O] int32, ok [N,O] bool),
    ok marking entries that still hold."""
    L, O = m.lm_obs_kf.shape
    safe = _where_i(valid, lm_ids, L)
    okf = torch.cat([m.lm_obs_kf, m.lm_obs_kf.new_full((1, O), -1)])[safe]
    ofe = torch.cat([m.lm_obs_feat, m.lm_obs_feat.new_zeros((1, O))])[safe]
    kf_s = _long(torch.clamp(okf, min=0))
    bound = m.kf_lm[kf_s, _long(ofe)]
    ok = (okf >= 0) & m.kf_valid[kf_s] & (bound == lm_ids[:, None]) \
        & valid[:, None]
    return okf, ofe, ok


def kf_votes_of_ids(m: MapState, lm_ids: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """[K] int32: per-KF count of observed landmarks among `lm_ids`."""
    K = m.kf_valid.shape[0]
    okf, _, ok = observer_entries(m, lm_ids, valid)
    tgt = _where_i(ok, okf, K).reshape(-1)
    votes = torch.zeros(K + 1, dtype=torch.int32, device=tgt.device) \
        .index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))[:K]
    return votes * m.kf_valid


def covis_rows_fast(m: MapState, slots: torch.Tensor) -> torch.Tensor:
    """[S,K] int32 covisibility rows of KF `slots` [S] via the observer
    index (the reference vmaps `covis_row_fast`)."""
    K, M = m.kf_lm.shape
    slots = _long(slots)
    S = slots.shape[0]
    row = m.kf_lm[slots]                                        # [S,M]
    safe = torch.clamp(row, min=0)
    ok = m.kf_kp_valid[slots] & (row >= 0) & m.lm_valid[_long(safe)]
    okf, _, ent = observer_entries(m, safe.reshape(-1), ok.reshape(-1))
    tgt = _where_i(ent, okf, K).reshape(S, -1)
    votes = torch.zeros(S, K + 1, dtype=torch.int32, device=tgt.device) \
        .scatter_add_(1, tgt, torch.ones_like(tgt, dtype=torch.int32))[:, :K]
    votes = votes * m.kf_valid[None, :] * m.kf_valid[slots][:, None]
    return votes.scatter(1, slots[:, None], 0)


def covis_row_fast(m: MapState, slot) -> torch.Tensor:
    """[K] int32 covisibility row of KF `slot` (an int or a 0-d tensor)."""
    if not isinstance(slot, torch.Tensor):
        slot = torch.full((1,), slot, dtype=torch.int64,
                          device=m.kf_valid.device)
    return covis_rows_fast(m, slot.reshape(1))[0]


def landmark_mask_of_slots(m: MapState, slots: torch.Tensor,
                           slot_valid: torch.Tensor) -> torch.Tensor:
    """[L] bool: landmarks observed by the given KF slots."""
    L = m.lm_pos.shape[0]
    slots = _long(slots)
    rows = m.kf_lm[slots]
    ok = m.kf_kp_valid[slots] & (rows >= 0) \
        & (slot_valid & m.kf_valid[slots])[:, None]
    flat = _where_i(ok, rows, L).reshape(-1)
    return set_rows(torch.zeros_like(m.lm_valid), flat, True) & m.lm_valid


def incidence(m: MapState, lo: int, hi: int) -> torch.Tensor:
    """[hi-lo, L] float32 0/1: keyframe row k observes landmark l, for the
    rows lo..hi-1 (never the whole [K,L] matrix unless asked for)."""
    L = m.lm_pos.shape[0]
    rows = m.kf_lm[lo:hi]
    ok = m.kf_kp_valid[lo:hi] & m.kf_valid[lo:hi, None] & (rows >= 0)
    A = torch.zeros(hi - lo, L + 1, dtype=torch.float32, device=rows.device)
    A.scatter_(1, _where_i(ok, rows, L), 1.0)
    return A[:, :L] * m.lm_valid[None, :]


def covisibility(m: MapState, chunk: int = 256) -> torch.Tensor:
    """[K,K] int32 shared-landmark counts, as products of incidence blocks
    of `chunk` rows built on the fly (one A A^T at K <= chunk).  The counts
    are integers below 2^24, exact in the float32 product.  Only
    coarse-cadence consumers (the pose-graph build) need the full matrix."""
    K = m.kf_lm.shape[0]
    starts = range(0, K, chunk)
    W = torch.cat([
        torch.cat([incidence(m, i, min(i + chunk, K))
                   @ incidence(m, j, min(j + chunk, K)).T for j in starts], 1)
        for i in starts]).to(torch.int32)
    W = W * (1 - torch.eye(K, dtype=torch.int32, device=W.device))
    return W * (m.kf_valid[:, None] & m.kf_valid[None, :])


def rebuild_observer_index(m: MapState) -> MapState:
    """Recompute lm_obs_* from kf_lm (the source of truth), for maps
    assembled by hand.  Host-side; oldest KF first, so the ring keeps the
    newest observers."""
    import numpy as np

    dev = m.kf_lm.device
    kf_lm = m.kf_lm.cpu().numpy()
    kf_valid = m.kf_valid.cpu().numpy()
    kf_kp_valid = m.kf_kp_valid.cpu().numpy()
    L, O = m.lm_obs_kf.shape
    okf = np.full((L, O), -1, np.int32)
    ofe = np.zeros((L, O), np.int32)
    ptr = np.zeros(L, np.int32)
    for k in np.argsort(m.kf_id.cpu().numpy()):
        if not kf_valid[k]:
            continue
        feats = np.nonzero((kf_lm[k] >= 0) & kf_kp_valid[k])[0]
        ls = kf_lm[k][feats]
        pos = ptr[ls] % O
        okf[ls, pos] = k
        ofe[ls, pos] = feats
        ptr[ls] += 1
    return m._replace(lm_obs_kf=torch.from_numpy(okf).to(dev),
                      lm_obs_feat=torch.from_numpy(ofe).to(dev),
                      lm_obs_ptr=torch.from_numpy(ptr).to(dev))


# ------------------------------------------------------------------ insert

def _set_row(x: torch.Tensor, slot: int, v) -> torch.Tensor:
    out = x.clone()
    if isinstance(v, torch.Tensor):
        out[slot] = v
    else:
        out[slot].fill_(v)      # no copy from host memory
    return out


def insert_keyframe(m: MapState, frame: FrameData, lm_assoc: torch.Tensor,
                    slot: int, kf_id: int) -> MapState:
    """Write a frame into keyframe row `slot`, with its carried landmark
    bindings recorded in the observer index."""
    M = lm_assoc.shape[0]
    m = append_observations(
        m, torch.clamp(lm_assoc, min=0),
        torch.arange(M, dtype=torch.int32, device=lm_assoc.device),
        slot, lm_assoc >= 0)
    return m._replace(
        kf_T_cw=_set_row(m.kf_T_cw, slot, frame.T_cw),
        kf_valid=_set_row(m.kf_valid, slot, True),
        kf_id=_set_row(m.kf_id, slot, kf_id),
        kf_xy=_set_row(m.kf_xy, slot, frame.xy_und),
        kf_ur=_set_row(m.kf_ur, slot, frame.ur),
        kf_z=_set_row(m.kf_z, slot, frame.depth),
        kf_desc=_set_row(m.kf_desc, slot, frame.feat.desc),
        kf_octave=_set_row(m.kf_octave, slot, frame.feat.octave),
        kf_kp_valid=_set_row(m.kf_kp_valid, slot, frame.feat.valid),
        kf_lm=_set_row(m.kf_lm, slot, lm_assoc),
    )


def create_landmarks(m: MapState, frame: FrameData, lm_assoc: torch.Tensor,
                     slot: int, kf_id: int, max_new: int, th_depth: float):
    """Spawn landmarks for up to `max_new` closest unbound keypoints with
    valid depth below th_depth, in the free rows of the landmark table (the
    lowest first).  -> (map, new_assoc [M], n_created scalar int32)."""
    M = lm_assoc.shape[0]
    L = m.lm_pos.shape[0]
    dev = lm_assoc.device
    feat = frame.feat
    eligible = feat.valid & frame.has_depth & (lm_assoc < 0) \
        & (frame.depth < th_depth)
    depth_key = torch.where(eligible, frame.depth,
                            torch.full_like(frame.depth, float("inf")))
    chosen = torch.argsort(depth_key, stable=True)             # closest first
    ar = torch.arange(M, device=dev)
    is_new = ar < torch.clamp(torch.sum(eligible.to(torch.int32)), max=max_new)

    n_free = L - torch.sum(m.lm_valid.to(torch.int32))
    new_ids = nonzero_static(~m.lm_valid, M, L - 1)
    is_new = is_new & (ar < n_free)
    n_created = torch.sum(is_new.to(torch.int32))

    pts_w = transform_points(T_inv(frame.T_cw), frame.p3d)
    tgt = _where_i(is_new, new_ids, L)
    m = m._replace(
        lm_pos=set_rows(m.lm_pos, tgt, pts_w[chosen]),
        lm_desc=set_rows(m.lm_desc, tgt, feat.desc[chosen]),
        lm_valid=set_rows(m.lm_valid, tgt, True),
        lm_first_kf=set_rows(m.lm_first_kf, tgt, kf_id),
        # a reused row inherits neither statistics nor observers
        lm_visible=set_rows(m.lm_visible, tgt, 0),
        lm_found=set_rows(m.lm_found, tgt, 0),
        lm_obs_kf=set_rows(m.lm_obs_kf, tgt, -1),
        lm_obs_ptr=set_rows(m.lm_obs_ptr, tgt, 0),
    )
    # bind features: feature chosen[r] -> new_ids[r]
    assoc = set_rows(lm_assoc, _where_i(is_new, chosen, M),
                     torch.where(is_new, new_ids, -1).to(torch.int32))
    m = m._replace(kf_lm=_set_row(m.kf_lm, slot, assoc))
    m = append_observations(m, torch.where(is_new, new_ids, 0), chosen, slot,
                            is_new)
    return m, assoc, n_created


# ----------------------------------------------------------------- culling

def landmark_culling(m: MapState, current_kf_id: int,
                     cfg: SystemConfig) -> MapState:
    """Over the landmarks created within the last 4 KF ids (cap 4096), kill
    those with found/visible < cull_found_ratio, or with nObs <=
    cull_min_obs (depth observations count twice) more than 2 KFs after
    creation; unbind them through their observer entries.  Like the
    reference (ADVICE r5, `mapstate.py:502`), bindings the observer ring
    has overwritten stay bound to the dead row."""
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]
    recent = m.lm_valid & (m.lm_first_kf >= 0) \
        & ((current_kf_id - m.lm_first_kf) <= 4)
    cidx, cvalid, _ = compact_candidates(recent, min(4096, L))
    okf, ofe, ok = observer_entries(m, cidx, cvalid)
    z = m.kf_z[_long(torch.clamp(okf, min=0)), _long(ofe)]
    w = torch.where(z > 0, 2, 1)
    nobs = torch.sum(torch.where(ok, w, 0), dim=1)
    found_ratio = m.lm_found[cidx] / torch.clamp(m.lm_visible[cidx], min=1)
    bad_ratio = (m.lm_visible[cidx] > 0) \
        & (found_ratio < cfg.map.cull_found_ratio)
    mature = (current_kf_id - m.lm_first_kf[cidx]) >= 2
    bad = cvalid & (bad_ratio | (mature & (nobs <= cfg.map.cull_min_obs)))

    lm_valid = set_rows(m.lm_valid, _where_i(bad, cidx, L), False)
    kill = ok & bad[:, None]
    kf_lm = set_rows(m.kf_lm, (_where_i(kill, okf, K),
                               _where_i(kill, ofe, 0)), -1)
    return m._replace(lm_valid=lm_valid, kf_lm=kf_lm)


def keyframe_culling(m: MapState, current_slot: int, cfg: SystemConfig):
    """A covisible neighbour of the current KF (never KF slot 0 or the
    current one) is redundant when > kf_cull_redundancy of its close
    landmarks are observed >= 3 times elsewhere; the first such candidate
    in covisibility order is culled.  -> (map, CullInfo)."""
    K, M = m.kf_lm.shape
    N = min(cfg.map.kf_cull_candidates, K)
    dev = m.kf_valid.device
    ar = torch.arange(K, device=dev)
    w_row = covis_row_fast(m, current_slot)
    cand_rank = torch.where(m.kf_valid, w_row, -1)
    cand_rank = torch.where((ar == 0) | (ar == current_slot), -1, cand_rank)
    cand_vals, cand_idx = topk_stable(cand_rank, N)
    cand_ok = cand_vals > 0

    rows = m.kf_lm[cand_idx]
    z = m.kf_z[cand_idx]
    ids = torch.where(m.kf_kp_valid[cand_idx], rows, -1)
    close = (ids >= 0) & (z > 0) & (z < cfg.camera.th_depth)
    _, _, ent_ok = observer_entries(m, torch.clamp(ids, min=0).reshape(-1),
                                    (ids >= 0).reshape(-1))
    lm_obs = torch.sum(ent_ok, dim=1).reshape(N, M)
    n_close = torch.sum(close, dim=1)
    n_red = torch.sum(close & (lm_obs >= 4), dim=1)
    redundant = cand_ok & (n_close > 0) \
        & (n_red > cfg.map.kf_cull_redundancy * n_close)
    first = pick(cand_idx, torch.argmax(redundant.to(torch.int32)))
    do = torch.any(redundant)

    # parent: the surviving KF most covisible with the victim
    parent_rank = torch.where(m.kf_valid, covis_row_fast(m, first), -1)
    parent = torch.argmax(torch.where(ar == first, -1, parent_rank))
    T_cp = pick(m.kf_T_cw, first) @ T_inv(pick(m.kf_T_cw, parent))
    info = CullInfo(
        culled=do,
        kf_id=torch.where(do, pick(m.kf_id, first), -1),
        parent_kf_id=torch.where(do, pick(m.kf_id, parent), -1),
        T_cp=T_cp,
    )
    victim = do & (ar == first)
    return m._replace(
        kf_valid=m.kf_valid & ~victim,
        kf_lm=torch.where(victim[:, None], -1, m.kf_lm),
    ), info


# --------------------------------------------------------------- positions

def _backproject_world(cam, xy, z, T_cw):
    """Keypoints (xy, z) of cameras T_cw [...,4,4] -> world points."""
    T_wc = T_inv(T_cw)
    p_c = camera.unproject(cam, xy, z)
    return (T_wc[..., None, :3, :3] @ p_c[..., None])[..., 0] \
        + T_wc[..., None, :3, 3]


def refresh_landmark_positions(m: MapState, cfg: SystemConfig) -> MapState:
    """Every landmark's position becomes the information-weighted mean
    (w = 1/sigma_z^2, sigma_z = 0.01 z^2 + 1e-3) of its depth-valid
    observations backprojected at the current keyframe poses, with a
    3-sigma Khoshelham-trimmed second pass; landmarks with no such
    observation keep their positions."""
    L = m.lm_pos.shape[0]
    obs_ok = m.kf_kp_valid & m.kf_valid[:, None] & (m.kf_lm >= 0) \
        & (m.kf_z > 0)
    p_w = _backproject_world(cfg.camera, m.kf_xy, m.kf_z, m.kf_T_cw)
    sigma = 0.01 * m.kf_z * m.kf_z + 1e-3
    w = torch.where(obs_ok, 1.0 / (sigma * sigma), 0.0)
    idx = _where_i(obs_ok, m.kf_lm, L).reshape(-1)
    ok = obs_ok.reshape(-1)
    flat_p = p_w.reshape(-1, 3)

    def weighted_mean(wv):
        fw = wv.reshape(-1)
        sw = index_add_ordered(torch.zeros(L + 1, dtype=w.dtype,
                                           device=w.device), idx, fw, ok)[:L]
        sp = index_add_ordered(torch.zeros(L + 1, 3, dtype=w.dtype,
                                           device=w.device), idx,
                               fw[:, None] * flat_p, ok)[:L]
        return sp / torch.clamp(sw, min=1e-12)[:, None], sw

    mean1, sw1 = weighted_mean(w)
    dist = torch.linalg.vector_norm(
        p_w - mean1[_long(torch.clamp(m.kf_lm, 0, L - 1))], dim=-1)
    keep = dist <= camera.khoshelham_gate(m.kf_z)
    mean2, sw2 = weighted_mean(torch.where(keep, w, 0.0))
    new_pos = torch.where((sw2 > 0)[:, None], mean2, mean1)
    has_any = (sw1 > 0) & m.lm_valid
    return m._replace(lm_pos=torch.where(has_any[:, None], new_pos, m.lm_pos))


def refresh_landmark_positions_ids(m: MapState, lm_ids: torch.Tensor,
                                   valid: torch.Tensor,
                                   cfg: SystemConfig) -> MapState:
    """`refresh_landmark_positions` for an id list (the landmarks a new
    keyframe touches), walking their observer entries."""
    L = m.lm_pos.shape[0]
    okf, ofe, ok = observer_entries(m, lm_ids, valid)
    kf_s, fe = _long(torch.clamp(okf, min=0)), _long(ofe)
    z = m.kf_z[kf_s, fe]
    ok = ok & (z > 0)
    T_wc = T_inv(m.kf_T_cw)[kf_s]                             # [N,O,4,4]
    p_c = camera.unproject(cfg.camera, m.kf_xy[kf_s, fe], z)
    p_w = (T_wc[..., :3, :3] @ p_c[..., None])[..., 0] + T_wc[..., :3, 3]
    sigma = 0.01 * z * z + 1e-3
    w = torch.where(ok, 1.0 / (sigma * sigma), 0.0)

    def wmean(wv):
        sw = torch.sum(wv, dim=1)
        sp = torch.einsum("no,noi->ni", wv, p_w)
        return sp / torch.clamp(sw, min=1e-12)[:, None], sw

    mean1, sw1 = wmean(w)
    dist = torch.linalg.vector_norm(p_w - mean1[:, None, :], dim=-1)
    keep = dist <= camera.khoshelham_gate(z)
    mean2, sw2 = wmean(torch.where(keep, w, 0.0))
    new_pos = torch.where((sw2 > 0)[:, None], mean2, mean1)
    has = (sw1 > 0) & valid & m.lm_valid[_long(torch.clamp(lm_ids, min=0))]
    return m._replace(lm_pos=set_rows(m.lm_pos, _where_i(has, lm_ids, L),
                                      new_pos))


# ------------------------------------------------------------- descriptors

def refresh_landmark_descriptors_ids(m: MapState, lm_ids: torch.Tensor,
                                     valid: torch.Tensor) -> MapState:
    """Distinctive descriptor of each listed landmark = the medoid (least
    total Hamming distance, first on ties) of its live observations."""
    L = m.lm_pos.shape[0]
    okf, ofe, ok = observer_entries(m, lm_ids, valid)
    desc = m.kf_desc[_long(torch.clamp(okf, min=0)), _long(ofe)]  # [N,O,8]
    d = hamming.distance_matrix_popcount(desc, desc)              # [N,O,O]
    d = torch.where(ok[:, None, :], d, 0.0)
    total = torch.where(ok, torch.sum(d, dim=2), float("inf"))
    best = torch.argmin(total, dim=1)
    med = torch.gather(desc, 1, best[:, None, None].expand(-1, 1, 8))[:, 0]
    safe = _long(torch.clamp(lm_ids, min=0))
    new_desc = torch.where(torch.any(ok, dim=1)[:, None], med, m.lm_desc[safe])
    w_ok = valid & m.lm_valid[safe]
    return m._replace(lm_desc=set_rows(m.lm_desc, _where_i(w_ok, lm_ids, L),
                                       new_desc))


def refresh_landmark_descriptors(m: MapState, lm_mask: torch.Tensor,
                                 max_obs: int = 8) -> MapState:
    """The medoid refresh for a landmark mask [L] over the whole
    observation table: up to `max_obs` observations per landmark, the first
    in keyframe-slot order (a stable sort of the [K*M] edge list by landmark
    id), then the least total Hamming distance."""
    L = m.lm_pos.shape[0]
    flat_ids = _live_ids(m)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    idx = torch.arange(sorted_ids.shape[0], device=order.device)
    rank = idx - torch.searchsorted(sorted_ids, sorted_ids, right=False)
    use = (sorted_ids < L) & (rank < max_obs)
    tgt = (torch.where(use, sorted_ids, L), torch.where(use, rank, 0))
    dev = order.device
    # masked edges all land in the padding row, which set_rows drops
    obs_desc = set_rows(
        torch.zeros(L, max_obs, 8, dtype=torch.int32, device=dev), tgt,
        m.kf_desc.reshape(-1, 8)[order])
    obs_cnt = set_rows(torch.zeros(L, max_obs, dtype=torch.bool, device=dev),
                       tgt, use)
    d = hamming.distance_matrix_popcount(obs_desc, obs_desc)
    d = torch.where(obs_cnt[:, None, :], d, 0.0)
    total = torch.where(obs_cnt, torch.sum(d, dim=2), float("inf"))
    best = torch.argmin(total, dim=1)
    med = torch.gather(obs_desc, 1, best[:, None, None].expand(-1, 1, 8))[:, 0]
    new_desc = torch.where(torch.any(obs_cnt, dim=1)[:, None], med, m.lm_desc)
    return m._replace(lm_desc=torch.where((lm_mask & m.lm_valid)[:, None],
                                          new_desc, m.lm_desc))

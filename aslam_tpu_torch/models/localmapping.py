"""Local mapping: the per-keyframe map refinement.

Port of `aslam_tpu/models/localmapping.py`.  Each inserted keyframe runs, in
order: distinctive-descriptor refresh of the landmarks it touches, landmark
culling, fuse (project covisible landmarks into it, bind or merge), the
landmark position refresh, the windowed Schur local BA and keyframe
culling.

The reference keeps its branches on the device (`lax.cond`).  Here the host
decides them: the cadence gates on `kf_id` need no read, and the local-BA
gate (more than 2 live keyframes) and the alive guard of
`map_keyframe_fused` each read one scalar through `device.read_host`.
`LocalMapping` runs the same sequence for the host engine: it is told
the live keyframe count, so its local-BA gate reads nothing, and it reads
one packed record per keyframe-culling round (stopping at the first round
that culls nothing).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.device import read_host, to_host
from aslam_tpu_torch.models import mapstate as ms
from aslam_tpu_torch.ops import lba, matching
from aslam_tpu_torch.ops.index import (nonzero_static, pick, set_rows,
                                       set_rows_last_wins)
from aslam_tpu_torch.ops.select import topk_stable
from aslam_tpu_torch.utils import camera
from aslam_tpu_torch.utils.se3 import T_inv


def _long(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


# ------------------------------------------------------------------- fuse

def fuse_landmarks(m: ms.MapState, slot: int, cfg: SystemConfig) -> ms.MapState:
    """Project the landmarks of covisible KFs into keyframe `slot`; bind them
    to free features, and where a feature is bound already, merge the two
    landmarks into the better-observed one (the loser's bindings are
    redirected and its live observer entries copied to the winner)."""
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]
    O = m.lm_obs_kf.shape[1]

    w_row = ms.covis_row_fast(m, slot)
    nb_vals, nb_idx = topk_stable(torch.where(m.kf_valid, w_row, -1),
                                  min(64, K))
    cand = ms.landmark_mask_of_slots(m, nb_idx,
                                     nb_vals >= cfg.map.covis_min_weight)
    own = m.kf_lm[slot]
    cand = cand & ~set_rows(torch.zeros_like(m.lm_valid),
                            torch.where(own >= 0, _long(own), L), True)
    vis, pred_uv, _, _ = camera.in_frustum(cfg.camera, m.kf_T_cw[slot],
                                           m.lm_pos)
    cidx, cvalid, _ = matching.compact_candidates(
        cand & vis, min(cfg.map.proj_match_cap, L))
    pm = matching.projection_match(
        m.lm_desc[cidx], cvalid, pred_uv[cidx],
        m.kf_xy[slot], m.kf_desc[slot], m.kf_kp_valid[slot],
        m.kf_octave[slot], torch.ones_like(m.kf_kp_valid[slot]),
        radius=cfg.matcher.fuse_radius,
        th_high=float(cfg.matcher.th_low),      # Fuse uses TH_LOW
        ratio=1.0,                              # no ratio test in Fuse
    )
    tgt_feat = torch.where(pm.valid, _long(pm.target_idx), M)
    own_pad = torch.cat([own, own.new_full((1,), -1)])
    existing = own_pad[tgt_feat]                # [cap] bound landmark or -1
    lm_ids = cidx

    # case A: feature free -> bind the landmark
    bind = pm.valid & (existing < 0)
    new_row = set_rows(own, torch.where(bind, tgt_feat, M),
                       torch.where(bind, lm_ids, -1).to(torch.int32))

    # case B: feature bound to another landmark -> merge, keeping the one
    # with more live observers, over a compact pair set
    dup = pm.valid & (existing >= 0) & (existing != lm_ids)
    P = min(512, dup.shape[0])
    dup_idx, dup_ok, _ = matching.compact_candidates(dup, P)
    ex_d = _long(torch.clamp(existing[dup_idx], min=0))
    new_d = lm_ids[dup_idx]
    _, _, ok_ex = ms.observer_entries(m, ex_d, dup_ok)
    _, _, ok_new = ms.observer_entries(m, new_d, dup_ok)
    keep_existing = torch.sum(ok_ex, dim=1) >= torch.sum(ok_new, dim=1)
    loser = torch.where(dup_ok, torch.where(keep_existing, new_d, ex_d), L)
    winner = torch.where(dup_ok, torch.where(keep_existing, ex_d, new_d), L)
    redirect = set_rows_last_wins(
        torch.arange(L + 1, dtype=torch.int32, device=loser.device), loser,
        winner.to(torch.int32))
    redirect = torch.cat([redirect[:L], redirect.new_full((1,), -1)])

    lm_valid = set_rows(m.lm_valid, loser, False)
    kf_lm = m.kf_lm.clone()
    kf_lm[slot] = new_row
    # the landmark Replace cascade as one gather over every binding
    kf_lm = redirect[torch.where(kf_lm >= 0, _long(kf_lm), L)]
    m = m._replace(kf_lm=kf_lm, lm_valid=lm_valid)

    # observer index: the new (slot, feature) bindings ...
    m = ms.append_observations(m, torch.where(bind, lm_ids, 0),
                               torch.where(bind, pm.target_idx, 0), slot, bind)
    # ... and the loser's live entries, which now bind the winner, copied
    # into the winner's ring
    okf_pad = torch.cat([m.lm_obs_kf, m.lm_obs_kf.new_full((1, O), -1)])
    ofe_pad = torch.cat([m.lm_obs_feat, m.lm_obs_feat.new_zeros((1, O))])
    ptr_pad = torch.cat([m.lm_obs_ptr, m.lm_obs_ptr.new_zeros(1)])
    lsel = torch.where(dup_ok, loser, L)
    lokf, lofe = okf_pad[lsel], ofe_pad[lsel]                # [P,O]
    kfs = _long(torch.clamp(lokf, min=0))
    ent_ok = (lokf >= 0) & m.kf_valid[kfs] \
        & (kf_lm[kfs, _long(lofe)] == winner[:, None])
    off = torch.cumsum(ent_ok.to(torch.int64), dim=1) - 1
    pos = (_long(ptr_pad[winner])[:, None] + off) % O
    tgt_w = torch.where(ent_ok, winner[:, None], L)
    okf_new = set_rows_last_wins(m.lm_obs_kf, (tgt_w, pos),
                                 torch.where(ent_ok, lokf, -1))
    ofe_new = set_rows_last_wins(m.lm_obs_feat, (tgt_w, pos), lofe)
    ptr_new = ptr_pad.index_add(
        0, winner, torch.sum(ent_ok, dim=1, dtype=torch.int32))[:L]
    return m._replace(lm_obs_kf=okf_new, lm_obs_feat=ofe_new,
                      lm_obs_ptr=ptr_new)


# --------------------------------------------------------------- local BA

class WindowSpec(NamedTuple):
    cam_slots: torch.Tensor   # [C] int64 KF slots in the problem
    cam_fixed: torch.Tensor   # [C] bool
    cam_valid: torch.Tensor   # [C] bool


def build_window(m: ms.MapState, slot: int, cfg: SystemConfig) -> WindowSpec:
    """The BA window: the current KF and its top covisible KFs (weight >=
    covis_min_weight, or the single best neighbour when none reaches it)
    optimised; the remaining KFs most covisible with the window, and the
    oldest KF as gauge, fixed."""
    K = m.kf_valid.shape[0]
    n_win = cfg.ba.max_window_cams
    n_fix = cfg.ba.max_fixed_cams
    dev = m.kf_valid.device
    ar = torch.arange(K, device=dev)
    w_row = torch.where(m.kf_valid & (ar != slot), ms.covis_row_fast(m, slot),
                        -1)
    win_vals, win_idx = topk_stable(w_row, min(n_win - 1, K))
    slot_t = torch.full((1,), slot, dtype=torch.int64, device=dev)
    cam_slots_w = torch.cat([slot_t, win_idx])[:n_win]
    th_w = float(cfg.map.covis_min_weight)
    connected = win_vals >= th_w
    no_conn = ~torch.any(connected)
    # reference fallback: connect the single max-weight neighbour
    connected = torch.cat([connected[:1] | (no_conn & (win_vals[0] > 0)),
                           connected[1:]])
    valid_w = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         connected])[:n_win]

    in_win = set_rows(torch.zeros_like(m.kf_valid),
                      torch.where(valid_w, cam_slots_w, K), True)
    W_win = ms.covis_rows_fast(m, cam_slots_w)
    anchor_score = torch.where(m.kf_valid & ~in_win,
                               torch.amax(W_win * valid_w[:, None], dim=0), -1)
    fix_vals, fix_idx = topk_stable(anchor_score, min(n_fix, K))
    valid_f = fix_vals > 0
    # always anchor the oldest KF (gauge) when it is not in the window
    oldest = torch.argmax(torch.where(m.kf_valid, -m.kf_id, -(2**30)))
    oldest_out = ~pick(in_win, oldest)
    fix_idx = torch.cat([torch.where(oldest_out, oldest, fix_idx[0])[None],
                         fix_idx[1:]])
    valid_f = torch.cat([(valid_f[0] | oldest_out)[None], valid_f[1:]])

    cam_slots = torch.cat([cam_slots_w, fix_idx])
    cam_valid = torch.cat([valid_w, valid_f])
    # gauge when the whole map fits in the window: the oldest window KF
    fix_w = (cam_slots_w == oldest) & valid_w & ~torch.any(valid_f)
    fix_w = torch.cat([(fix_w[0] | (torch.sum(m.kf_valid) <= 1))[None],
                       fix_w[1:]])
    cam_fixed = torch.cat([fix_w, torch.ones(n_fix, dtype=torch.bool,
                                             device=dev)])
    return WindowSpec(cam_slots, cam_fixed, cam_valid)


def build_chain(m: ms.MapState, spec: WindowSpec,
                cfg: SystemConfig) -> lba.ChainSpec:
    """Odometry-chain edges between temporally consecutive window cams
    whose kf_ids are at most chain_max_gap apart, anchored at their current
    relative transforms."""
    ids = torch.where(spec.cam_valid, m.kf_id[spec.cam_slots], 2**30)
    order = torch.argsort(ids, stable=True)
    c_i, c_j = order[:-1], order[1:]
    both = (ids[c_i] < 2**30) & (ids[c_j] < 2**30)
    adjacent = (ids[c_j] - ids[c_i]) <= cfg.ba.chain_max_gap
    T = m.kf_T_cw[spec.cam_slots]
    return lba.ChainSpec(
        c_i=c_i, c_j=c_j, c_meas=T[c_i] @ T_inv(T[c_j]),
        c_w=torch.where(both & adjacent, cfg.ba.chain_prior_weight, 0.0))


def build_problem(m: ms.MapState, spec: WindowSpec, cfg: SystemConfig):
    """The BAProblem of the window: edges are the window KFs' feature slots
    (C*M, masked), landmarks the optimisable ones (observed by a non-fixed
    window cam) gathered into a compact index space of max_window_points.
    -> (BAProblem, lw_ids [Lw] global landmark ids, n_overflow scalar:
    optimisable landmarks that did not fit and keep their positions)."""
    C = spec.cam_slots.shape[0]
    M = m.kf_lm.shape[1]
    L = m.lm_pos.shape[0]
    Lw = cfg.ba.max_window_points
    dev = m.kf_valid.device

    rows = m.kf_lm[spec.cam_slots]                           # [C,M]
    has = (rows >= 0) & m.kf_kp_valid[spec.cam_slots] & spec.cam_valid[:, None]
    lm_idx = torch.where(has, _long(rows), 0)
    win_obs = set_rows(torch.zeros_like(m.lm_valid),
                       torch.where(has & ~spec.cam_fixed[:, None], lm_idx, L),
                       True)
    point_opt = win_obs & m.lm_valid
    n_opt = torch.sum(point_opt.to(torch.int32))
    lw_ids = nonzero_static(point_opt, Lw, 0)
    ar_w = torch.arange(Lw, device=dev)
    lw_valid = ar_w < n_opt
    g2l = set_rows(torch.full((L,), -1, dtype=torch.int64, device=dev),
                   torch.where(lw_valid, lw_ids, L), ar_w)
    e_lm_local = g2l[lm_idx]
    e_valid = has & m.lm_valid[lm_idx] & (e_lm_local >= 0)
    prob = lba.BAProblem(
        cam_T=m.kf_T_cw[spec.cam_slots],
        cam_fixed=spec.cam_fixed,
        cam_valid=spec.cam_valid,
        points=m.lm_pos[lw_ids],
        point_valid=lw_valid,
        e_cam=torch.arange(C, device=dev)[:, None].expand(C, M).reshape(-1),
        e_lm=torch.clamp(e_lm_local, min=0).reshape(-1),
        e_uv=m.kf_xy[spec.cam_slots].reshape(-1, 2),
        e_ur=m.kf_ur[spec.cam_slots].reshape(-1),
        e_z=m.kf_z[spec.cam_slots].reshape(-1),
        e_valid=e_valid.reshape(-1),
    )
    return prob, lw_ids, torch.clamp(n_opt - Lw, min=0)


def write_back(m: ms.MapState, spec: WindowSpec, prob: lba.BAProblem,
               lw_ids: torch.Tensor) -> ms.MapState:
    """Optimised poses and points back into the map, and pruned edges'
    observations erased (kf_lm := -1).

    The reference rewrites every window row, invalid ones included, with
    one scatter; an invalid fixed entry can name a window KF's slot, and
    then its unpruned row lands last and wins on the CPU.  The port keeps
    that order (`set_rows_last_wins`)."""
    C, M = spec.cam_slots.shape[0], m.kf_lm.shape[1]
    K = m.kf_valid.shape[0]
    L = m.lm_pos.shape[0]
    write_cam = spec.cam_valid & ~spec.cam_fixed
    kf_T = set_rows(m.kf_T_cw, torch.where(write_cam, spec.cam_slots, K),
                    prob.cam_T)
    safe_lw = torch.where(prob.point_valid, lw_ids, L)
    lm_pos = set_rows(m.lm_pos, safe_lw, prob.points)
    point_opt_g = set_rows(torch.zeros_like(m.lm_valid), safe_lw, True)
    rows0 = m.kf_lm[spec.cam_slots]
    pruned = (~prob.e_valid.reshape(C, M)) & (rows0 >= 0) \
        & spec.cam_valid[:, None] & point_opt_g[_long(torch.clamp(rows0, min=0))]
    rows = torch.where(pruned, -1, rows0)
    kf_lm = set_rows_last_wins(
        m.kf_lm, (spec.cam_slots[:, None],
                  torch.arange(M, device=rows.device)[None, :]),
        torch.where(spec.cam_valid[:, None], rows, rows0))
    return m._replace(kf_T_cw=kf_T, lm_pos=lm_pos, kf_lm=kf_lm)


# ------------------------------------------------------ per-keyframe body

def empty_cull_info(device) -> ms.CullInfo:
    """CullInfo [3] with no culls."""
    return ms.CullInfo(
        culled=torch.zeros(3, dtype=torch.bool, device=device),
        kf_id=torch.full((3,), -1, dtype=torch.int32, device=device),
        parent_kf_id=torch.full((3,), -1, dtype=torch.int32, device=device),
        T_cp=torch.eye(4, device=device).repeat(3, 1, 1),
    )


def empty_cull_info_single(device) -> ms.CullInfo:
    """One no-op culling round."""
    return ms.CullInfo(
        culled=torch.zeros((), dtype=torch.bool, device=device),
        kf_id=torch.full((), -1, dtype=torch.int32, device=device),
        parent_kf_id=torch.full((), -1, dtype=torch.int32, device=device),
        T_cp=torch.eye(4, device=device),
    )


def _refine_keyframe(m: ms.MapState, slot: int, kf_id: int, cfg: SystemConfig,
                     n_live: int | None = None) -> ms.MapState:
    """The refinement up to the keyframe culling: descriptor refresh,
    landmark culling, fuse, position refresh, local BA.  The local BA needs
    more than 2 live keyframes: `n_live` when the caller knows the count,
    else one host read where the cadence lets the BA run."""
    row = m.kf_lm[slot]
    m = ms.refresh_landmark_descriptors_ids(
        m, torch.clamp(row, min=0), (row >= 0) & m.kf_kp_valid[slot])
    if cfg.map.lm_cull_every <= 1 or kf_id % cfg.map.lm_cull_every == 0:
        m = ms.landmark_culling(m, kf_id, cfg)
    m = fuse_landmarks(m, slot, cfg)
    if cfg.map.refresh_positions:
        row2 = m.kf_lm[slot]    # post-fuse: includes newly bound landmarks
        m = ms.refresh_landmark_positions_ids(
            m, torch.clamp(row2, min=0), (row2 >= 0) & m.kf_kp_valid[slot], cfg)
        if cfg.map.global_refresh_every > 0 \
                and kf_id % cfg.map.global_refresh_every == 0:
            m = ms.refresh_landmark_positions(m, cfg)
    if cfg.map.enable_local_ba and (cfg.map.lba_every <= 1
                                    or kf_id % cfg.map.lba_every == 0):
        if n_live is None:
            (n_live,) = read_host(torch.sum(m.kf_valid.to(torch.int32)))
        if n_live > 2:
            spec = build_window(m, slot, cfg)
            prob, lw_ids, _ = build_problem(m, spec, cfg)
            chain = (build_chain(m, spec, cfg)
                     if cfg.ba.chain_prior_weight > 0 else None)
            prob, _ = lba.local_ba(prob, cfg.camera, cfg.ba, chain=chain,
                                   group=m.kf_lm.shape[1])
            m = write_back(m, spec, prob, lw_ids)
    return m


def map_keyframe_body(m: ms.MapState, slot: int, kf_id: int,
                      cfg: SystemConfig):
    """The whole refinement of keyframe `slot` (id `kf_id`): descriptor
    refresh -> landmark culling -> fuse -> position refresh -> windowed LBA
    (> 2 live KFs) -> keyframe culling (`kf_cull_rounds` rounds of at most
    one victim).  -> (map, CullInfo [3], `culled` False on no-op rounds)."""
    dev = m.kf_valid.device
    m = _refine_keyframe(m, slot, kf_id, cfg)
    rounds = max(cfg.map.kf_cull_rounds, 1)
    do_cull = cfg.map.kf_cull_every <= 1 or kf_id % cfg.map.kf_cull_every == 0
    infos = []
    for i in range(3):
        if do_cull and i < rounds:
            m, cull = ms.keyframe_culling(m, slot, cfg)
        else:
            cull = empty_cull_info_single(dev)
        infos.append(cull)
    return m, ms.CullInfo(*(torch.stack(x) for x in zip(*infos)))


def map_keyframe_fused(m: ms.MapState, slot: int, kf_id: int,
                       cfg: SystemConfig):
    """`map_keyframe_body` behind an alive guard (one host read): a no-op
    with empty cull records when `slot` no longer holds `kf_id`."""
    alive, = read_host(m.kf_valid[slot] & (m.kf_id[slot] == kf_id))
    if not alive:
        return m, empty_cull_info(m.kf_valid.device)
    return map_keyframe_body(m, slot, kf_id, cfg)


class LocalMapping:
    """The per-keyframe refinement as the host engine runs it."""

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        self.n_processed = 0
        # culled-KF parent chain: kf_id -> (parent_kf_id, T_cp [4,4]).  The
        # trajectory recovery walks it to a surviving ancestor when a
        # frame's reference keyframe was culled.
        self.culled: dict[int, tuple[int, np.ndarray]] = {}

    def process_keyframe(self, m: ms.MapState, slot: int, kf_id: int,
                         n_kfs: int) -> ms.MapState:
        """Refine around keyframe `slot` (id `kf_id`); `n_kfs` is the live
        keyframe count as of its insertion."""
        cfg = self.cfg
        m = _refine_keyframe(m, slot, kf_id, cfg, n_live=n_kfs)
        # each culling call removes at most one victim, where the
        # reference's pass can erase several: repeat until none remains,
        # bounded per insertion
        rounds = (max(cfg.map.kf_cull_rounds, 1)
                  if kf_id % max(cfg.map.kf_cull_every, 1) == 0 else 0)
        for _ in range(rounds):
            m, cull = ms.keyframe_culling(m, slot, cfg)
            rec = to_host(torch.cat([
                torch.stack([cull.culled.to(torch.float32),
                             cull.kf_id.to(torch.float32),
                             cull.parent_kf_id.to(torch.float32)]),
                cull.T_cp.reshape(-1)]))
            if rec[0] < 0.5:
                break
            self.culled[int(rec[1])] = (int(rec[2]), rec[3:].reshape(4, 4))
        self.n_processed += 1
        return m

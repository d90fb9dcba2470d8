"""Loop closing: detection (BoW database query), geometric verification
(BoW-guided matching + 3D-3D RANSAC) and correction (pose-graph
optimization, landmark re-anchoring, post-loop global BA).

Port of `aslam_tpu/models/loopclosing.py`, relocalization included (a lost
frame, or the first frame of a new sequence, queries the same database and
re-acquires its pose by BoW-guided matching + 3D-3D RANSAC against the best
candidates).  Database query semantics: candidates must share words with the
query, covisible neighbours and keyframes closer than `min_kf_gap` ids are
excluded, scores below `min_score` are dropped, and covisibility-group score
accumulation keeps candidates above 0.75x the best accumulated score.

Keyframe slots and ids are Python ints: the host decides them (they come
from the engine's ring read).  What the host reads of the device, each
counted in `device.read_host.count`:

  * per sync (`process_keyframes_batch`) one packed read of every fresh
    keyframe's candidates, scores, groups and of `kf_id`;
  * per keyframe whose candidates pass the consistency gate, one stacked
    read of the verification records;
  * per vocabulary (re)training one read of the sampled descriptors;
  * per relocalization one read of the scores, then one per candidate
    tried;
  * per step of the sharded post-loop GBA (`post_gba_method=
    "sharded_gn_cg"`) two reads, the covisibility counts and the keyframe
    validity its placement is computed from (`parallel/partition.py`).

The RANSAC of the verification draws from a generator on the map's device;
`verify_loop` and `verify_and_gate` take the raw draws optionally, as
`ops/ransac.py::ransac_align` does.  `lax.map` over a window of keyframes
is a Python loop (the reference's power-of-two padding of the window served
its compiler and is gone).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.device import to_host
from aslam_tpu_torch.models import mapstate as ms
from aslam_tpu_torch.ops import bow, matching, pose_graph, ransac
from aslam_tpu_torch.ops import global_ba as gba
from aslam_tpu_torch.ops.hamming import INVALID_DIST, masked_distance_matrix
from aslam_tpu_torch.ops.lba import map_chain
from aslam_tpu_torch.ops.select import topk_stable
from aslam_tpu_torch.parallel import launch
from aslam_tpu_torch.parallel.mesh import make_mesh
from aslam_tpu_torch.parallel.partition import partitioned_gn_cg_step
from aslam_tpu_torch.utils import camera
from aslam_tpu_torch.utils.se3 import T_inv


class DatabaseState(NamedTuple):
    kf_bow: torch.Tensor    # [K,W] tf-idf vectors
    kf_hist: torch.Tensor   # [K,W] bool word presence
    kf_words: torch.Tensor  # [K,M] int32 word id per feature
    kf_in_db: torch.Tensor  # [K] bool


def init_database(cfg: SystemConfig, device: torch.device | str) -> DatabaseState:
    K = cfg.map.max_keyframes
    M = cfg.extractor.max_keypoints
    W = cfg.loop.vocab_branching ** cfg.loop.vocab_depth
    return DatabaseState(
        kf_bow=torch.zeros(K, W, dtype=torch.float32, device=device),
        kf_hist=torch.zeros(K, W, dtype=torch.bool, device=device),
        kf_words=torch.zeros(K, M, dtype=torch.int32, device=device),
        kf_in_db=torch.zeros(K, dtype=torch.bool, device=device),
    )


def _word_presence(words: torch.Tensor, valid: torch.Tensor, W: int):
    """[...,W] bool: the words of the valid features of each row."""
    tgt = torch.where(valid, words.to(torch.int64), W)
    hist = torch.zeros(words.shape[:-1] + (W + 1,), dtype=torch.bool,
                       device=words.device)
    hist.scatter_(-1, tgt, torch.ones_like(tgt, dtype=torch.bool))
    return hist[..., :W]


def add_keyframe(db: DatabaseState, vocab: bow.Vocabulary, desc: torch.Tensor,
                 valid: torch.Tensor, slot: int) -> DatabaseState:
    """Enter keyframe `slot` (descriptors [M,8], validity [M])."""
    words = bow.transform(vocab, desc)
    vec = bow.bow_vector(vocab, words, valid)
    hist = _word_presence(words, valid, vec.shape[0])
    return DatabaseState(
        kf_bow=ms._set_row(db.kf_bow, slot, vec),
        kf_hist=ms._set_row(db.kf_hist, slot, hist),
        kf_words=ms._set_row(db.kf_words, slot, words),
        kf_in_db=ms._set_row(db.kf_in_db, slot, True),
    )


def add_keyframes_batch(vocab: bow.Vocabulary, desc: torch.Tensor,
                        valid: torch.Tensor,
                        include: torch.Tensor) -> DatabaseState:
    """The whole database rebuilt in one batched pass: tree descent and BoW
    vectors over every keyframe row [K,M,8], rows without include[k] left
    empty."""
    words = bow.transform(vocab, desc)                        # [K,M]
    vecs = bow.bow_vector(vocab, words, valid)                # [K,W]
    hist = _word_presence(words, valid, vecs.shape[1])
    inc = include[:, None]
    return DatabaseState(
        kf_bow=torch.where(inc, vecs, 0.0),
        kf_hist=hist & inc,
        kf_words=torch.where(inc, words, 0),
        kf_in_db=include,
    )


def _gather_train_descriptors(m: ms.MapState, cap: int) -> torch.Tensor:
    """Up to `cap` valid descriptors, pseudo-randomly subsampled on the
    device (Knuth-hash priorities) -> [cap,9] int32: the descriptor words
    and, last, whether the row holds a valid one (one tensor, one read for
    the caller)."""
    ok = (m.kf_kp_valid & m.kf_valid[:, None]).reshape(-1)
    n = ok.shape[0]
    prio = (torch.arange(n, dtype=torch.int64, device=ok.device)
            * 2654435761) % 2**32
    prio = torch.where(prio >= 2**31, prio - 2**32, prio)     # as int32
    prio = torch.where(ok, prio, -2**31)
    _, idx = topk_stable(prio, min(cap, n))
    return torch.cat([m.kf_desc.reshape(-1, 8)[idx],
                      ok[idx, None].to(torch.int32)], dim=1)


def _pack_query(cands, scores, groups, kf_id) -> torch.Tensor:
    """Everything the host resolves from, as one float32 vector."""
    return torch.cat([cands.to(torch.float32).reshape(-1), scores.reshape(-1),
                      groups.to(torch.float32).reshape(-1),
                      kf_id.to(torch.float32)])


def _unpack_query(flat: np.ndarray, B: int, n_c: int, K: int):
    cands = flat[:B * n_c].reshape(B, n_c).astype(np.int32)
    scores = flat[B * n_c:2 * B * n_c].reshape(B, n_c)
    groups = flat[2 * B * n_c:2 * B * n_c + B * n_c * K] \
        .reshape(B, n_c, K).astype(bool)
    return cands, scores, groups, flat[-K:].astype(np.int64)


def batch_query(db: DatabaseState, m: ms.MapState, slots, kf_ids,
                cfg: SystemConfig):
    """`query_candidates` for a window of keyframes (sequences of ints)
    -> stacked (cands [B,N], scores [B,N], groups [B,N,K]), unread."""
    outs = [query_candidates(db, m, int(slot),
                             (int(kid) - m.kf_id) >= cfg.loop.min_kf_gap, cfg)
            for slot, kid in zip(slots, kf_ids)]
    return tuple(torch.stack(x) for x in zip(*outs))


def query_candidates(db: DatabaseState, m: ms.MapState, slot: int,
                     kf_gap_ok: torch.Tensor, cfg: SystemConfig):
    """Database query for keyframe `slot` -> (cand_slots [N] int32 with -1
    padding, cand_scores [N], cand_groups [N,K] bool covisibility groups for
    the consistency gate), N = cfg.loop.top_candidates, best first."""
    K = m.kf_valid.shape[0]
    ar = torch.arange(K, device=m.kf_valid.device)
    row_q = ms.covis_row_fast(m, slot)
    eligible = db.kf_in_db & m.kf_valid & (row_q == 0) & (ar != slot) \
        & kf_gap_ok
    # shared-word filter: > 0.8 * max common words
    common = bow.shared_word_counts(db.kf_words[slot], m.kf_kp_valid[slot],
                                    db.kf_hist)
    max_common = torch.max(torch.where(eligible, common, 0.0))
    word_ok = common > cfg.loop.word_fraction * max_common

    scores = bow.l1_scores(db.kf_bow[slot], db.kf_bow)
    ok = eligible & word_ok & (scores >= cfg.loop.min_score)
    base = torch.where(ok, scores, 0.0)

    # covisibility-group accumulation, restricted to the 32 best-scored
    # candidates: only their covisibility rows are gathered
    n_acc = min(32, K)
    b_vals, b_idx = topk_stable(torch.where(ok, scores, -1.0), n_acc)
    rows = ms.covis_rows_fast(m, b_idx)                        # [n_acc,K]
    acc_sel = b_vals + torch.sum((rows > 0) * base[None, :], dim=1)
    # found = the slot held an `ok` candidate (ok scores are >= 0, padding
    # is -1; a score of exactly 0 is legal when min_score == 0)
    acc = torch.full((K,), -1.0, device=scores.device).scatter_reduce(
        0, b_idx, torch.where(b_vals >= 0, acc_sel, -1.0), "amax")
    good = ok & (acc >= cfg.loop.score_fraction * torch.max(acc))

    top_scores, top_idx = topk_stable(torch.where(good, scores, -1.0),
                                      cfg.loop.top_candidates)
    found = top_scores >= 0
    cand_slots = torch.where(found, top_idx, -1).to(torch.int32)
    # covisibility group of each candidate: itself + its covisible KFs
    grp = (ms.covis_rows_fast(m, top_idx) > 0) \
        | (ar[None, :] == top_idx[:, None])
    grp = grp & found[:, None] & m.kf_valid[None, :]
    return cand_slots, top_scores, grp


def bow_guided_match(
    words_a: torch.Tensor, desc_a: torch.Tensor, valid_a: torch.Tensor,
    words_b: torch.Tensor, desc_b: torch.Tensor, valid_b: torch.Tensor,
    cfg: SystemConfig,
) -> matching.Matches:
    """Node-bucketed descriptor match with TH_LOW and the BoW ratio test:
    candidates must share an ancestor tree node
    (`cfg.loop.match_node_levels` levels above the leaf, 0 = the leaf
    itself), expressed as a mask on the distance matrix."""
    d = masked_distance_matrix(desc_a, valid_a, desc_b, valid_b)
    div = cfg.loop.vocab_branching ** min(cfg.loop.match_node_levels,
                                          cfg.loop.vocab_depth - 1)
    same_word = (words_a[:, None] // div) == (words_b[None, :] // div)
    d = torch.where(same_word, d, INVALID_DIST)
    d1, i1, d2, _ = matching._top2(d)
    ok = (d1 <= cfg.matcher.th_low) & (d1 < cfg.matcher.ratio_bow * d2)
    mm = matching.Matches(target_idx=torch.where(ok, i1, -1), distance=d1,
                          valid=ok)
    return matching.resolve_duplicates(mm, desc_b.shape[0])


def verify_loop(db: DatabaseState, m: ms.MapState, q: int, c: int,
                generator: torch.Generator | None, cfg: SystemConfig,
                draws: torch.Tensor | None = None):
    """BoW-guided matching + 3D-3D RANSAC between query and candidate KFs
    -> (T_qc [4,4], n_inliers, ok)."""
    cam = cfg.camera
    mm = bow_guided_match(
        db.kf_words[c], m.kf_desc[c], m.kf_kp_valid[c],
        db.kf_words[q], m.kf_desc[q], m.kf_kp_valid[q], cfg)
    p_c = camera.unproject(cam, m.kf_xy[c], m.kf_z[c])
    p_q = camera.unproject(cam, m.kf_xy[q], m.kf_z[q])
    tgt = torch.clamp(mm.target_idx, min=0).long()
    pair_valid = mm.valid & (m.kf_z[c] > 0) & (m.kf_z[q][tgt] > 0)
    res = ransac.ransac_align(p_c, p_q[tgt], pair_valid, generator, cfg.ransac,
                              cam, draws=draws)
    return res.T12, res.n_inliers, res.ok


def verify_and_gate(db: DatabaseState, m: ms.MapState, q: int, c: int,
                    generator: torch.Generator | None, cfg: SystemConfig,
                    draws: torch.Tensor | None = None) -> torch.Tensor:
    """`verify_loop` plus the discrepancy gate's delta as one flat [20]
    vector: [T_qc (16), n_inliers, ok, dt, dr].  The resolve path stacks one
    per candidate and reads them in a single transfer."""
    T_qc, n_inl, ok = verify_loop(db, m, q, c, generator, cfg, draws=draws)
    T_rel_est = m.kf_T_cw[q] @ T_inv(m.kf_T_cw[c])
    delta = T_qc @ T_inv(T_rel_est)
    dt = torch.linalg.vector_norm(delta[:3, 3])
    trace = delta[0, 0] + delta[1, 1] + delta[2, 2]
    dr = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    return torch.cat([
        T_qc.reshape(-1),
        torch.stack([n_inl.to(torch.float32), ok.to(torch.float32), dt, dr])])


def build_pose_graph(m: ms.MapState, q: int, c: int, T_qc: torch.Tensor,
                     cfg: SystemConfig, edges_per_node: int = 8,
                     loop_inliers: int | None = None) -> pose_graph.PoseGraph:
    """Graph: the top covisibility edges per KF + the temporal chain + the
    loop edge; measurements from the current estimates except the loop edge.

    A covisibility or temporal edge carries weight 1.0 (or a
    covisibility-proportional one, `cfg.loop.covis_weighted_edges`); the
    loop edge is a RANSAC fit over `loop_inliers` point pairs and weighs
    loop_inliers / covis_min_weight, clamped to [1, 20]."""
    K = m.kf_valid.shape[0]
    dev = m.kf_valid.device
    covis = ms.covisibility(m, chunk=cfg.map.covis_chunk)
    w = torch.where(m.kf_valid[:, None] & m.kf_valid[None, :], covis, 0)
    top_w, top_j = topk_stable(w, edges_per_node)              # [K,e]

    e_i = torch.arange(K, dtype=torch.int32, device=dev) \
        .repeat_interleave(edges_per_node)
    e_j = top_j.reshape(-1).to(torch.int32)
    top_w = top_w.reshape(-1)
    strong = top_w >= cfg.map.covis_min_weight
    if cfg.loop.covis_weighted_edges:
        e_w = torch.where(
            strong, torch.clamp(top_w / cfg.map.covis_min_weight, 0.0, 4.0),
            0.0)
    else:
        e_w = torch.where(strong, 1.0, 0.0)

    # temporal chain: consecutive insertion ids
    order = torch.argsort(torch.where(m.kf_valid, m.kf_id, 2**30), stable=True)
    t_i, t_j = order[:-1], order[1:]
    t_w = torch.where(m.kf_valid[t_i] & m.kf_valid[t_j], 1.0, 0.0)

    lw = 10.0 if loop_inliers is None else min(max(
        float(np.float32(loop_inliers) / np.float32(cfg.map.covis_min_weight)),
        1.0), 20.0)
    e_i = torch.cat([e_i, t_i.to(torch.int32),
                     torch.full((1,), q, dtype=torch.int32, device=dev)])
    e_j = torch.cat([e_j, t_j.to(torch.int32),
                     torch.full((1,), c, dtype=torch.int32, device=dev)])
    e_w = torch.cat([e_w, t_w,
                     torch.full((1,), lw, dtype=torch.float32, device=dev)])
    e_w = torch.where(e_i == e_j, 0.0, e_w)

    meas = m.kf_T_cw[e_i[:-1].long()] @ T_inv(m.kf_T_cw[e_j[:-1].long()])
    # the loop edge's measurement is RANSAC's T_qc
    meas = torch.cat([meas, T_qc.to(meas.dtype)[None]])

    ar = torch.arange(K, device=dev)
    oldest = torch.argmax(torch.where(m.kf_valid, -m.kf_id, -(2**30)))
    fixed = ar == oldest
    if cfg.loop.localized_window:
        # anchor the candidate's old-side covisibility group and the
        # candidate itself: the revisited map segment is the trusted datum.
        # Members newer than the candidate stay free.
        old_side = (w[c] >= cfg.map.covis_min_weight) \
            & (m.kf_id <= m.kf_id[c]) & m.kf_valid
        fixed = (fixed | old_side | (ar == c)) & (ar != q)
    return pose_graph.PoseGraph(
        T=m.kf_T_cw, node_valid=m.kf_valid, node_fixed=fixed,
        e_i=e_i, e_j=e_j, e_meas=meas, e_w=e_w)


def correct_map(m: ms.MapState, T_new: torch.Tensor) -> ms.MapState:
    """Apply optimized KF poses and re-anchor every landmark through its
    first observing keyframe (the earliest-inserted one)."""
    K = m.kf_valid.shape[0]
    L = m.lm_pos.shape[0]
    dev = m.kf_valid.device
    # owner by two scatter-min passes over the [K,M] observation table:
    # the least observing kf_id per landmark, then the slot carrying it
    obs_ok = m.kf_kp_valid & m.kf_valid[:, None] & (m.kf_lm >= 0)
    idx = torch.where(obs_ok, m.kf_lm.to(torch.int64), L).reshape(-1)
    kfid_b = torch.where(m.kf_valid, m.kf_id.to(torch.int64), 2**30)[:, None] \
        .expand(m.kf_lm.shape).reshape(-1)
    owner_id = torch.full((L + 1,), 2**30, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, idx, kfid_b, "amin")
    slot_b = torch.arange(K, dtype=torch.int64, device=dev)[:, None] \
        .expand(m.kf_lm.shape).reshape(-1)
    is_owner = kfid_b == owner_id[idx]
    owner = torch.full((L + 1,), K, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, torch.where(is_owner, idx, L), slot_b, "amin")[:L]
    has_owner = owner < K
    owner = torch.clamp(owner, 0, K - 1)

    # p' = inv(T_new[o]) T_old[o] p, in world coordinates
    fix = (T_inv(T_new) @ m.kf_T_cw)[owner]                   # [L,4,4]
    p_new = (fix[:, :3, :3] @ m.lm_pos[..., None])[..., 0] + fix[:, :3, 3]
    lm_pos = torch.where((has_owner & m.lm_valid)[:, None], p_new, m.lm_pos)
    return m._replace(kf_T_cw=T_new, lm_pos=lm_pos)


def _reloc_verify(db: DatabaseState, m: ms.MapState, cand: int,
                  frame, frame_words: torch.Tensor,
                  generator: torch.Generator | None, cfg: SystemConfig,
                  draws: torch.Tensor | None = None):
    """BoW-guided match + 3D-3D RANSAC of a lost frame (FrameData) against
    candidate keyframe `cand` -> (T_cw [4,4] for the frame, n_inliers, ok)."""
    cam = cfg.camera
    mm = bow_guided_match(
        db.kf_words[cand], m.kf_desc[cand], m.kf_kp_valid[cand],
        frame_words, frame.feat.desc, frame.feat.valid, cfg)
    p_kf = camera.unproject(cam, m.kf_xy[cand], m.kf_z[cand])
    tgt = torch.clamp(mm.target_idx, min=0).long()
    pair_valid = mm.valid & (m.kf_z[cand] > 0) & frame.has_depth[tgt]
    res = ransac.ransac_align(p_kf, frame.p3d[tgt], pair_valid, generator,
                              cfg.ransac, cam, draws=draws)
    # T12 maps kf-cam -> frame-cam: the frame's pose is T12 T_cw[kf]
    return res.T12 @ m.kf_T_cw[cand], res.n_inliers, res.ok


def _default_vocab_path(cfg: SystemConfig) -> str:
    """The shipped vocabulary artifact for the configured tree shape, in
    this package's own `assets/`."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
        f"vocab_{cfg.loop.vocab_branching}_{cfg.loop.vocab_depth}.npz")


class LoopClosing:
    """Host orchestration: vocabulary lifecycle, detection cadence and
    correction triggering, for a map on `device`."""

    # cap on descriptors fed to the hierarchical k-medians (host-side
    # training stays bounded as the map grows; subsampled uniformly)
    TRAIN_CAP = 20_000

    def __init__(self, cfg: SystemConfig, device: torch.device | str,
                 train_after_kfs: int = 4, vocab_path: str = "",
                 refresh_factor: float = 4.0, verbose: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.verbose = verbose
        self.db = init_database(cfg, self.device)
        self.vocab: bow.Vocabulary | None = None
        if not vocab_path and cfg.loop.use_pretrained_vocab:
            cand = _default_vocab_path(cfg)
            if os.path.exists(cand):
                vocab_path = cand
        if vocab_path:
            self.vocab = bow.load_vocabulary(vocab_path, self.device)
        self.train_after = train_after_kfs
        # incremental refresh: retrain once the map has refresh_factor x
        # more KFs than the vocabulary was trained on; <= 1 disables.  A
        # loaded vocabulary is never refreshed.
        self.refresh_factor = refresh_factor
        self.trained_on_kfs = -1 if self.vocab is None else 10**9
        self.last_loop_kf_id = -(10**9)
        self.generator = torch.Generator(device=self.device).manual_seed(123)
        self.loops: list[tuple[int, int]] = []
        # verified revisits whose transform already matched the estimate
        # (the discrepancy gate: no correction applied)
        self.consistent_revisits: list[tuple[int, int]] = []
        # temporal-consistency state: (set of kf_ids in the group,
        # consecutive detection count), replaced wholesale each keyframe
        self.consistent_groups: list[tuple[set, int]] = []
        # verify-event budget per batched sync (None = unlimited)
        self._sync_corrections_left: int | None = None
        self._gba_pending = False
        # the mesh of the sharded post-loop GBA, made at its first use
        self._mesh = None
        # RANSAC draws for the next verifications, in order (tests inject
        # the reference's); empty = draw from the generator
        self.verify_draws: list[torch.Tensor] = []
        # keyframe slots that `relocalize` anchored a frame to, in order
        self.relocalized: list[int] = []

    def _n_live(self, m: ms.MapState, n_live: int | None) -> int:
        if n_live is None:
            n_live = int(to_host(torch.sum(m.kf_valid)))
        return n_live

    def _rebuild(self, m: ms.MapState) -> None:
        self.db = add_keyframes_batch(self.vocab, m.kf_desc, m.kf_kp_valid,
                                      m.kf_valid)

    def _train(self, m: ms.MapState, n_live: int | None = None) -> bool:
        """(Re)train the vocabulary from the current map and rebuild the
        database under the new word space.  The training subsample is
        gathered on the device, so only TRAIN_CAP x 36 B are read."""
        rows = to_host(_gather_train_descriptors(m, self.TRAIN_CAP))
        train = rows[rows[:, 8] > 0, :8]
        if len(train) < 100:
            return False
        self.vocab = bow.train_vocabulary(
            train, branching=self.cfg.loop.vocab_branching,
            depth=self.cfg.loop.vocab_depth, device=self.device)
        self.trained_on_kfs = self._n_live(m, n_live)
        self._rebuild(m)
        return True

    def _maybe_train_vocab(self, m: ms.MapState, n_live: int | None = None):
        if self.vocab is not None:
            return
        n_live = self._n_live(m, n_live)
        if n_live < self.train_after:
            return
        self._train(m, n_live=n_live)

    def maybe_refresh(self, m: ms.MapState, n_live: int | None = None) -> bool:
        """Retrain and rebuild when the map has outgrown the training set.
        Pass `n_live` (the live KF count, which the engine's ring read
        carries) to avoid a device read."""
        if self.vocab is None or self.refresh_factor <= 1.0 \
                or self.trained_on_kfs >= 10**9:
            return False
        n_live = self._n_live(m, n_live)
        if n_live < self.refresh_factor * max(self.trained_on_kfs, 1):
            return False
        return self._train(m, n_live=n_live)

    def process_keyframe(self, m: ms.MapState, slot: int,
                         kf_id: int) -> ms.MapState:
        """Per-keyframe pipeline: database maintenance and detection on the
        device, one packed read, then consistency / verify / correct."""
        q = self._detect(m, slot, kf_id)
        if q is None:
            return m
        cands, scores, groups = q
        K = m.kf_valid.shape[0]
        flat = to_host(_pack_query(cands[None], scores[None], groups[None],
                                   m.kf_id))
        cands, scores, groups, kf_ids = _unpack_query(flat, 1, len(cands), K)
        return self._resolve(m, slot, kf_id, cands[0], scores[0], groups[0],
                             kf_ids)

    def _detect(self, m: ms.MapState, slot: int, kf_id: int):
        """Database add + candidate query for one keyframe -> unread
        (cands, scores, groups), or None when detection is gated off."""
        cfg = self.cfg
        self._maybe_train_vocab(m)
        if self.vocab is None:
            return None
        if not self.maybe_refresh(m):
            # a refresh rebuilds the database with every valid KF
            self.db = add_keyframe(self.db, self.vocab, m.kf_desc[slot],
                                   m.kf_kp_valid[slot], slot)
        if kf_id - self.last_loop_kf_id < cfg.loop.min_kf_gap:
            self.consistent_groups = []
            return None
        gap_ok = (kf_id - m.kf_id) >= cfg.loop.min_kf_gap
        return query_candidates(self.db, m, slot, gap_ok, cfg)

    def process_keyframes_batch(self, m: ms.MapState, slots, kf_ids_fresh,
                                n_live: int | None = None,
                                max_corrections: int = 4) -> ms.MapState:
        """The sync cadence: detection for a window of fresh keyframes with
        one packed read, then the rare consistency / verify / correct part
        in turn.  Fresh KFs of one window never become each other's
        candidates (`min_kf_gap` excludes them), so add-all-then-query
        equals the interleaved per-KF order.  `max_corrections` bounds the
        verify events per sync; further consistent candidates keep their
        streaks and are detected again at the next sync."""
        self._maybe_train_vocab(m, n_live=n_live)
        if self.vocab is None:
            return m
        self.maybe_refresh(m, n_live=n_live)
        self._rebuild(m)

        jobs = []
        for s, kid in zip(slots, kf_ids_fresh):
            if int(kid) - self.last_loop_kf_id < self.cfg.loop.min_kf_gap:
                self.consistent_groups = []
                continue
            jobs.append((int(s), int(kid)))
        if not jobs:
            return m
        # (set here, not before the gate above as the reference does: its
        # early return leaves the budget on for later per-keyframe calls)
        self._sync_corrections_left = max_corrections
        B, K = len(jobs), m.kf_valid.shape[0]
        cands_b, scores_b, groups_b = batch_query(
            self.db, m, [s for s, _ in jobs], [k for _, k in jobs], self.cfg)
        flat = to_host(_pack_query(cands_b, scores_b, groups_b, m.kf_id))
        cands_b, scores_b, groups_b, kf_ids = _unpack_query(
            flat, B, cands_b.shape[1], K)
        self._gba_pending = False
        for i, (s, kid) in enumerate(jobs):
            m = self._resolve(m, s, kid, cands_b[i], scores_b[i], groups_b[i],
                              kf_ids)
        if self._gba_pending:
            m = self._post_loop_gba(m)
            self._gba_pending = False
        self._sync_corrections_left = None   # per-KF path: unlimited
        return m

    def _resolve(self, m: ms.MapState, slot: int, kf_id: int,
                 cands: np.ndarray, scores: np.ndarray, groups: np.ndarray,
                 kf_ids: np.ndarray) -> ms.MapState:
        """Host part: temporal-consistency gate, geometric verification,
        discrepancy gate, pose-graph correction, post-loop GBA.  `kf_ids`
        is the map's kf_id table, read with the candidates."""
        cfg = self.cfg
        if self.verbose:
            print(f"  [lc] kf_id={kf_id} slot={slot} cands={cands.tolist()} "
                  f"scores={np.asarray(scores).round(4).tolist()} "
                  f"streak={[c for _, c in self.consistent_groups]}",
                  flush=True)
        if (cands < 0).all():
            self.consistent_groups = []  # detection streak broken
            return m

        # a candidate is verified only once its covisibility group has
        # intersected the groups detected in `consistency_th` consecutive
        # keyframes (counts start at 1 on the first detection)
        current_groups: list[tuple[set, int]] = []
        enough: list[int] = []
        for rank, c in enumerate(cands):
            if c < 0:
                continue
            group = set(int(i) for i in kf_ids[groups[rank]])
            count = 1
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            current_groups.append((group, count))
            if count >= cfg.loop.consistency_th:
                enough.append(int(c))
        self.consistent_groups = current_groups
        if not enough:
            return m

        if self._sync_corrections_left is not None:
            if self._sync_corrections_left <= 0:
                return m        # budget spent; streaks stay warm
            self._sync_corrections_left -= 1
        # verification of the consistent candidates and the discrepancy
        # delta, one record per candidate, read in one stacked transfer
        recs = [verify_and_gate(
            self.db, m, slot, cand_i, self.generator, cfg,
            draws=self.verify_draws.pop(0) if self.verify_draws else None)
            for cand_i in enough]
        allrec = to_host(torch.stack(recs))
        chosen = None
        for rec, cand_i in zip(allrec, enough):
            n_inl, okf = int(rec[16]), rec[17] > 0.5
            if self.verbose:
                print(f"  [lc] verify kf_id={kf_id} cand_slot={cand_i} "
                      f"inl={n_inl} ok={bool(okf)}", flush=True)
            if okf:
                chosen = (cand_i, rec[:16].reshape(4, 4), n_inl,
                          float(rec[18]), float(rec[19]))
                break
        if chosen is None:
            return m
        cand_i, T_qc, n_inl, dt, dr = chosen

        # discrepancy gate: correct only when the verified transform
        # disagrees with the current estimate (there is drift)
        if dt < cfg.loop.min_correction_t and dr < cfg.loop.min_correction_r:
            if self.verbose:
                print(f"  [lc] consistent revisit kf_id={kf_id} "
                      f"cand={cand_i} (dt={dt * 100:.1f}cm dr={dr:.3f}rad): "
                      "no correction needed", flush=True)
            self.consistent_revisits.append((slot, cand_i))
            self.last_loop_kf_id = kf_id
            self.consistent_groups = []
            return m

        pg = build_pose_graph(
            m, slot, cand_i, torch.from_numpy(T_qc.copy()).to(self.device),
            cfg, loop_inliers=n_inl)
        # matrix-free PCG at map scale; the dense solve up to 256 keyframes
        solve = (pose_graph.optimize_cg if m.kf_valid.shape[0] > 256
                 else pose_graph.optimize)
        pg = solve(pg, iters=cfg.loop.pose_graph_iters)
        m = correct_map(m, pg.T)
        if cfg.map.refresh_positions:
            # re-estimate landmark positions from all corrected KF poses
            m = ms.refresh_landmark_positions(m, cfg)
        if cfg.loop.post_gba_iters > 0:
            if self._sync_corrections_left is not None:
                # batched sync: one full-map pass per sync closes every
                # correction's seam together
                self._gba_pending = True
            else:
                m = self._post_loop_gba(m)
        self.last_loop_kf_id = kf_id
        self.consistent_groups = []
        self.loops.append((slot, cand_i))
        return m

    def _post_loop_gba(self, m: ms.MapState) -> ms.MapState:
        """Bounded full-map BA after loop correction(s), regularized (gn_cg)
        by the pose-graph-corrected chain so the joint re-solve cannot shear
        it to fit landmark depth noise."""
        cfg = self.cfg
        method = cfg.loop.post_gba_method
        if method == "sharded_gn_cg":
            # the config-5 path: the covisibility-placed distributed joint
            # GN-CG over the process's world, run by the live session.  No
            # chain regularizer, as in the reference: the pose-graph-
            # corrected poses are the linearization point and the steps
            # are few.  Strong relative damping (lam = 0.3): a post-loop
            # map is far from the reprojection optimum, where a lightly
            # damped GN step overshoots.
            mesh = self._gba_mesh(m.kf_T_cw.device)
            for _ in range(max(cfg.loop.post_gba_iters // 4, 1)):
                m, _ = partitioned_gn_cg_step(m, cfg.camera, cfg.ba, mesh,
                                              lam=0.3)
            return m
        chain = None
        if cfg.ba.chain_prior_weight > 0 and method == "gn_cg":
            chain = map_chain(m.kf_T_cw, m.kf_valid, m.kf_id,
                              cfg.ba.chain_prior_weight)
        m, _ = gba.global_ba(
            m, cfg.camera, cfg.ba, iters=cfg.loop.post_gba_iters,
            robust_iters=max(cfg.loop.post_gba_iters // 2, 1), method=method,
            chain=chain)
        return m

    def _gba_mesh(self, device: torch.device):
        """The mesh of the sharded post-loop GBA, made once: dp = the
        world, lm = 1 (the reference's mesh over the process's devices).
        Where no process group is initialized, a one-rank group on the
        map's device (NCCL for a card, gloo for the CPU): one device is a
        1x1 mesh."""
        if self._mesh is None:
            if not dist.is_initialized():
                launch.initialize_local(device)
            self._mesh = make_mesh(dp=dist.get_world_size(), lm=1,
                                   device=device)
        return self._mesh

    def relocalize(self, m: ms.MapState, frame, n_candidates: int = 3):
        """Re-acquire the pose of a lost frame (FrameData) against the
        keyframe database: the best `n_candidates` by L1 BoW score, down to
        `loop.min_score`, each verified in turn.  -> T_cw [4,4] float32
        ndarray, or None.  `verify_draws` feeds the RANSAC of each candidate
        tried, as it does for loop verification."""
        if self.vocab is None:
            return None
        words = bow.transform(self.vocab, frame.feat.desc)
        vec = bow.bow_vector(self.vocab, words, frame.feat.valid)
        scores = to_host(torch.where(self.db.kf_in_db & m.kf_valid,
                                     bow.l1_scores(vec, self.db.kf_bow), -1.0))
        for cand in np.argsort(-scores, kind="stable")[:n_candidates]:
            if scores[cand] < self.cfg.loop.min_score:
                break
            T_cw, _, ok = _reloc_verify(
                self.db, m, int(cand), frame, words, self.generator, self.cfg,
                draws=self.verify_draws.pop(0) if self.verify_draws else None)
            rec = to_host(torch.cat([T_cw.reshape(-1),
                                     ok.to(T_cw.dtype).reshape(1)]))
            if rec[16] > 0.5:
                self.relocalized.append(int(cand))
                return rec[:16].reshape(4, 4)
        return None

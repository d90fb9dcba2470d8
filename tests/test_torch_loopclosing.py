"""Parity of the port's loop closing (`aslam_tpu_torch/models/loopclosing.py`)
with the JAX package's, on the CPU, on the hand-built looped map of
tests/test_loopclosing.py (20 keyframes out along +x and back, drifted
estimates, small_config).

The map is made once by the port's `looped_map` (checked equal to the
reference's `build_looped_map`) and carried across.  One reference
`LoopClosing.process_keyframe` walk is shared by the module; a spy records
the RANSAC draws of each of its verifications, which the port replays
(`LoopClosing.verify_draws`), since it cannot reproduce JAX's random stream.

Integers and booleans (words, database, candidates, groups, matches, graph
edges, the loop list) must be equal; scores agree to 1e-6, verification
records and corrected poses to 1e-4, landmark positions to 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.models import loopclosing as jlc
from aslam_tpu_torch import convert
from aslam_tpu_torch.device import read_host
from aslam_tpu_torch.models import loopclosing as tlc
from aslam_tpu_torch.models import mapstate as tms
from aslam_tpu_torch.profile_slam import looped_map
from test_loopclosing import build_looped_map

N_KFS = 20
SNAP = 12          # the walk's state before this keyframe is kept


def _n_good(db, m, q, c, cfg):
    mm = jlc.bow_guided_match(
        db.kf_words[c], m.kf_desc[c], m.kf_kp_valid[c],
        db.kf_words[q], m.kf_desc[q], m.kf_kp_valid[q], cfg)
    tgt = jnp.maximum(mm.target_idx, 0)
    return int(jnp.sum(mm.valid & (m.kf_z[c] > 0) & (m.kf_z[q][tgt] > 0)))


@pytest.fixture(scope="module")
def walk():
    """-> dict: configs, the map on both sides, the reference LoopClosing
    after its walk, its final map, the verifications it made (q, c, draws,
    record) and its state before keyframe SNAP."""
    cfg, pcfg, mt, mj, T_true, T_est, drift = P.looped()
    verifs = []
    orig = jlc.verify_and_gate

    def spy(db, m, q, c, key, cfg_):
        r = cfg_.ransac
        draws = np.asarray(jax.random.randint(
            key, (r.n_hypotheses, r.sample_size), 0,
            max(_n_good(db, m, q, c, cfg_), 1)))
        rec = orig(db, m, q, c, key, cfg_)
        verifs.append((int(q), int(c), draws, np.asarray(rec),
                       P.tree_np(db), P.tree_np(m)))
        return rec

    lj = jlc.LoopClosing(cfg, train_after_kfs=4)
    jlc.verify_and_gate = spy
    try:
        m_run, snap = mj, None
        for k in range(N_KFS):
            if k == SNAP:
                snap = (m_run, P.tree_np(lj.db), lj.vocab,
                        [(set(g), c) for g, c in lj.consistent_groups],
                        lj.last_loop_kf_id, lj.trained_on_kfs, len(verifs))
            m_run = lj.process_keyframe(m_run, k, k)
    finally:
        jlc.verify_and_gate = orig
    return dict(cfg=cfg, pcfg=pcfg, mt=mt, mj=mj, T_true=T_true, T_est=T_est,
                drift=drift, lj=lj, m_final=m_run, verifs=verifs, snap=snap)


def _port_walk(w, m=None, start=0, lc=None, draws_from=0):
    lc = lc or tlc.LoopClosing(w["pcfg"], "cpu", train_after_kfs=4)
    lc.verify_draws = [P.t(v[2]) for v in w["verifs"][draws_from:]]
    m = w["mt"] if m is None else m
    for k in range(start, N_KFS):
        m = lc.process_keyframe(m, k, k)
    return lc, m


def test_looped_map_equals_reference_recipe(walk):
    rng = np.random.default_rng(1234)
    cfg, m_ref, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    assert n_kfs == N_KFS
    P.assert_maps_equal(walk["mt"], P.tree_np(m_ref), atol=1e-5)
    np.testing.assert_allclose(walk["T_est"], T_est, atol=1e-6)
    assert abs(walk["drift"] - drift) < 1e-6 and drift > 0.02
    # the observer index the port rebuilds is the reference's
    again = tms.rebuild_observer_index(walk["mt"]._replace(
        lm_obs_kf=torch.zeros_like(walk["mt"].lm_obs_kf)))
    P.assert_maps_equal(again, P.tree_np(m_ref), atol=1e-5)


def test_database_rebuild_equals_reference(walk):
    lj, mj, mt = walk["lj"], walk["mj"], walk["mt"]
    vt = convert.vocabulary(P.tree_np(lj.vocab), "cpu")
    db_j = jlc.add_keyframes_batch(jlc.init_database(walk["cfg"]), lj.vocab,
                                   mj.kf_desc, mj.kf_kp_valid, mj.kf_valid)
    db_t = tlc.add_keyframes_batch(vt, mt.kf_desc, mt.kf_kp_valid, mt.kf_valid)
    for name in ("kf_hist", "kf_words", "kf_in_db"):
        np.testing.assert_array_equal(P.n(getattr(db_t, name)),
                                      np.asarray(getattr(db_j, name)), name)
    np.testing.assert_allclose(P.n(db_t.kf_bow), np.asarray(db_j.kf_bow),
                               atol=1e-6)
    assert int(db_t.kf_in_db.sum()) == N_KFS
    # one keyframe at a time gives the same rows
    db_1 = tlc.init_database(walk["pcfg"], "cpu")
    for k in (0, 7):
        db_1 = tlc.add_keyframe(db_1, vt, mt.kf_desc[k], mt.kf_kp_valid[k], k)
        assert torch.equal(db_1.kf_words[k], db_t.kf_words[k])
        assert torch.equal(db_1.kf_hist[k], db_t.kf_hist[k])
        np.testing.assert_allclose(P.n(db_1.kf_bow[k]), P.n(db_t.kf_bow[k]),
                                   atol=1e-7)
    assert P.n(db_1.kf_in_db).nonzero()[0].tolist() == [0, 7]
    # carried across, the reference's database is the port's
    carried = convert.database_state(P.tree_np(db_j), "cpu")
    assert torch.equal(carried.kf_words, db_t.kf_words)


def test_query_candidates_equal_reference(walk):
    cfg, pcfg, lj, mj, mt = (walk[k] for k in ("cfg", "pcfg", "lj", "mj", "mt"))
    db_j = jlc.add_keyframes_batch(jlc.init_database(cfg), lj.vocab,
                                   mj.kf_desc, mj.kf_kp_valid, mj.kf_valid)
    db_t = convert.database_state(P.tree_np(db_j), "cpu")
    slots = [11, 13, 14, 16, 19, 5]
    found = 0
    outs = []
    for s in slots:
        gap_j = (jnp.int32(s) - mj.kf_id) >= cfg.loop.min_kf_gap
        c_j, s_j, g_j = jlc.query_candidates(db_j, mj, jnp.int32(s), gap_j, cfg)
        gap_t = (s - mt.kf_id) >= pcfg.loop.min_kf_gap
        c_t, s_t, g_t = tlc.query_candidates(db_t, mt, s, gap_t, pcfg)
        np.testing.assert_array_equal(P.n(c_t), np.asarray(c_j))
        np.testing.assert_array_equal(P.n(g_t), np.asarray(g_j))
        np.testing.assert_allclose(P.n(s_t), np.asarray(s_j), atol=1e-6)
        assert c_t.dtype == torch.int32
        found += int((c_t >= 0).sum())
        outs.append((c_t, s_t, g_t))
    assert found >= 3 and int((outs[-1][0] >= 0).sum()) == 0   # KF 5: no gap
    # the window query stacks the single ones, and packs for one read
    cb, sb, gb = tlc.batch_query(db_t, mt, slots, slots, pcfg)
    for i, (c, s, g) in enumerate(outs):
        assert torch.equal(cb[i], c) and torch.equal(sb[i], s)
        assert torch.equal(gb[i], g)
    flat = P.n(tlc._pack_query(cb, sb, gb, mt.kf_id))
    c_u, s_u, g_u, ids = tlc._unpack_query(flat, len(slots), cb.shape[1],
                                           mt.kf_valid.shape[0])
    np.testing.assert_array_equal(c_u, P.n(cb))
    np.testing.assert_array_equal(g_u, P.n(gb))
    np.testing.assert_array_equal(ids, P.n(mt.kf_id))


def test_verification_matches_reference_with_its_draws(walk):
    cfg, pcfg = walk["cfg"], walk["pcfg"]
    assert walk["verifs"], "the reference walk verified nothing"
    for q, c, draws, rec_j, db_np, m_np in walk["verifs"]:
        db_t = convert.database_state(db_np, "cpu")
        m_t = convert.map_state(m_np, "cpu")
        db_j, m_j = P.jtree(db_np), P.jtree(m_np)
        mm_j = jlc.bow_guided_match(
            db_j.kf_words[c], m_j.kf_desc[c], m_j.kf_kp_valid[c],
            db_j.kf_words[q], m_j.kf_desc[q], m_j.kf_kp_valid[q], cfg)
        mm_t = tlc.bow_guided_match(
            db_t.kf_words[c], m_t.kf_desc[c], m_t.kf_kp_valid[c],
            db_t.kf_words[q], m_t.kf_desc[q], m_t.kf_kp_valid[q], pcfg)
        np.testing.assert_array_equal(P.n(mm_t.target_idx),
                                      np.asarray(mm_j.target_idx))
        np.testing.assert_array_equal(P.n(mm_t.valid), np.asarray(mm_j.valid))
        np.testing.assert_array_equal(P.n(mm_t.distance),
                                      np.asarray(mm_j.distance))
        assert int(mm_t.valid.sum()) >= 20
        rec_t = P.n(tlc.verify_and_gate(db_t, m_t, q, c, None, pcfg,
                                        draws=P.t(draws)))
        assert rec_t.shape == (20,)
        np.testing.assert_array_equal(rec_t[16:18], rec_j[16:18])  # n_inl, ok
        np.testing.assert_allclose(rec_t, rec_j, atol=1e-4)
        # the port's own draws verify the same loop
        own = P.n(tlc.verify_and_gate(
            db_t, m_t, q, c, torch.Generator().manual_seed(1), pcfg))
        assert own[17] == rec_j[17]
        if own[17]:
            np.testing.assert_allclose(own[:16], rec_j[:16], atol=5e-3)


def test_correct_map_matches_reference(walk):
    mj, mt = walk["mj"], walk["mt"]
    rng = np.random.default_rng(5)
    T_new = P.n(mt.kf_T_cw).copy()
    T_new[:N_KFS, :3, 3] += rng.normal(0, 0.05, (N_KFS, 3)).astype(np.float32)
    out_j = jlc.correct_map(mj, jnp.asarray(T_new))
    out_t = tlc.correct_map(mt, P.t(T_new))
    P.assert_maps_equal(out_t, P.tree_np(out_j), atol=1e-5)
    moved = np.abs(P.n(out_t.lm_pos) - P.n(mt.lm_pos)).max(1) > 1e-3
    assert moved.sum() > 100 and not moved[~P.n(mt.lm_valid)].any()


def test_walk_closes_the_reference_loop_and_cuts_the_drift(walk):
    lj, T_true, T_est = walk["lj"], walk["T_true"], walk["T_est"]
    reads = read_host.count
    lt, m_t = _port_walk(walk)
    assert lt.loops == [(int(q), int(c)) for q, c in lj.loops] and lt.loops
    assert lt.consistent_revisits == [
        (int(q), int(c)) for q, c in lj.consistent_revisits]
    assert lt.last_loop_kf_id == lj.last_loop_kf_id
    assert not lt.verify_draws                        # every draw was used
    q, c = lt.loops[-1]
    assert q >= N_KFS // 2 and c < N_KFS // 2
    assert abs(float(T_true[q][0, 3]) - float(T_true[c][0, 3])) < 1.6
    np.testing.assert_allclose(P.n(m_t.kf_T_cw), np.asarray(walk["m_final"].kf_T_cw),
                               atol=1e-4)
    np.testing.assert_allclose(P.n(m_t.lm_pos), np.asarray(walk["m_final"].lm_pos),
                               atol=1e-3)
    err_before = np.linalg.norm(T_est[q][:3, 3] - T_true[q][:3, 3])
    err_after = np.linalg.norm(P.n(m_t.kf_T_cw)[q][:3, 3] - T_true[q][:3, 3])
    assert err_after < 0.8 * err_before, (err_before, err_after)
    # the vocabulary trained in the run is the reference's
    for a, b in zip(lt.vocab.level_cents, lj.vocab.level_cents):
        np.testing.assert_array_equal(P.n(a), P.words(b))
    # every read of the walk is counted: n_live until trained (4) and per
    # refresh check (16), the training sample (1), one packed query per
    # keyframe past the gap gate, one stacked record per verification
    assert read_host.count - reads >= len(walk["verifs"]) + 1


def test_walk_continues_from_a_carried_reference_state(walk):
    m_snap, db, vocab, groups, last_loop, trained_on, n_ver = walk["snap"]
    lj = walk["lj"]

    class Snap:        # the reference LoopClosing as it stood before SNAP
        pass

    s = Snap()
    s.db, s.vocab, s.consistent_groups = db, P.tree_np(vocab), groups
    s.last_loop_kf_id, s.trained_on_kfs = last_loop, trained_on
    s.loops, s.consistent_revisits = [], []
    lt = tlc.LoopClosing(walk["pcfg"], "cpu", train_after_kfs=4)
    convert.loop_closing_state(s, lt)
    assert lt.vocab.n_words == 1000 and lt.trained_on_kfs == trained_on
    assert lt.consistent_groups == groups
    lt, m_t = _port_walk(walk, m=P.port_map(m_snap), start=SNAP, lc=lt,
                         draws_from=n_ver)
    assert lt.loops == [(int(q), int(c)) for q, c in lj.loops]
    np.testing.assert_allclose(P.n(m_t.kf_T_cw),
                               np.asarray(walk["m_final"].kf_T_cw), atol=1e-4)


def test_no_loop_without_revisit_and_gate_blocks_a_transient_alias(walk):
    lt = tlc.LoopClosing(walk["pcfg"], "cpu", train_after_kfs=4)
    verified = []
    orig = tlc.verify_and_gate
    tlc.verify_and_gate = lambda *a, **kw: verified.append(1) or orig(*a, **kw)
    try:
        m = walk["mt"]
        for k in range(N_KFS // 2 + 2):                 # the outbound leg
            m = lt.process_keyframe(m, k, k)
        assert lt.loops == [] and not verified
        # exactly two keyframes of the return leg: a streak of two stays
        # under consistency_th = 3, so nothing may reach verification
        assert walk["pcfg"].loop.consistency_th == 3
        for k in (N_KFS - 2, N_KFS - 1):
            m = lt.process_keyframe(m, k, k)
    finally:
        tlc.verify_and_gate = orig
    assert lt.loops == [] and not verified
    assert [c for _, c in lt.consistent_groups] and \
        max(c for _, c in lt.consistent_groups) <= 2


def test_aliased_place_is_rejected_by_geometry(walk):
    """Identical descriptors on shuffled keypoints: detection fires and the
    streak builds, the 3D-3D RANSAC refuses."""
    mt = walk["mt"]
    rng = np.random.default_rng(9)
    kf_desc = P.n(mt.kf_desc).copy()
    for k in range(N_KFS // 2, N_KFS):
        idx = np.nonzero(P.n(mt.kf_kp_valid[k]))[0]
        kf_desc[k][idx] = kf_desc[k][idx][rng.permutation(len(idx))]
    lt = tlc.LoopClosing(walk["pcfg"], "cpu", train_after_kfs=4)
    m = mt._replace(kf_desc=torch.from_numpy(kf_desc))
    for k in range(N_KFS):
        m = lt.process_keyframe(m, k, k)
    assert lt.loops == []
    assert torch.equal(m.kf_T_cw, mt.kf_T_cw)


def test_batched_sync_closes_the_loop_with_counted_reads(walk):
    """`process_keyframes_batch` over windows of four fresh keyframes, as the
    device engine's sync cadence feeds it."""
    T_true, T_est = walk["T_true"], walk["T_est"]
    lt = tlc.LoopClosing(walk["pcfg"], "cpu", train_after_kfs=4)
    K = walk["mt"].kf_valid.shape[0]
    m = walk["mt"]
    per_sync = []
    for lo in range(0, N_KFS, 4):
        ids = list(range(lo, lo + 4))
        # the map as it stood when the window's last keyframe came in
        m_k = m._replace(kf_valid=m.kf_valid & (torch.arange(K) < lo + 4))
        reads = read_host.count
        out = lt.process_keyframes_batch(m_k, ids, ids, n_live=lo + 4)
        per_sync.append(read_host.count - reads)
        m = out._replace(kf_valid=m.kf_valid)
    assert len(lt.loops) >= 1
    q, c = lt.loops[-1]
    assert q >= N_KFS // 2 and c < N_KFS // 2
    err_before = np.linalg.norm(T_est[q][:3, 3] - T_true[q][:3, 3])
    err_after = np.linalg.norm(P.n(m.kf_T_cw)[q][:3, 3] - T_true[q][:3, 3])
    assert err_after < 0.8 * err_before
    # first sync: the training sample and the packed query; later syncs:
    # one packed query, plus one stacked record per keyframe that verifies
    # (the fourth also retrains: 16 keyframes = refresh_factor x 4); after
    # the loop every fresh keyframe is inside min_kf_gap: nothing to read
    assert per_sync[:3] == [2, 1, 1] and per_sync[4] == 0, per_sync
    assert 3 <= per_sync[3] <= 2 + 4, per_sync
    assert int(lt.db.kf_in_db.sum()) == N_KFS
    assert lt._sync_corrections_left is None and not lt._gba_pending


@pytest.mark.parametrize("what", ["optimize_cg", "sharded_gn_cg"])
def test_unported_paths_raise_an_error_that_names_them(what):
    """Both paths, once refused, are ported: the walk closes its loop
    through `optimize_cg` above 256 keyframes, and through the sharded
    post-loop GBA (`sharded_gn_cg`, on a one-rank gloo group it creates,
    destroyed here after), whose map is the reference's to 2e-3.  Without
    a chain regularizer the sharded GBA keeps less of the pose graph's
    correction (6.2 -> 5.2 cm at the closing keyframe here, in the JAX
    package as in the port), so only `optimize_cg` is held to a 20% cut."""
    import torch.distributed as dist

    pcfg = P.port_config(walk_cfg())
    if what == "optimize_cg":      # taken above 256 keyframes
        pcfg = pcfg.replace(map=dataclasses.replace(pcfg.map, max_keyframes=288))
    else:
        pcfg = pcfg.replace(loop=dataclasses.replace(
            pcfg.loop, post_gba_method="sharded_gn_cg"))
    m, T_true, T_est, _ = looped_map(pcfg, "cpu", seed=1234)
    lt = tlc.LoopClosing(pcfg, "cpu", train_after_kfs=4)
    try:
        for k in range(N_KFS):
            m = lt.process_keyframe(m, k, k)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert (lt._mesh is not None) == (what == "sharded_gn_cg")
    (q, c), = lt.loops
    assert q >= N_KFS // 2 > c and torch.isfinite(m.kf_T_cw).all()
    before = np.linalg.norm(T_est[q][:3, 3] - T_true[q][:3, 3])
    after = np.linalg.norm(P.n(m.kf_T_cw[q])[:3, 3] - T_true[q][:3, 3])
    if what == "optimize_cg":
        assert after < 0.8 * before, (before, after)
        return
    assert after < before, (before, after)
    cfg = dataclasses.replace(walk_cfg(), loop=dataclasses.replace(
        walk_cfg().loop, post_gba_method="sharded_gn_cg"))
    mj = P.looped(seed=1234)[3]
    lj = jlc.LoopClosing(cfg, train_after_kfs=4)
    for k in range(N_KFS):
        mj = lj.process_keyframe(mj, k, k)
    assert lj.loops == lt.loops
    np.testing.assert_allclose(P.n(m.kf_T_cw), np.asarray(mj.kf_T_cw),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(P.n(m.lm_pos), np.asarray(mj.lm_pos),
                               rtol=0, atol=2e-3)


def walk_cfg():
    from aslam_tpu.config import small_config

    return small_config()

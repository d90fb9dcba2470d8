"""Parity of the port's map state (`aslam_tpu_torch/models/mapstate.py`) with
the JAX package's, on a map the reference builds over the synthetic walk of
tests/test_device_slam.py and carried across with `convert.map_state`.
Integer and boolean outputs must be equal; float outputs agree to 1e-5
(the port sums its scatter-adds in another order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.models import frame as jframe
from aslam_tpu.models import mapstate as jms
from aslam_tpu_torch import convert
from aslam_tpu_torch.models import mapstate as tms


@pytest.fixture(scope="module")
def walk():
    cfg = small_config()
    imgs, depths, _ = P.walk(10)
    dev, _ = P.jax_walk_states(cfg, imgs, depths)
    m = P.tree_np(dev.state.m)
    assert int(m.kf_valid.sum()) >= 3
    return cfg, m, imgs, depths


def _ids(m, rng, n=200):
    """Landmark ids to query: live, dead and padding entries."""
    L = m.lm_pos.shape[0]
    ids = rng.integers(0, L, n).astype(np.int32)
    live = np.nonzero(m.lm_valid)[0]
    ids[: n // 2] = rng.choice(live, n // 2)
    valid = rng.random(n) > 0.1
    ids[~valid & (rng.random(n) > 0.5)] = -1
    return ids, valid


def test_init_map_matches_reference():
    cfg = small_config()
    P.assert_maps_equal(tms.init_map(P.port_config(cfg), "cpu"),
                        P.tree_np(jms.init_map(cfg)), atol=0)


def test_convert_map_state_round_trip(walk):
    _, m, _, _ = walk
    mt = P.port_map(m)
    assert mt.kf_desc.dtype == torch.int32 and mt.lm_desc.dtype == torch.int32
    P.assert_maps_equal(mt, m, atol=0)


def test_observer_queries_match_reference(walk):
    cfg, m, _, _ = walk
    mt = P.port_map(m)
    rng = np.random.default_rng(0)
    ids, valid = _ids(m, rng)
    for a, b in zip(tms.observer_entries(mt, P.t(ids), P.t(valid)),
                    jms.observer_entries(P.jtree(m), jnp.asarray(ids), jnp.asarray(valid))):
        np.testing.assert_array_equal(P.n(a), np.asarray(b))
    np.testing.assert_array_equal(
        P.n(tms.kf_votes_of_ids(mt, P.t(ids), P.t(valid))),
        np.asarray(jms.kf_votes_of_ids(P.jtree(m), jnp.asarray(ids), jnp.asarray(valid))))
    K = m.kf_valid.shape[0]
    slots = np.arange(K, dtype=np.int32)             # live and empty slots
    rows = P.n(tms.covis_rows_fast(mt, P.t(slots)))
    np.testing.assert_array_equal(rows, np.asarray(
        jms.covis_rows_fast(P.jtree(m), jnp.asarray(slots))))
    assert rows.max() > 0
    for s in (0, int(np.nonzero(m.kf_valid)[0][-1])):
        np.testing.assert_array_equal(P.n(tms.covis_row_fast(mt, s)),
                                      rows[s])
    slot_valid = rng.random(K) > 0.3
    np.testing.assert_array_equal(
        P.n(tms.landmark_mask_of_slots(mt, P.t(slots), P.t(slot_valid))),
        np.asarray(jms.landmark_mask_of_slots(P.jtree(m), jnp.asarray(slots),
                                              jnp.asarray(slot_valid))))


def test_append_observations_matches_reference(walk):
    _, m, _, _ = walk
    rng = np.random.default_rng(1)
    L = m.lm_pos.shape[0]
    ids = rng.permutation(L)[:300].astype(np.int32)      # no duplicates
    feat = rng.integers(0, 256, 300).astype(np.int32)
    mask = rng.random(300) > 0.2
    out = tms.append_observations(P.port_map(m), P.t(ids), P.t(feat), 5,
                                  P.t(mask))
    ref = jms.append_observations(P.jtree(m), jnp.asarray(ids), jnp.asarray(feat),
                                  jnp.int32(5), jnp.asarray(mask))
    P.assert_maps_equal(out, P.tree_np(ref), atol=0)


@pytest.mark.parametrize("nearly_full", [False, True])
def test_insert_keyframe_and_create_landmarks_match_reference(walk,
                                                              nearly_full):
    """A reference frame of the walk, inserted into the first free slot of
    the walk's map with half of its features bound; with `nearly_full` only
    a few landmark rows are free, so allocation runs out of capacity."""
    cfg, m, imgs, depths = walk
    if nearly_full:
        lm_valid = np.ones_like(m.lm_valid)
        lm_valid[np.arange(7, lm_valid.shape[0], 400)] = False
        m = m._replace(lm_valid=lm_valid)
    grid = jnp.full((3, 3), 20.0, jnp.float32)
    f, _ = jframe._make_frame_impl(jnp.asarray(imgs[6]), jnp.asarray(depths[6]),
                                   grid, cfg, *imgs[6].shape)
    f = jframe.with_pose(f, jnp.asarray(m.kf_T_cw[0]))
    M = cfg.extractor.max_keypoints
    rng = np.random.default_rng(2)
    live = np.nonzero(m.lm_valid)[0]
    assoc = np.where(rng.random(M) > 0.5, rng.choice(live, M), -1)
    _, first = np.unique(assoc, return_index=True)   # one feature per landmark
    keep = np.zeros(M, bool)
    keep[first] = True
    assoc = np.where(keep, assoc, -1).astype(np.int32)
    slot, kf_id = int(np.argmin(m.kf_valid)), 17
    pcfg = P.port_config(cfg)

    mj = jms.insert_keyframe(jax_map := P.tree_np(m), f, jnp.asarray(assoc),
                             jnp.int32(slot), jnp.int32(kf_id))
    mt = tms.insert_keyframe(P.port_map(jax_map), convert.frame_data(
        P.tree_np(f), "cpu"), P.t(assoc), slot, kf_id)
    P.assert_maps_equal(mt, P.tree_np(mj), atol=0)

    for max_new in (cfg.tracking.max_vo_points, M):
        mj2, aj, nj = jms.create_landmarks(
            P.tree_np(mj), f, jnp.asarray(assoc), jnp.int32(slot),
            jnp.int32(kf_id), max_new=max_new,
            th_depth=float(cfg.camera.th_depth))
        mt2, at, nt = tms.create_landmarks(
            mt, convert.frame_data(P.tree_np(f), "cpu"), P.t(assoc), slot,
            kf_id, max_new=max_new, th_depth=float(pcfg.camera.th_depth))
        assert int(nt) == int(nj) > 0
        np.testing.assert_array_equal(P.n(at), np.asarray(aj))
        P.assert_maps_equal(mt2, P.tree_np(mj2))
    if nearly_full:
        assert int(nt) == int((~m.lm_valid).sum())


@pytest.mark.parametrize("case", ["walk", "unseen"])
def test_landmark_culling_matches_reference(walk, case):
    """On the walk's map, and with every landmark's found count zeroed so
    the found-ratio rule kills every recently seen one.  Like the reference
    (ADVICE r5, `mapstate.py:502`), bindings that the observer ring no
    longer lists stay in kf_lm after the cull; the equality below holds the
    port to that."""
    cfg, m, _, _ = walk
    if case == "unseen":
        m = m._replace(lm_found=np.zeros_like(m.lm_found))
    kf_id = int(m.kf_id.max())
    out = tms.landmark_culling(P.port_map(m), kf_id, P.port_config(cfg))
    ref = jms.landmark_culling(P.tree_np(m), jnp.int32(kf_id), cfg)
    P.assert_maps_equal(out, P.tree_np(ref), atol=0)
    assert int(P.n(out.lm_valid).sum()) < int(m.lm_valid.sum())


def test_landmark_culling_keeps_stale_bindings_like_reference(walk):
    """The reference's known fault, reproduced: a landmark observed by more
    keyframes than its observer ring holds is culled, and the bindings the
    ring overwrote survive in kf_lm on both sides."""
    cfg, m, _, _ = walk
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, max_obs_per_lm=2))
    K, M = m.kf_lm.shape
    kfs = np.nonzero(m.kf_valid)[0]
    lm = int(np.nonzero(m.lm_valid)[0][0])
    kf_lm = m.kf_lm.copy()
    kf_lm[kfs, 3] = lm                              # lm seen by every KF
    kp_valid = m.kf_kp_valid.copy()
    kp_valid[kfs, 3] = True
    okf = np.full((m.lm_pos.shape[0], 2), -1, np.int32)
    ofe = np.zeros_like(okf)
    okf[lm], ofe[lm] = kfs[-2:], 3                  # the ring kept the last 2
    m = m._replace(kf_lm=kf_lm, kf_kp_valid=kp_valid, lm_obs_kf=okf,
                   lm_obs_feat=ofe, lm_obs_ptr=np.where(
                       np.arange(len(m.lm_valid)) == lm, len(kfs), 0
                   ).astype(np.int32),
                   lm_found=np.zeros_like(m.lm_found),
                   lm_visible=np.ones_like(m.lm_visible))
    kf_id = int(m.kf_id.max())
    out = tms.landmark_culling(P.port_map(m), kf_id, P.port_config(cfg))
    ref = P.tree_np(jms.landmark_culling(P.tree_np(m), jnp.int32(kf_id), cfg))
    P.assert_maps_equal(out, ref, atol=0)
    assert not ref.lm_valid[lm]
    stale = ref.kf_lm[kfs[:-2], 3]
    assert (stale == lm).all() and (ref.kf_lm[kfs[-2:], 3] == -1).all()


@pytest.mark.parametrize("redundancy", [0.95, 0.0])
def test_keyframe_culling_matches_reference(walk, redundancy):
    """Every live slot as the current KF; with redundancy 0 any covisible
    candidate with close landmarks is a victim, so the cull path runs."""
    cfg, m, _, _ = walk
    cfg = cfg.replace(map=dataclasses.replace(
        cfg.map, kf_cull_redundancy=redundancy))
    pcfg = P.port_config(cfg)
    culled = 0
    for slot in np.nonzero(m.kf_valid)[0]:
        mt, it = tms.keyframe_culling(P.port_map(m), int(slot), pcfg)
        mj, ij = jms.keyframe_culling(P.tree_np(m), jnp.int32(slot), cfg)
        P.assert_maps_equal(mt, P.tree_np(mj), atol=0)
        assert bool(it.culled) == bool(ij.culled)
        assert int(it.kf_id) == int(ij.kf_id)
        assert int(it.parent_kf_id) == int(ij.parent_kf_id)
        np.testing.assert_allclose(P.n(it.T_cp), np.asarray(ij.T_cp),
                                   atol=1e-5)
        culled += bool(ij.culled)
    assert culled > 0 if redundancy == 0.0 else True


def test_observer_entries_of_reused_slot_count_twice_like_reference(walk):
    """The reference's known fault (ADVICE r5, `mapstate.py:166`): after a
    keyframe slot is culled and reused, an old observer entry that names
    the slot and the same (feature, landmark) binding counts again.  The
    port matches the reference, double count included."""
    cfg, m, _, _ = walk
    slot = int(np.nonzero(m.kf_valid)[0][-1])
    feats = np.nonzero((m.kf_lm[slot] >= 0) & m.kf_kp_valid[slot])[0][:20]
    ids = m.kf_lm[slot, feats]
    # re-append the same bindings, as a reused slot with equal rows would
    mj = jms.append_observations(P.jtree(m), jnp.asarray(ids),
                                 jnp.asarray(feats.astype(np.int32)),
                                 jnp.int32(slot), jnp.ones(len(ids), bool))
    mt = tms.append_observations(P.port_map(m), P.t(ids),
                                 P.t(feats.astype(np.int32)), slot,
                                 torch.ones(len(ids), dtype=torch.bool))
    ok = np.ones(len(ids), bool)
    vj = np.asarray(jms.kf_votes_of_ids(mj, jnp.asarray(ids), jnp.asarray(ok)))
    vt = P.n(tms.kf_votes_of_ids(mt, P.t(ids), P.t(ok)))
    np.testing.assert_array_equal(vt, vj)
    assert vj[slot] > len(ids)                      # counted twice


def test_refresh_landmark_positions_match_reference(walk):
    cfg, m, _, _ = walk
    pcfg = P.port_config(cfg)
    # move the keyframes so the refreshed positions differ from the stored
    T = m.kf_T_cw.copy()
    T[:, :3, 3] += np.float32(0.01)
    m = m._replace(kf_T_cw=T)
    out = tms.refresh_landmark_positions(P.port_map(m), pcfg)
    ref = P.tree_np(jms.refresh_landmark_positions(P.tree_np(m), cfg))
    P.assert_maps_equal(out, ref)
    assert np.abs(ref.lm_pos - m.lm_pos).max() > 1e-3

    slot = int(np.nonzero(m.kf_valid)[0][-1])
    row = m.kf_lm[slot]
    ids, valid = np.maximum(row, 0), (row >= 0) & m.kf_kp_valid[slot]
    out = tms.refresh_landmark_positions_ids(P.port_map(m), P.t(ids),
                                             P.t(valid), pcfg)
    ref = P.tree_np(jms.refresh_landmark_positions_ids(
        P.tree_np(m), jnp.asarray(ids), jnp.asarray(valid), cfg))
    P.assert_maps_equal(out, ref)


def test_refresh_landmark_descriptors_ids_matches_reference(walk):
    _, m, _, _ = walk
    rng = np.random.default_rng(3)
    ids, valid = _ids(m, rng, 256)
    out = tms.refresh_landmark_descriptors_ids(P.port_map(m), P.t(ids),
                                               P.t(valid))
    ref = jms.refresh_landmark_descriptors_ids(P.tree_np(m), jnp.asarray(ids),
                                               jnp.asarray(valid))
    P.assert_maps_equal(out, P.tree_np(ref), atol=0)


@pytest.mark.parametrize("chunk", [256, 4, 3])
def test_covisibility_matches_reference(walk, chunk):
    """The full [K,K] matrix, as one product and blocked (a chunk that does
    and one that does not divide K): equal integers, and equal to a count
    over the bindings in numpy."""
    _, m, _, _ = walk
    mt = P.port_map(m)
    K = m.kf_valid.shape[0]
    ref = np.asarray(jms.covisibility(P.jtree(m), chunk=256))
    out = tms.covisibility(mt, chunk=chunk)
    assert out.dtype == torch.int32 and out.shape == (K, K)
    np.testing.assert_array_equal(P.n(out), ref)
    assert ref.max() >= 15 and (np.diag(ref) == 0).all()
    sets = [set(m.kf_lm[k][(m.kf_lm[k] >= 0) & m.kf_kp_valid[k]
                           & m.lm_valid[np.maximum(m.kf_lm[k], 0)]])
            if m.kf_valid[k] else set() for k in range(K)]
    brute = np.array([[len(sets[i] & sets[j]) if i != j else 0
                       for j in range(K)] for i in range(K)])
    np.testing.assert_array_equal(ref, brute)
    if chunk != 256:      # the reference's own blocked path
        np.testing.assert_array_equal(
            np.asarray(jms.covisibility(P.jtree(m), chunk=8)), ref)


def test_rebuild_observer_index_matches_reference(walk):
    """From kf_lm alone, on a map whose index was wiped: the reference's
    rebuild on the same map, and every bound landmark found again (a
    landmark bound twice in one keyframe keeps one entry, as there)."""
    _, m, _, _ = walk
    wiped = m._replace(lm_obs_kf=np.full_like(m.lm_obs_kf, -1),
                       lm_obs_feat=np.zeros_like(m.lm_obs_feat),
                       lm_obs_ptr=np.zeros_like(m.lm_obs_ptr))
    ref = P.tree_np(jms.rebuild_observer_index(P.jtree(wiped)))
    out = tms.rebuild_observer_index(P.port_map(wiped))
    P.assert_maps_equal(out, ref, atol=0)
    bound = (m.kf_lm >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    ids = np.unique(m.kf_lm[bound])
    _, _, ok = tms.observer_entries(out, torch.from_numpy(ids),
                                    torch.ones(len(ids), dtype=torch.bool))
    counts = np.bincount(m.kf_lm[bound], minlength=ids.max() + 1)[ids]
    n_ok = P.n(ok.sum(1))
    assert (n_ok >= 1).all() and (n_ok <= counts).all()
    assert (n_ok == counts).mean() > 0.8


@pytest.mark.parametrize("name", ["observation_counts",
                                  "observation_counts_weighted",
                                  "landmark_mask_of_kfs", "kf_votes",
                                  "covis_row", "covis_rows"])
def test_derived_queries_match_reference(walk, name):
    """The O(K*M) queries over the observation table that only the host
    engine and the exports reach: integer outputs, equal."""
    _, m, _, _ = walk
    mt, mj = P.port_map(m), P.jtree(m)
    rng = np.random.default_rng(7)
    K, L = m.kf_valid.shape[0], m.lm_pos.shape[0]
    live = np.nonzero(m.kf_valid)[0]
    if name in ("observation_counts", "observation_counts_weighted"):
        out, ref = getattr(tms, name)(mt), getattr(jms, name)(mj)
        assert out.dtype == torch.int32 and P.n(out).max() >= 2
    elif name == "landmark_mask_of_kfs":
        mask = rng.random(K) > 0.4
        mask[live[0]] = True
        out = tms.landmark_mask_of_kfs(mt, P.t(mask))
        ref = jms.landmark_mask_of_kfs(mj, jnp.asarray(mask))
        assert 0 < int(out.sum()) <= int(m.lm_valid.sum())
    elif name == "kf_votes":
        mask = rng.random(L) > 0.5
        out = tms.kf_votes(mt, P.t(mask))
        ref = jms.kf_votes(mj, jnp.asarray(mask))
        assert int(out.sum()) > 0
    elif name == "covis_row":
        for s in (int(live[0]), int(live[-1]), K - 1):
            np.testing.assert_array_equal(
                P.n(tms.covis_row(mt, s)),
                np.asarray(jms.covis_row(mj, jnp.int32(s))))
        # where no observer ring has overflowed, the index gives the same
        np.testing.assert_array_equal(P.n(tms.covis_row(mt, int(live[-1]))),
                                      P.n(tms.covis_row_fast(mt, int(live[-1]))))
        return
    else:
        slots = [int(s) for s in live[:3]] + [K - 1]
        out = tms.covis_rows(mt, slots)
        ref = jms.covis_rows(mj, jnp.asarray(slots, jnp.int32))
        assert out.shape == (4, K)
    np.testing.assert_array_equal(P.n(out), np.asarray(ref))


@pytest.mark.parametrize("max_obs", [8, 2])
def test_refresh_landmark_descriptors_matches_reference(walk, max_obs):
    """The whole-table medoid refresh for a landmark mask."""
    _, m, _, _ = walk
    rng = np.random.default_rng(5)
    mask = rng.random(m.lm_pos.shape[0]) > 0.3
    out = tms.refresh_landmark_descriptors(P.port_map(m), P.t(mask),
                                           max_obs=max_obs)
    ref = jms.refresh_landmark_descriptors(P.jtree(m), jnp.asarray(mask),
                                           max_obs=max_obs)
    P.assert_maps_equal(out, P.tree_np(ref), atol=0)
    # untouched outside the mask
    keep = ~mask
    np.testing.assert_array_equal(P.n(out.lm_desc)[keep],
                                  P.words(m.lm_desc)[keep])

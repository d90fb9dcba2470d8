"""Checkpoints of the port: `utils/checkpoint.py` (the host engine's map
checkpoint, in the JAX package's npz layout) and `DeviceSlam.save` /
`resume` (the whole session).

  * `save_system` -> `load_system` round trip: every map field equal, the
    counters, vocabulary and database back, the state NEW_SEQUENCE;
  * a checkpoint written by the JAX package's `save_system` (6 frames of
    the walk of tests/test_resume.py, loop closing on) read by the port's
    `load_system`: fields equal to the reference's map (uint32 descriptor
    words as int32), and the port's engine tracks the next 4 frames against
    it (> 20 landmarks tracked);
  * `DeviceSlam.save` after 5 frames, `resume` in a fresh object, 5 more:
    equal to the uninterrupted 10-frame run to 1e-5 (poses, rebuilt
    trajectory, keyframe ids), loop closing's database included;
  * a session of other capacities is refused by its fingerprint;
  * three faults of the reference's checkpoint code are fixed here: the
    culled registry is saved without inline mapping
    (`aslam_tpu/models/device_slam.py:497` drops it), `loops` and the
    consistency state come back on resume (`:543` restores neither), and a
    checkpoint without an observer index is rebuilt at
    `cfg.map.max_obs_per_lm` entries (`aslam_tpu/utils/checkpoint.py:44`
    hardcodes 16).
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.models.system import SlamSystem as JSlamSystem
from aslam_tpu.utils import checkpoint as jckpt
from aslam_tpu.utils import synthetic
from aslam_tpu_torch.models import mapstate as tms
from aslam_tpu_torch.models.device_slam import DeviceSlam
from aslam_tpu_torch.models.system import SlamSystem
from aslam_tpu_torch.utils import checkpoint as tckpt

N = 10


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX SlamSystem over 6 frames, saved by the JAX `save_system`."""
    cfg = small_config().replace(use_loop_closing=True)
    rng = np.random.default_rng(21)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(N, step_t=0.04, rng=rng)
    tex = synthetic.point_textures(500, seed=22)
    imgs = np.stack([synthetic.render_intensity_image(cfg.camera, T, pts, tex)
                     for T in poses])
    deps = np.stack([synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
                     for T in poses])
    slam = JSlamSystem(cfg)
    for i in range(6):
        slam.process(imgs[i], deps[i], t=i * 0.033)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ckpt.npz")
    jckpt.save_system(path, slam)
    return cfg, P.port_config(cfg), imgs, deps, slam, path


def test_jax_checkpoint_loads_into_the_port_and_tracking_continues(ref):
    cfg, pcfg, imgs, deps, slam_j, path = ref
    slam = SlamSystem(pcfg, "cpu")
    tckpt.load_system(path, slam)
    tj, tt = slam_j.tracking, slam.tracking
    P.assert_maps_equal(tt.map, P.tree_np(tj.map), atol=0)
    assert tt.map.kf_desc.dtype == torch.int32
    assert (tt.n_kfs, tt.next_lm, tt.kf_counter) == \
        (tj.n_kfs, tj.next_lm, tj.kf_counter)
    assert tt.state == "NEW_SEQUENCE" and tt.last_kf_id == tj.kf_counter - 1
    lj, lt = slam_j.loop_closing, slam.loop_closing
    assert (lt.vocab is None) == (lj.vocab is None)
    if lj.vocab is not None:
        for a, b in zip(lt.vocab.level_cents, lj.vocab.level_cents):
            np.testing.assert_array_equal(P.words(a), P.words(b))
        np.testing.assert_array_equal(P.n(lt.db.kf_in_db),
                                      np.asarray(lj.db.kf_in_db))
        assert lt.trained_on_kfs == lj.trained_on_kfs
    for i in range(6, N):
        T, info = slam.process(imgs[i], deps[i], t=i * 0.033)
        assert np.isfinite(T).all()
    assert tt.stats[0] == {"new_sequence": True}
    assert tt.n_kfs >= tj.n_kfs
    assert max(s.get("n_tracked", 0) for s in tt.stats[1:]) > 20


def test_save_system_round_trip(ref, tmp_path):
    cfg, pcfg, imgs, deps, _, _ = ref
    slam = SlamSystem(pcfg, "cpu")
    for i in range(6):
        slam.process(imgs[i], deps[i], t=i * 0.033)
    path = str(tmp_path / "ck.npz")
    tckpt.save_system(path, slam)
    back = SlamSystem(pcfg, "cpu")
    tckpt.load_system(path, back)
    for a, b in zip(back.map, slam.map):
        assert torch.equal(a, b)
    tb, ts = back.tracking, slam.tracking
    assert (tb.n_kfs, tb.next_lm, tb.kf_counter) == \
        (ts.n_kfs, ts.next_lm, ts.kf_counter)
    assert tb.state == "NEW_SEQUENCE"
    assert torch.equal(tb.last_kf_T, ts.map.kf_T_cw[ts.new_kf_slots[-1]])
    if slam.loop_closing.vocab is not None:
        assert torch.equal(back.loop_closing.db.kf_bow, slam.loop_closing.db.kf_bow)
        assert torch.equal(back.loop_closing.vocab.idf, slam.loop_closing.vocab.idf)
    # the JAX package reads what the port wrote
    m_j, counters = jckpt.load_map(path)
    P.assert_maps_equal(slam.map, P.tree_np(m_j), atol=0)
    assert counters["kf_counter"] == ts.kf_counter
    # a map of other capacities is refused
    other = SlamSystem(pcfg.replace(map=dataclasses.replace(
        pcfg.map, max_keyframes=16)), "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.load_system(path, other)


def test_checkpoint_without_observer_index_is_rebuilt_at_the_configured_size(
        ref, tmp_path):
    """Fault of the reference fixed here: `checkpoint.py:44` rebuilds the
    index with 16 entries per landmark whatever the configuration says."""
    cfg, pcfg, *_ , slam_j, _ = ref
    pcfg = pcfg.replace(map=dataclasses.replace(pcfg.map, max_obs_per_lm=8))
    m = P.port_map(P.tree_np(slam_j.tracking.map))
    arrays = {f: P.n(getattr(m, f)) for f in m._fields
              if not f.startswith("lm_obs")}
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **arrays)
    got, counters = tckpt.load_map(path, "cpu", pcfg)
    assert counters == {} and got.lm_obs_kf.shape[1] == 8
    blank = m._replace(
        lm_obs_kf=torch.full((m.lm_pos.shape[0], 8), -1, dtype=torch.int32),
        lm_obs_feat=torch.zeros((m.lm_pos.shape[0], 8), dtype=torch.int32),
        lm_obs_ptr=torch.zeros_like(m.lm_obs_ptr))
    want = tms.rebuild_observer_index(blank)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got.lm_obs_kf >= 0).sum()) > 100


@pytest.fixture(scope="module")
def sessions(ref, tmp_path_factory):
    """The port's DeviceSlam with loop closing: 10 frames uninterrupted, and
    5 + save + resume + 5."""
    cfg, pcfg, imgs, deps, _, _ = ref
    whole = DeviceSlam(pcfg, "cpu", seed=3, sync_every=4)
    for i in range(N):
        whole.process(imgs[i], deps[i], t=i * 0.033)
    traj_w, stats_w = whole.finish()
    first = DeviceSlam(pcfg, "cpu", seed=3, sync_every=4)
    for i in range(5):
        first.process(imgs[i], deps[i], t=i * 0.033)
    prefix = str(tmp_path_factory.mktemp("session") / "run")
    first.save(prefix)
    second = DeviceSlam.resume(prefix, pcfg, "cpu", sync_every=4)
    for i in range(5, N):
        second.process(imgs[i], deps[i], t=i * 0.033)
    traj_r, stats_r = second.finish()
    return pcfg, prefix, whole, second, (traj_w, stats_w), (traj_r, stats_r)


def test_device_session_resume_equals_uninterrupted_run(sessions):
    pcfg, _, whole, second, (traj_w, stats_w), (traj_r, stats_r) = sessions
    assert traj_r.shape == (N, 4, 4)
    np.testing.assert_allclose(traj_r, traj_w, atol=1e-5)
    np.testing.assert_allclose(stats_r, stats_w, atol=1e-5)
    assert second.ref_ids == whole.ref_ids
    assert second.timestamps == whole.timestamps
    assert second.state.kf_counter == whole.state.kf_counter >= 3
    np.testing.assert_array_equal(P.n(second.state.m.kf_id),
                                  P.n(whole.state.m.kf_id))
    np.testing.assert_allclose(second.rebuilt_trajectory(),
                               whole.rebuilt_trajectory(), atol=1e-5)
    assert sorted(second.culled_registry()) == sorted(whole.culled_registry())
    # the generators went on from where they were saved
    assert torch.equal(second.generator.get_state(),
                       whole.generator.get_state())
    lw, lr = whole.loop_closing, second.loop_closing
    assert (lr.vocab is None) == (lw.vocab is None)
    assert torch.equal(lr.db.kf_in_db, lw.db.kf_in_db)
    assert lr.trained_on_kfs == lw.trained_on_kfs


def test_session_of_other_capacities_is_refused(sessions):
    """Fault of the reference fixed here: `device_slam.py:543` unflattens
    whatever leaves the file holds into the new configuration's tree."""
    pcfg, prefix, *_ = sessions
    smaller = pcfg.replace(map=dataclasses.replace(pcfg.map, max_keyframes=16))
    with pytest.raises(ValueError, match="max_keyframes"):
        DeviceSlam.resume(prefix, smaller, "cpu")
    with pytest.raises(ValueError, match="ring"):
        DeviceSlam.resume(prefix, pcfg, "cpu", ring=64)
    with pytest.raises(ValueError, match="use_loop_closing"):
        DeviceSlam.resume(prefix, pcfg.replace(use_loop_closing=False), "cpu")


def test_session_keeps_culled_registry_and_loops(sessions, tmp_path):
    """Faults of the reference fixed here: `save()` drops the culled
    registry when mapping is not inline (`device_slam.py:497`), and
    `resume()` does not restore `loops` (`:543`)."""
    pcfg, prefix, whole, *_ = sessions
    slam = DeviceSlam.resume(prefix, pcfg, "cpu", sync_every=4)
    slam.inline_mapping = False
    T_cp = torch.eye(4)
    T_cp[0, 3] = 0.25
    slam._cull_pending.append(tms.CullInfo(
        culled=torch.tensor([True, False, False]),
        kf_id=torch.tensor([1, -1, -1], dtype=torch.int32),
        parent_kf_id=torch.tensor([0, -1, -1], dtype=torch.int32),
        T_cp=T_cp.repeat(3, 1, 1)))
    lc = slam.loop_closing
    lc.loops = [(3, 1)]
    lc.consistent_revisits = [(4, 0)]
    lc.consistent_groups = [({0, 1, 2}, 2)]
    lc.last_loop_kf_id = 3
    p2 = str(tmp_path / "again")
    slam.save(p2)
    back = DeviceSlam.resume(p2, pcfg, "cpu", sync_every=4,
                             inline_mapping=False)
    reg = back.culled_registry()
    assert list(reg) == [1] and reg[1][0] == 0
    np.testing.assert_allclose(reg[1][1], T_cp.numpy())
    lb = back.loop_closing
    assert lb.loops == [(3, 1)] and lb.consistent_revisits == [(4, 0)]
    assert lb.consistent_groups == [({0, 1, 2}, 2)] and lb.last_loop_kf_id == 3
    assert torch.equal(lb.generator.get_state(), lc.generator.get_state())
    # a file that lacks a field of the state says which
    data = dict(np.load(p2 + ".session.npz"))
    del data["state.m.lm_obs_ptr"]
    np.savez_compressed(p2 + ".session.npz", **data)
    with pytest.raises(KeyError, match="state.m.lm_obs_ptr"):
        DeviceSlam.resume(p2, pcfg, "cpu", sync_every=4, inline_mapping=False)


def test_device_new_sequence_anchors_in_the_map(sessions, ref):
    """`DeviceSlam.new_sequence` on a frame of the first half: enough
    bindings from `bootstrap_track`, a pose near the tracked one, and
    tracking goes on from it."""
    pcfg, prefix, whole, _, (traj_w, _), _ = sessions
    _, _, imgs, deps, _, _ = ref
    slam = DeviceSlam.resume(prefix, pcfg, "cpu", sync_every=4)
    assert slam.new_sequence(imgs[2], deps[2], t=100.0)
    slam.process(imgs[3], deps[3], t=100.033)
    traj, stats = slam.finish()
    assert traj.shape == (7, 4, 4) and stats.shape == (6, 9)
    assert np.abs(traj[5] - traj_w[2]).max() < 0.02
    assert np.abs(traj[6] - traj_w[3]).max() < 0.02
    assert stats[5, 0] > 20 and (stats[4] == 0).all()
    assert slam.rebuilt_trajectory().shape == (7, 4, 4)

"""Parity of the port's tracking front-end (`aslam_tpu_torch/models/
tracking.py`: `bootstrap_track`, `track_step`, the host class `Tracking`)
with the JAX package's.

One reference run is shared: the JAX `SlamSystem` with loop closing over the
12-frame walk of tests/test_resume.py::test_sensor_dropout_recovery (seed
31, blank frames 5 and 6), recorded by `_torch_parity.HostSpy`: the frames
its extractor made, the arguments, RANSAC draws and outputs of each
`track_step`.  The port is fed the same frames and draws, so the two differ
by float32 rounding only:

  * `track_step` on the reference's arguments, with RANSAC + motion BA and
    with the GICP escalation: bindings and counts equal, pose and float
    statistics to 1e-4;
  * `bootstrap_track` on the reference's final map at a perturbed pose:
    bindings and their count equal, pose to 1e-4;
  * the `Tracking` state machine through `SlamSystem.process_frame` over
    the whole walk, dropout included: states, info flags, counts and
    keyframe slots equal, poses to 1e-4; one host read per tracked frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.models import tracking as jtr
from aslam_tpu.models.system import SlamSystem as JSlamSystem
from aslam_tpu.utils import synthetic
from aslam_tpu_torch import convert
from aslam_tpu_torch.device import read_host
from aslam_tpu_torch.models import tracking as ttr
from aslam_tpu_torch.models.system import SlamSystem

N = 12
BLANK = (5, 6)


@pytest.fixture(scope="module")
def run():
    cfg = small_config().replace(use_loop_closing=True)
    rng = np.random.default_rng(31)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(N, step_t=0.04, rng=rng)
    tex = synthetic.point_textures(500, seed=32)
    slam = JSlamSystem(cfg)
    out = []
    with P.HostSpy(cfg) as spy:
        for i, T in enumerate(poses):
            if i in BLANK:
                img = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
                dep = np.zeros_like(img)
            else:
                img = synthetic.render_intensity_image(cfg.camera, T, pts, tex)
                dep = synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
            Tj, info = slam.process(img, dep, t=i * 0.033)
            out.append((np.asarray(Tj), dict(info), slam.tracking.state))
    return cfg, P.port_config(cfg), slam, spy, out


def _port_args(step):
    return (P.port_map(step["m"]),
            convert.frame_data(step["last_frame"], "cpu"),
            P.t(step["last_assoc"]), convert.frame_data(step["frame"], "cpu"),
            P.t(step["last_kf_T"]))


def _check_step(out_t, out_j, atol=1e-4):
    m_t, T_t, assoc_t, stats_t = out_t
    m_j, T_j, assoc_j, stats_j = out_j
    np.testing.assert_array_equal(P.n(assoc_t), assoc_j)
    ints = [0, 1, 2, 6]
    np.testing.assert_array_equal(P.n(stats_t)[ints], stats_j[ints])
    np.testing.assert_allclose(P.n(stats_t), stats_j, atol=atol)
    np.testing.assert_allclose(P.n(T_t), T_j, atol=atol)
    P.assert_maps_equal(m_t, m_j)


@pytest.mark.parametrize("i", [0, 3, 8])
def test_track_step_matches_reference(run, i):
    cfg, pcfg, _, spy, _ = run
    step = spy.steps[i]
    reads = read_host.count
    out_t = ttr.track_step(*_port_args(step), None, pcfg,
                           draws=P.t(step["draws"]))
    assert read_host.count == reads            # the per-frame program reads nothing
    _check_step(out_t, step["out"])
    assert int(step["out"][3][0]) > 20          # tracking was alive


def test_track_step_with_gicp_matches_reference(run):
    cfg, pcfg, _, spy, _ = run
    step = spy.steps[2]
    cfg3 = cfg.replace(use_gicp=True)
    out_j = P.tree_np(jtr.track_step(
        P.jtree(step["m"]), P.jtree(step["last_frame"]),
        jnp.asarray(step["last_assoc"]), P.jtree(step["frame"]),
        jnp.asarray(step["last_kf_T"]), step["key"], cfg3))
    out_t = ttr.track_step(*_port_args(step), None, P.port_config(cfg3),
                           draws=P.t(step["draws"]))
    _check_step(out_t, out_j)


def test_track_step_on_a_blank_frame_reports_failed_odometry(run):
    cfg, pcfg, _, spy, _ = run
    step = spy.steps[BLANK[0] - 1]
    out_t = ttr.track_step(*_port_args(step), None, pcfg,
                           draws=P.t(step["draws"]))
    _check_step(out_t, step["out"])
    assert int(out_t[3][0]) == 0 and int(out_t[3][2]) < cfg.ransac.min_inliers


@pytest.mark.parametrize("shift", [0.0, 0.03])
def test_bootstrap_track_matches_reference(run, shift):
    cfg, pcfg, slam_j, spy, out = run
    m_j = P.tree_np(slam_j.tracking.map)
    frame = spy.frames[9]
    T = out[9][0].copy()
    T[:3, 3] += shift                        # an approximate pose
    frame = frame._replace(T_cw=T)
    T_j, assoc_j, n_j = jtr.bootstrap_track(P.jtree(m_j), P.jtree(frame), cfg)
    reads = read_host.count
    T_t, assoc_t, n_t = ttr.bootstrap_track(
        P.port_map(m_j), convert.frame_data(frame, "cpu"), pcfg)
    assert read_host.count == reads
    np.testing.assert_array_equal(P.n(assoc_t), np.asarray(assoc_j))
    assert int(n_t) == int(n_j) >= 10
    np.testing.assert_allclose(P.n(T_t), np.asarray(T_j), atol=1e-4)


def test_update_lm_stats_and_first_free_slot(run):
    _, pcfg, slam_j, _, _ = run
    m = P.port_map(P.tree_np(slam_j.tracking.map))
    vis = torch.zeros_like(m.lm_valid)
    vis[:7] = True
    out = ttr.update_lm_stats(m, vis, vis & m.lm_valid)
    assert int((out.lm_visible - m.lm_visible).sum()) == 7
    assert int((out.lm_found - m.lm_found).sum()) == int(m.lm_valid[:7].sum())
    # as jnp.argmin over the booleans: the first False, 0 when none is left
    kf_valid = P.n(m.kf_valid)
    assert int(ttr.first_free_slot(m)) == int(np.argmin(kf_valid))
    full = m._replace(kf_valid=torch.ones_like(m.kf_valid))
    assert int(ttr.first_free_slot(full)) == 0


@pytest.fixture(scope="module")
def replay(run):
    cfg, pcfg, slam_j, spy, out = run
    slam_t = SlamSystem(pcfg, "cpu")
    reads = read_host.count
    res = P.replay_host(slam_t, spy, range(N), [i * 0.033 for i in range(N)])
    return slam_t, res, read_host.count - reads


def test_tracking_state_machine_matches_reference(run, replay):
    cfg, _, slam_j, spy, out = run
    slam_t, res, _ = replay
    states = [s for _, _, s in out]
    assert [s for _, _, s in res] == states
    assert "LOST" in states[5:8] and states[-1] == "OK"
    for i, ((T_t, info_t, _), (T_j, info_j, _)) in enumerate(zip(res, out)):
        assert info_t == info_j, (i, info_t, info_j)
        np.testing.assert_allclose(T_t, T_j, atol=1e-4, err_msg=str(i))
    tj, tt = slam_j.tracking, slam_t.tracking
    assert tt.new_kf_slots == tj.new_kf_slots
    assert tt.ref_kf_ids == tj.ref_kf_ids
    assert (tt.kf_counter, tt.n_kfs, tt.next_lm) == \
        (tj.kf_counter, tj.n_kfs, tj.next_lm)
    np.testing.assert_allclose(np.stack(tt.rel_poses), np.stack(tj.rel_poses),
                               atol=1e-4)
    assert not tt.ransac_draws                       # every draw was used
    # recovered after the dropout, on the motion model and re-acquisition
    assert any(i.get("motion_model") or i.get("reacquired")
               for _, i, _ in res[5:8])
    assert max(i.get("n_tracked", 0) for _, i, _ in res[-3:]) > 20
    P.assert_maps_equal(tt.map, P.tree_np(tj.map), atol=1e-3)


def test_host_engine_reads_are_counted(run, replay):
    """One packed read per tracked frame; the rest belongs to the first
    frame (2), LOST frames, culling rounds and loop closing."""
    slam_t, res, n_reads = replay
    n_kf = len(slam_t.tracking.new_kf_slots)
    n_lost = sum(1 for _, i, _ in res
                 if i.get("motion_model") or i.get("reacquired"))
    assert n_reads >= (N - 1) + 2
    # per keyframe at most: 3 culling rounds, the loop query and a
    # vocabulary training; per LOST frame: binding count, pose
    assert n_reads <= (N - 1) + 2 + 2 * n_lost + 6 * n_kf, (n_reads, n_kf)

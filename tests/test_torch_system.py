"""Parity of the port's host engine (`aslam_tpu_torch/models/system.py`,
`LocalMapping`, the exports) with the JAX package's `SlamSystem`.

One reference run is shared: loop closing on, the 10-frame walk of
tests/test_device_slam.py (seed 4, 5 cm / 0.02 rad steps: a keyframe every
few frames, local BA, culling), then `new_sequence()` and 5 frames of a
second clip over the same scene, as tests/test_multisequence_cli.py:29 does.
The port's `SlamSystem` is fed the reference's frames and RANSAC draws
(`_torch_parity.HostSpy`), so the two differ by float32 rounding only:
keyframe ids, slots, counters, the integer map fields and the culled
registry are equal, poses agree to 1e-4, the rebuilt trajectory and the
three export files to 1e-3 (after local BA).
"""

import numpy as np
import pytest

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.models.system import SlamSystem as JSlamSystem
from aslam_tpu.utils import synthetic
from aslam_tpu_torch.models import system as tsys
from aslam_tpu_torch.utils import trajectory

N1, N2 = 10, 5


@pytest.fixture(scope="module")
def run():
    cfg = small_config().replace(use_loop_closing=True)
    imgs, depths, poses = P.walk(N1)
    rng = np.random.default_rng(8)
    pts = synthetic.random_scene(np.random.default_rng(4), 500)
    tex = synthetic.point_textures(500, seed=5)
    poses2 = synthetic.camera_trajectory(N2, step_t=0.04, step_r=0.015, rng=rng)
    imgs2 = [synthetic.render_intensity_image(cfg.camera, T, pts, tex)
             for T in poses2]
    deps2 = [synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
             for T in poses2]
    ts = [i * 0.033 for i in range(N1)] + [1000 + i * 0.033 for i in range(N2)]
    slam_j = JSlamSystem(cfg)
    out = []
    with P.HostSpy(cfg) as spy:
        for i in range(N1):
            out.append(slam_j.process(imgs[i], depths[i], t=ts[i]))
        slam_j.new_sequence()
        for i in range(N2):
            out.append(slam_j.process(imgs2[i], deps2[i], t=ts[N1 + i]))
    slam_t = tsys.SlamSystem(P.port_config(cfg), "cpu")
    res = P.replay_host(slam_t, spy, range(N1 + N2), ts, new_sequence_at=(N1,))
    return cfg, slam_j, slam_t, out, res, np.concatenate([poses, poses2])


def test_slam_system_matches_reference(run):
    cfg, slam_j, slam_t, out, res, _ = run
    tj, tt = slam_j.tracking, slam_t.tracking
    assert tt.new_kf_slots == tj.new_kf_slots and len(tj.new_kf_slots) >= 3
    assert tt.ref_kf_ids == tj.ref_kf_ids
    assert (tt.kf_counter, tt.n_kfs, tt.next_lm, tt.state) == \
        (tj.kf_counter, tj.n_kfs, tj.next_lm, tj.state)
    for i, ((T_t, info_t, _), (T_j, info_j)) in enumerate(zip(res, out)):
        info_j = dict(info_j)
        info_j.pop("relocalized", None) if i == N1 else None
        info_t = {k: v for k, v in info_t.items()
                  if not (i == N1 and k == "relocalized")}
        assert info_t == info_j, (i, info_t, info_j)
        np.testing.assert_allclose(T_t, np.asarray(T_j), atol=1e-4,
                                   err_msg=str(i))
    assert len(tt.poses) == N1 + N2 == len(tt.timestamps)
    # every integer and boolean field exactly; positions after local BA 1e-3
    P.assert_maps_equal(tt.map, P.tree_np(tj.map), atol=1e-3)
    assert slam_t.local_mapping.n_processed == slam_j.local_mapping.n_processed


def test_culled_registry_matches_reference(run):
    _, slam_j, slam_t, *_ = run
    cj, ct = slam_j.local_mapping.culled, slam_t.local_mapping.culled
    assert sorted(ct) == sorted(cj)
    for k in cj:
        assert ct[k][0] == cj[k][0]
        np.testing.assert_allclose(ct[k][1], cj[k][1], atol=1e-3)


def test_new_sequence_anchors_in_the_shared_map(run):
    """The second clip's first frame anchors against the map of the first
    and tracking stays healthy (tests/test_multisequence_cli.py:29)."""
    _, slam_j, slam_t, out, res, _ = run
    T, info, state = res[N1]
    assert info["new_sequence"] and state == "OK"
    assert res[N1][1]["relocalized"] in (True, False)
    tracked = [i.get("n_tracked", 0) for _, i, _ in res[N1 + 1:]]
    assert max(tracked) > 20 and tracked == [
        i.get("n_tracked", 0) for _, i in out[N1 + 1:]]
    assert slam_t.tracking.n_kfs >= 2


def test_loop_closing_database_matches_reference(run):
    _, slam_j, slam_t, *_ = run
    lj, lt = slam_j.loop_closing, slam_t.loop_closing
    assert (lt.vocab is None) == (lj.vocab is None)
    assert lt.loops == [tuple(x) for x in lj.loops]
    np.testing.assert_array_equal(P.n(lt.db.kf_in_db),
                                  np.asarray(lj.db.kf_in_db))
    if lj.vocab is not None:
        np.testing.assert_array_equal(P.n(lt.db.kf_words),
                                      np.asarray(lj.db.kf_words))
        assert not lt.verify_draws


def test_rebuilt_trajectory_matches_reference(run):
    _, slam_j, slam_t, _, _, gt = run
    reb_j, reb_t = slam_j.rebuilt_trajectory(), slam_t.rebuilt_trajectory()
    assert reb_t.shape == (N1 + N2, 4, 4)
    np.testing.assert_allclose(reb_t, reb_j, atol=1e-3)
    # the first sequence against its ground truth
    ate = trajectory.ate_rmse(trajectory.camera_centers(reb_t[:N1]),
                              trajectory.camera_centers(gt[:N1]))
    assert ate < 0.03


def test_rebuild_trajectory_walks_the_culled_chain():
    """A frame whose reference keyframe was culled is rebuilt through the
    parent chain; one with no surviving ancestor keeps its tracked pose."""
    def shift(x):
        T = np.eye(4)
        T[0, 3] = x
        return T

    kf_valid = np.array([True, False, True])
    kf_ids = np.array([0, 7, 2])
    kf_T = np.stack([shift(1.0), shift(50.0), shift(3.0)])
    culled = {1: (0, shift(0.5)), 4: (1, shift(0.25)), 9: (8, shift(9.0))}
    refs = [0, 1, 4, 9, 2]
    rels = [shift(0.1)] * 5
    frozen = [shift(-1.0)] * 5
    out = trajectory.rebuild_trajectory(kf_valid, kf_ids, kf_T, culled, refs,
                                        rels, frozen)
    np.testing.assert_allclose(out[:, 0, 3], [1.1, 1.6, 1.85, -1.0, 3.1])


@pytest.mark.parametrize("which", ["camera", "keyframe", "histogram"])
def test_export_files_match_reference(run, tmp_path, which):
    _, slam_j, slam_t, *_ = run
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    if which == "histogram":
        slam_j.save_observation_histogram(pj)
        slam_t.save_observation_histogram(pt)
        assert open(pt).read() == open(pj).read()
        assert open(pt).readline() == "n_observations,n_landmarks\n"
        return
    save = "save_trajectory" if which == "camera" else "save_keyframe_trajectory"
    getattr(slam_j, save)(pj)
    getattr(slam_t, save)(pt)
    a, b = np.loadtxt(pt), np.loadtxt(pj)
    assert a.shape == b.shape and a.shape[1] == 8
    np.testing.assert_array_equal(a[:, 0], b[:, 0])          # stamps / ids
    np.testing.assert_allclose(a[:, 1:], b[:, 1:], atol=1e-3)
    if which == "camera":
        assert len(a) == N1 + N2
        slam_t.save_trajectory(pt, corrected=False)
        raw = trajectory.load_tum_trajectory(pt)
        np.testing.assert_allclose(
            raw[1], trajectory.camera_centers(np.stack(slam_t.tracking.poses)),
            atol=1e-5)


def test_local_mapping_culls_like_reference(run):
    """`LocalMapping.process_keyframe` with the redundancy bar at 0, so that
    its culling rounds find victims: the same keyframes go, with the same
    parents, and the round that culls nothing ends the loop (one read per
    round)."""
    import dataclasses

    from aslam_tpu.models.localmapping import LocalMapping as JLocalMapping
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.localmapping import LocalMapping

    cfg, slam_j, *_ = run
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, kf_cull_redundancy=0.0))
    tj = slam_j.tracking
    m_np = P.tree_np(tj.map)
    slot, kf_id = tj.new_kf_slots[-1], tj.kf_counter - 1
    lm_j = JLocalMapping(cfg)
    m_j = lm_j.process_keyframe(P.jtree(m_np), slot, kf_id, tj.n_kfs)
    lm_t = LocalMapping(P.port_config(cfg))
    reads = read_host.count
    m_t = lm_t.process_keyframe(P.port_map(m_np), slot, kf_id, tj.n_kfs)
    n_reads = read_host.count - reads
    assert len(lm_j.culled) >= 1 and sorted(lm_t.culled) == sorted(lm_j.culled)
    for k, (parent, T_cp) in lm_j.culled.items():
        assert lm_t.culled[k][0] == parent
        np.testing.assert_allclose(lm_t.culled[k][1], T_cp, atol=1e-3)
    assert n_reads == min(len(lm_j.culled) + 1, cfg.map.kf_cull_rounds)
    P.assert_maps_equal(m_t, P.tree_np(m_j), atol=1e-3)

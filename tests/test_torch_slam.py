"""Parity of the port's device SLAM engine (`aslam_tpu_torch/models/
device_slam.py`) with the JAX package's: config 2 (no loop closing, no
GICP) on the synthetic walk of tests/test_device_slam.py (seed 4, 500
points, 10 frames, sync_every=4), then config 3 and loop closing on the
hard loop scene (below).

  * one `slam_step` on a reference SlamState (carried across with
    `convert.slam_state`), with the reference's frame and RANSAC draws, on
    a keyframe frame and on a tracked-only frame: bindings, need_kf, ids and
    counts equal; poses 1e-4; the map after a keyframe's local BA 1e-3;
  * the whole slice: the port's DeviceSlam reaches ATE < 3 cm and at most
    1.5x the reference's plus 0.5 cm, raw and rebuilt, with every keyframe
    mapped;
  * chunked (`process_chunk`) equals stream (`process`) exactly on the CPU,
    and the host reads are what the engine claims: one per tracked frame
    plus one per local-BA gate;
  * `use_gicp`, `use_loop_closing` and both (the CLI's slam+gicp) over 30
    frames of the hard loop scene (`make_hard_sequence(kind="loop")`, as
    tests/test_device_slam.py:95-138) against the reference engine with
    both on: the same frames from both packages' renderers, ATE within
    1.5x the reference's plus 1 cm, keyframe counts within 3 (the RANSAC
    streams differ), the database holding every live keyframe, and the
    sync cadence's reads counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.models import device_slam as jds
from aslam_tpu.models import frame as jframe
from aslam_tpu_torch import convert
from aslam_tpu_torch.device import read_host
from aslam_tpu_torch.models import device_slam as tds
from aslam_tpu_torch.ops import lba as tlba
from aslam_tpu_torch.utils import trajectory

N_FRAMES = 10


@pytest.fixture(scope="module")
def walk():
    cfg = small_config()
    imgs, depths, poses = P.walk(N_FRAMES)
    dev, before = P.jax_walk_states(cfg, imgs, depths)
    traj, stats = dev.finish()
    return cfg, imgs, depths, poses, dev, before, traj, stats


_ref_draws = P.ref_draws


@pytest.mark.parametrize("kind", ["keyframe", "tracked"])
def test_slam_step_on_reference_state_matches_reference(walk, kind):
    cfg, imgs, depths, _, _, before, _, stats = walk
    need = stats[:, 6] > 0
    i = 1 + int(np.nonzero(need if kind == "keyframe" else ~need)[0][-1])
    state, key = before[i - 1]
    _, sub = jax.random.split(key)
    h, w = imgs[i].shape
    st_j, T_j, stats_j, ref_j, Tcr_j, cull_j = jds.slam_step(
        P.jtree(state), jnp.asarray(imgs[i]), jnp.asarray(depths[i]), sub,
        cfg, h, w)
    frame, grid = jframe._make_frame_impl(
        jnp.asarray(imgs[i]), jnp.asarray(depths[i]),
        jnp.asarray(state.grid_thresholds), cfg, h, w)
    draws = _ref_draws(P.jtree(state.last_frame), frame, sub, cfg)

    st_t = convert.slam_state(state, "cpu")
    reads = read_host.count
    st_o, T_o, stats_o, ref_o, Tcr_o, cull_o = tds.slam_step_frame(
        st_t, convert.frame_data(P.tree_np(frame), "cpu"),
        convert.grid_thresholds(grid, "cpu"), None, P.port_config(cfg),
        draws=P.t(draws))

    assert bool(stats_j[6]) == (kind == "keyframe") == bool(stats_o[6])
    np.testing.assert_allclose(P.n(T_o), np.asarray(T_j), atol=1e-4)
    np.testing.assert_allclose(P.n(Tcr_o), np.asarray(Tcr_j), atol=1e-4)
    ints = [0, 1, 2, 6, 7, 8]        # counts, need_kf, n_kfs, overflow
    np.testing.assert_array_equal(P.n(stats_o)[ints], np.asarray(stats_j)[ints])
    np.testing.assert_allclose(P.n(stats_o), np.asarray(stats_j), atol=1e-4)
    assert ref_o == int(ref_j)
    for a, b in zip(cull_o, P.tree_np(cull_j)):
        np.testing.assert_allclose(P.n(a), b, atol=1e-4)
    st_j = P.tree_np(st_j)
    np.testing.assert_array_equal(P.n(st_o.last_assoc), st_j.last_assoc)
    for name in ("n_kfs", "next_lm", "recent_slots", "recent_ids"):
        np.testing.assert_array_equal(P.n(getattr(st_o, name)),
                                      getattr(st_j, name), err_msg=name)
    assert st_o.kf_counter == int(st_j.kf_counter)
    assert st_o.recent_n == int(st_j.recent_n)
    np.testing.assert_allclose(P.n(st_o.last_kf_T), st_j.last_kf_T, atol=1e-3)
    P.assert_maps_equal(st_o.m, st_j.m,
                        atol=1e-3 if kind == "keyframe" else 1e-5)
    # one read per tracked frame, plus the local-BA gate on a keyframe
    assert read_host.count - reads == (2 if kind == "keyframe" else 1)


def test_device_slam_walk_reaches_reference_ate(walk):
    cfg, imgs, depths, poses, dev_j, _, traj_j, _ = walk
    gt = trajectory.camera_centers(poses)
    ate_j = trajectory.ate_rmse(trajectory.camera_centers(traj_j), gt)
    ate_jr = trajectory.ate_rmse(
        trajectory.camera_centers(dev_j.rebuilt_trajectory()), gt)

    runs = tlba.local_ba.runs
    slam = tds.DeviceSlam(P.port_config(cfg), "cpu", sync_every=4)
    for i in range(N_FRAMES):
        slam.process(imgs[i], depths[i], t=i * 0.033)
    traj, stats = slam.finish()
    assert traj.shape == (N_FRAMES, 4, 4) and stats.shape == (N_FRAMES - 1, 9)
    assert np.isfinite(traj).all() and stats[:, 0].min() > 20
    n_kfs = int(slam.state.n_kfs)
    assert n_kfs >= 2 and slam.kfs_mapped == n_kfs
    assert tlba.local_ba.runs > runs
    ate = trajectory.ate_rmse(trajectory.camera_centers(traj), gt)
    ate_r = trajectory.ate_rmse(
        trajectory.camera_centers(slam.rebuilt_trajectory()), gt)
    assert ate < 0.03 and ate <= 1.5 * ate_j + 0.005, (ate, ate_j)
    assert ate_r < 0.03 and ate_r <= 1.5 * ate_jr + 0.005, (ate_r, ate_jr)


def test_chunked_equals_stream_and_host_reads(walk):
    cfg, imgs, depths, _, _, _, _, _ = walk
    pcfg = P.port_config(cfg)
    imgs_u8 = np.clip(imgs, 0, 255).astype(np.uint8)
    depths_u16 = np.clip(depths / cfg.camera.depth_factor, 0,
                         65535).astype(np.uint16)

    reads = read_host.count
    stream = tds.DeviceSlam(pcfg, "cpu", seed=3, sync_every=4)
    for i in range(N_FRAMES):
        stream.process(imgs_u8[i], depths_u16[i], t=i * 0.033)
    traj_s, stats_s = stream.finish()
    n_reads = read_host.count - reads
    n_inserted = int(stats_s[:, 6].sum())
    assert n_inserted >= 1
    assert n_reads == (N_FRAMES - 1) + n_inserted       # need_kf + LBA gate

    chunked = tds.DeviceSlam(pcfg, "cpu", seed=3, sync_every=4)
    chunked.process_chunk(imgs_u8[:5], depths_u16[:5],
                          ts=[i * 0.033 for i in range(5)])
    chunked.process_chunk(torch.from_numpy(imgs_u8[5:]),
                          torch.from_numpy(depths_u16[5:]),
                          ts=[i * 0.033 for i in range(5, N_FRAMES)])
    traj_c, stats_c = chunked.finish()
    np.testing.assert_array_equal(traj_c, traj_s)
    np.testing.assert_array_equal(stats_c, stats_s)
    assert chunked.ref_ids == stream.ref_ids
    assert chunked.timestamps == stream.timestamps
    np.testing.assert_array_equal(chunked.rebuilt_trajectory(),
                                  stream.rebuilt_trajectory())
    for a, b in zip(chunked.state.m, stream.state.m):
        assert torch.equal(a, b)


def test_non_inline_mapping_maps_every_keyframe(walk):
    """Mapping at the sync cadence: one ring read per sync, then the fused
    per-keyframe program behind its alive guard (one read each)."""
    cfg, imgs, depths, poses, _, _, _, _ = walk
    slam = tds.DeviceSlam(P.port_config(cfg), "cpu", sync_every=4,
                          inline_mapping=False)
    for i in range(N_FRAMES):
        slam.process(imgs[i], depths[i])
    traj, _ = slam.finish()
    assert slam.state.recent_n == 0
    assert slam.kfs_mapped == slam.state.kf_counter >= 3
    ate = trajectory.ate_rmse(trajectory.camera_centers(traj),
                              trajectory.camera_centers(poses))
    assert ate < 0.03
    ring = P.n(tds._pack_ring(slam.state))
    assert (ring[:-2] == -1).all() and ring[-2] == 0


def test_convert_slam_state_and_unported_configs(walk):
    """Loop closing and config 3, once refused, now run; so does the last
    path that raised, the sharded post-loop GBA (`sharded_gn_cg`)."""
    import dataclasses

    import torch.distributed as dist

    from aslam_tpu_torch.models.loopclosing import LoopClosing
    from aslam_tpu_torch.profile_slam import looped_map

    cfg, imgs, depths, _, dev_j, _, _, _ = walk
    st = convert.slam_state(P.tree_np(dev_j.state), "cpu")
    assert st.kf_counter == int(dev_j.state.kf_counter)
    assert st.last_frame.feat.desc.dtype == torch.int32
    pcfg = P.port_config(cfg)
    slam = tds.DeviceSlam(pcfg.replace(use_loop_closing=True), "cpu")
    assert isinstance(slam.loop_closing, LoopClosing)
    assert tds.DeviceSlam(pcfg, "cpu").loop_closing is None
    reads = read_host.count
    st3, T3, stats3, *_ = tds.slam_step(
        st, torch.from_numpy(imgs[1]), torch.from_numpy(depths[1]),
        torch.Generator().manual_seed(0), pcfg.replace(use_gicp=True))
    assert torch.isfinite(T3).all() and stats3[0] > 20
    assert read_host.count - reads <= 2        # need_kf (+ the LBA gate)

    # the matrix-free pose-graph solver, taken above 256 keyframes, and the
    # session methods, all once refused, are ported
    big = pcfg.replace(map=dataclasses.replace(pcfg.map, max_keyframes=264))
    m, *_ = looped_map(big, "cpu", seed=1234)
    lc = LoopClosing(big, "cpu", train_after_kfs=4)
    for k in range(20):
        m = lc.process_keyframe(m, k, k)
    assert len(lc.loops) == 1 and torch.isfinite(m.kf_T_cw).all()
    for name in ("save", "resume", "new_sequence"):
        assert callable(getattr(tds.DeviceSlam, name))
    # the sharded post-loop GBA runs on a one-rank gloo group it creates
    sharded = pcfg.replace(loop=dataclasses.replace(
        pcfg.loop, post_gba_method="sharded_gn_cg"))
    try:
        m2 = LoopClosing(sharded, "cpu")._post_loop_gba(st.m)
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert torch.isfinite(m2.kf_T_cw).all() and torch.isfinite(m2.lm_pos).all()
    assert torch.equal(m2.kf_lm, st.m.kf_lm)


N_LOOP = 30


@pytest.fixture(scope="module")
def loop_scene():
    """30 frames of the 48-frame hard loop sequence, and the reference
    engine with GICP and loop closing over them."""
    import dataclasses

    from aslam_tpu.utils import synthetic_hard as jsh
    from aslam_tpu_torch.utils import synthetic_hard as tsh

    cfg = small_config()
    cam = dataclasses.replace(cfg.camera, k1=0.2624, k2=-0.9531, p1=-0.0054,
                              p2=0.0026, k3=1.1633)
    cfg = cfg.replace(camera=cam, use_gicp=True, use_loop_closing=True)
    pcfg = P.port_config(cfg)
    imgs, depths, gt = tsh.make_hard_sequence(pcfg.camera, kind="loop",
                                              n_frames=48, seed=0)
    ref = jsh.make_hard_sequence(cfg.camera, kind="loop", n_frames=4, seed=0)
    imgs, depths, gt = imgs[:N_LOOP], depths[:N_LOOP], gt[:N_LOOP]
    dev = jds.DeviceSlam(cfg, seed=0, sync_every=8)
    for i in range(N_LOOP):
        dev.process(imgs[i], depths[i], t=i * 0.033)
    traj, stats = dev.finish()
    return cfg, pcfg, imgs, depths, gt, ref, dev, traj, stats


def test_hard_sequence_renderer_equals_reference(loop_scene):
    """The port's copy of the hard synthetic suite gives the reference's
    frames: the renderers share no code at run time."""
    from aslam_tpu_torch.utils import synthetic_hard as tsh

    _, pcfg, imgs, depths, gt, ref, *_ = loop_scene
    own = tsh.make_hard_sequence(pcfg.camera, kind="loop", n_frames=4, seed=0)
    for a, b in zip(own, ref):
        np.testing.assert_array_equal(a, b)
    assert imgs.shape == (N_LOOP, 240, 320) and np.isfinite(depths).all()
    sweep = tsh.make_hard_sequence(pcfg.camera, kind="sweep", n_frames=2, seed=1)
    assert sweep[0].shape == (2, 240, 320)
    with pytest.raises(ValueError):
        tsh.make_hard_sequence(pcfg.camera, kind="other", n_frames=2)


@pytest.mark.parametrize("mode", ["gicp", "loop", "gicp+loop"])
def test_device_slam_config3_and_loop_closing_reach_reference_ate(loop_scene,
                                                                  mode):
    cfg, pcfg, imgs, depths, gt, _, dev_j, traj_j, stats_j = loop_scene
    gt_c = trajectory.camera_centers(gt)
    ate_j = trajectory.ate_rmse(trajectory.camera_centers(traj_j), gt_c)
    pcfg = pcfg.replace(use_gicp="gicp" in mode,
                        use_loop_closing="loop" in mode)
    reads = read_host.count
    slam = tds.DeviceSlam(pcfg, "cpu", seed=0, sync_every=8)
    chunk = 10
    for lo in range(0, N_LOOP, chunk):
        slam.process_chunk(imgs[lo:lo + chunk], depths[lo:lo + chunk],
                           ts=[i * 0.033 for i in range(lo, lo + chunk)])
    traj, stats = slam.finish()
    n_reads = read_host.count - reads
    assert traj.shape == (N_LOOP, 4, 4) and np.isfinite(traj).all()
    ate = trajectory.ate_rmse(trajectory.camera_centers(traj), gt_c)
    assert ate <= 1.5 * ate_j + 0.01, (mode, ate, ate_j)
    n_kfs = int(slam.state.n_kfs)
    inserted = int(stats[:, 6].sum())
    assert abs(inserted - int(stats_j[:, 6].sum())) <= 3
    assert slam.kfs_mapped == n_kfs >= 8
    reb = slam.rebuilt_trajectory()
    ate_r = trajectory.ate_rmse(trajectory.camera_centers(reb), gt_c)
    assert ate_r < 1.5 * ate + 0.01
    # reads: one per tracked frame, at most one LBA gate per keyframe, and
    # per sync (loop closing only) the ring read, the packed query read and
    # what loop closing reads beside it (training sample, verifications)
    n_syncs = 3 + 1                       # one per chunk, one in finish()
    base = (N_LOOP - 1) + inserted
    if "loop" in mode:
        lc = slam.loop_closing
        assert int(lc.db.kf_in_db.sum()) == slam.last_n_kfs
        assert lc.vocab is not None and lc.vocab.n_words == 1000
        assert lc.loops == [] == dev_j.loop_closing.loops
        assert base - inserted + n_syncs <= n_reads <= base + 3 * n_syncs + 4
    else:
        assert slam.loop_closing is None
        assert base - inserted <= n_reads <= base

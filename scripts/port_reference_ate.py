#!/usr/bin/env python3
"""ATE of the JAX package on the frames `chip_smoke.py` drives the PyTorch
port over: the constants its phases 5 to 7 hold the port to.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_reference_ate.py MODE

MODE is one of
  ricp        ADAPTIVE_RICP odometry (`ricp_fused`) over the 32 frames of
              `make_sequence(n_frames=32, n_points=1500, seed=5)`, frame pair
              by frame pair, at the default thresholds and with the
              escalation forced on every frame (escalate_min_inliers=10**6)
              -> JAX_RICP_ATE_M;
  slam-gicp   `DeviceSlam` with the bench's config 2 plus `use_gicp` over the
              64 frames of the bench walk, `process` per frame
              -> JAX_SLAM3_ATE_M (raw, rebuilt);
  slam-loop   `DeviceSlam` with the bench's config 2 in full (loop closing,
              shipped vocabulary), sync_every=32 -> JAX_SLAM_LOOP_ATE_M;
  vo-walk     `VisualOdometry` (the CLI's --mode vo) over the 64 frames of
              the bench walk -> JAX_CLI_ATE_M["vo"];
  device      `DeviceSlam` with config 3 and loop closing (the CLI's
              --mode slam+gicp --engine device) over the walk, sync_every=8,
              `process` per frame -> JAX_CLI_ATE_M["device"] (raw, rebuilt);
  host        `SlamSystem` (the CLI's --mode slam+gicp --engine host) with
              the same settings over the walk -> JAX_CLI_ATE_M["host"]
              (raw, rebuilt);
  families    `VisualOdometry` over the 32 frames of `ricp` for the detector
              x descriptor pairs of `chip_smoke.py` phase 8(b) (DOG+SIFT,
              HARRIS+FREAK, STAR+BRIEF, HESSIAN+LATCH) -> JAX_FAMILY_ATE_M;
  device-gftt-latch  `device` with --detector GFTT --descriptor LATCH, the
              CLI of phase 8(c) -> JAX_CLI_FAMILY_ATE_M (raw, rebuilt);
  batch [SEED]  `BatchVisualOdometry` (B = 4, PRNG seed SEED, default 0)
              over the 16 frames of `make_sequence(n_frames=16,
              n_points=1500, seed=50 + b)`, b = 0..3, `process` per frame:
              the lanes 0-3 of `chip_smoke.py` phase 9(b) -> JAX_BATCH_ATE_M
              (one ATE per lane; other seeds show the spread of the RANSAC
              draws).
The first three, `families` and `batch` take the frames as uint8 / uint16,
the rest as the TUM loader hands them over (float32 gray, float32 metres).
All at full width (640x480, 1024 keypoints), seed 0.  Each mode takes a few
minutes on a CPU.
"""

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from aslam_tpu.config import BAConfig, CameraModel, SystemConfig
from aslam_tpu.utils import synthetic, trajectory

CAM = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)


def centers(poses):
    return np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3]
                     for T in poses])


def sensor(imgs, depths):
    return (np.clip(imgs, 0, 255).astype(np.uint8),
            np.clip(depths / CAM.depth_factor, 0, 65535).astype(np.uint16))


def ricp():
    from aslam_tpu.models import frame as fm
    from aslam_tpu.models.extractor import init_adaptive_state
    from aslam_tpu.models.odometry import ricp_fused

    imgs, depths, poses, _ = synthetic.make_sequence(
        n_frames=32, n_points=1500, cam=CAM, seed=5)
    imgs, depths = sensor(imgs, depths)
    base = SystemConfig(camera=CAM, use_gicp=True)
    forced = base.replace(icp=dataclasses.replace(
        base.icp, escalate_min_inliers=10**6))
    for name, cfg in (("default", base), ("forced", forced)):
        ad = init_adaptive_state(cfg.extractor)
        key = jax.random.PRNGKey(0)
        prev, out = None, []
        for i in range(len(imgs)):
            f, ad = fm.make_frame(jnp.asarray(imgs[i]), jnp.asarray(depths[i]),
                                  cfg, ad)
            if prev is None:
                f = fm.with_pose(f, jnp.eye(4))
            else:
                key, sub = jax.random.split(key)
                f = fm.with_pose(f, ricp_fused(prev, f, sub, cfg).T_cw2)
            prev = f
            out.append(np.asarray(f.T_cw))
        print(name, repr(trajectory.ate_rmse(centers(out), centers(poses))),
              flush=True)


FAMILY_PAIRS = (("DOG", "SIFT"), ("HARRIS", "FREAK"), ("STAR", "BRIEF"),
                ("HESSIAN", "LATCH"))


def with_family(cfg, det, des):
    return cfg.replace(extractor=dataclasses.replace(
        cfg.extractor, detector=det, descriptor=des))


def families():
    from aslam_tpu.models.vo import VisualOdometry

    imgs, depths, poses, _ = synthetic.make_sequence(
        n_frames=32, n_points=1500, cam=CAM, seed=5)
    imgs, depths = sensor(imgs, depths)
    for det, des in FAMILY_PAIRS:
        t0 = time.time()
        vo = VisualOdometry(with_family(SystemConfig(camera=CAM), det, des))
        for i in range(len(imgs)):
            vo.process(imgs[i], depths[i])
        n_matches = min(s["n_matches"] for s in vo.stats)
        print(f"{det}+{des}", repr(trajectory.ate_rmse(centers(vo.poses),
                                                      centers(poses))),
              "min matches", n_matches,
              "min inliers", min(s["n_inliers"] for s in vo.stats),
              f"{time.time() - t0:.0f} s", flush=True)


def batch():
    from aslam_tpu.models.batch_vo import BatchVisualOdometry

    B, F = 4, 16
    seqs = [synthetic.make_sequence(n_frames=F, n_points=1500, cam=CAM,
                                    seed=50 + b) for b in range(B)]
    frames = [sensor(s[0], s[1]) for s in seqs]
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    bvo = BatchVisualOdometry(SystemConfig(camera=CAM), batch=B, seed=seed)
    for f in range(F):
        bvo.process(np.stack([fr[0][f] for fr in frames]),
                    np.stack([fr[1][f] for fr in frames]))
    traj = bvo.trajectories()                             # [F-1, B, 4, 4]
    ates = [trajectory.ate_rmse(
        centers(np.concatenate([np.eye(4)[None], traj[:, b]])),
        centers(seqs[b][2])) for b in range(B)]
    print(f"batch seed {seed} lanes 0-3", repr(ates), flush=True)


def bench_config(loop, gicp):
    cfg = SystemConfig(camera=CAM, use_loop_closing=loop, use_gicp=gicp)
    return cfg.replace(
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192,
                    local_iters_1=3, local_iters_2=5),
        map=dataclasses.replace(cfg.map, lm_cull_every=2, kf_cull_every=2,
                                lba_every=2, kf_cull_rounds=1),
        loop=dataclasses.replace(cfg.loop, use_pretrained_vocab=loop))


def bench_walk(n=64):
    """-> (uint8 gray, uint16 depth counts, true poses)."""
    rng = np.random.default_rng(11)
    pts = synthetic.random_scene(rng, 2000)
    poses = synthetic.camera_trajectory(n, step_t=0.03, step_r=0.012, rng=rng)
    tex = synthetic.point_textures(2000, seed=12)
    imgs = np.stack([synthetic.render_intensity_image(CAM, T, pts, tex)
                     for T in poses]).astype(np.float32)
    deps = np.stack([synthetic.render_depth_image(CAM, T, pts, splat=4)
                     for T in poses]).astype(np.float32)
    return (*sensor(imgs, deps), poses)


def loaded(imgs, deps):
    """Sensor frames as `TumSequence` returns them."""
    return (imgs.astype(np.float32),
            deps.astype(np.float32) * np.float32(CAM.depth_factor))


def slam(mode):
    from aslam_tpu.models.device_slam import DeviceSlam

    cli = mode in ("device", "device-gftt-latch")
    loop = mode == "slam-loop" or cli
    cfg = bench_config(loop, mode == "slam-gicp" or cli)
    if mode == "device-gftt-latch":
        cfg = with_family(cfg, "GFTT", "LATCH")
    imgs, deps, poses = bench_walk()
    if cli:
        imgs, deps = loaded(imgs, deps)
    sync = 8 if cli else {"slam-loop": 32}.get(mode, 129)
    dev = DeviceSlam(cfg, seed=0, sync_every=sync)
    for i in range(len(imgs)):
        dev.process(imgs[i], deps[i])
    traj, stats = dev.finish()
    lc = dev.loop_closing
    print(mode, repr(trajectory.ate_rmse(centers(traj), centers(poses))),
          repr(trajectory.ate_rmse(centers(dev.rebuilt_trajectory()),
                                   centers(poses))),
          "inserted", int(stats[:, 6].sum()), "live", int(dev.state.n_kfs),
          "loops", lc and (lc.loops, lc.consistent_revisits,
                           int(np.asarray(lc.db.kf_in_db).sum())), flush=True)


def vo_walk():
    from aslam_tpu.models.vo import VisualOdometry

    imgs, deps, poses = bench_walk()
    imgs, deps = loaded(imgs, deps)
    vo = VisualOdometry(SystemConfig(camera=CAM))
    for i in range(len(imgs)):
        vo.process(imgs[i], deps[i])
    print("vo-walk", repr(trajectory.ate_rmse(centers(vo.poses),
                                              centers(poses))), flush=True)


def host():
    from aslam_tpu.models.system import SlamSystem

    imgs, deps, poses = bench_walk()
    imgs, deps = loaded(imgs, deps)
    slam_sys = SlamSystem(bench_config(True, True))
    for i in range(len(imgs)):
        slam_sys.process(imgs[i], deps[i], t=0.033 * i)
    tr = slam_sys.tracking
    print("host", repr(trajectory.ate_rmse(centers(tr.poses), centers(poses))),
          repr(trajectory.ate_rmse(centers(slam_sys.rebuilt_trajectory()),
                                   centers(poses))),
          "kfs", tr.kf_counter, "live", tr.n_kfs,
          "culled", len(slam_sys.local_mapping.culled),
          "loops", slam_sys.loop_closing.loops, flush=True)


if __name__ == "__main__":
    t0 = time.time()
    mode = sys.argv[1]
    {"ricp": ricp, "vo-walk": vo_walk, "host": host,
     "families": families, "batch": batch}.get(
        mode, lambda: slam(mode))()
    print(f"{time.time() - t0:.0f} s")

#!/usr/bin/env python3
"""ATE of the JAX package on the frames `chip_smoke.py` drives the PyTorch
port over: the constants its phases 5 and 6 hold the port to.

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
              shipped vocabulary), sync_every=32 -> JAX_SLAM_LOOP_ATE_M.
All at full width (640x480, 1024 keypoints), frames as uint8 / uint16, seed
0.  Each mode takes a few minutes on a CPU.
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


def slam(mode):
    from aslam_tpu.models.device_slam import DeviceSlam

    loop = mode == "slam-loop"
    cfg = SystemConfig(camera=CAM, use_loop_closing=loop,
                       use_gicp=mode == "slam-gicp")
    cfg = cfg.replace(
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192,
                    local_iters_1=3, local_iters_2=5),
        map=dataclasses.replace(cfg.map, lm_cull_every=2, kf_cull_every=2,
                                lba_every=2, kf_cull_rounds=1),
        loop=dataclasses.replace(cfg.loop, use_pretrained_vocab=loop))
    n = 64
    rng = np.random.default_rng(11)
    pts = synthetic.random_scene(rng, 2000)
    poses = synthetic.camera_trajectory(n, step_t=0.03, step_r=0.012, rng=rng)
    tex = synthetic.point_textures(2000, seed=12)
    imgs = np.stack([synthetic.render_intensity_image(CAM, T, pts, tex)
                     for T in poses]).astype(np.float32)
    deps = np.stack([synthetic.render_depth_image(CAM, T, pts, splat=4)
                     for T in poses]).astype(np.float32)
    imgs, deps = sensor(imgs, deps)
    dev = DeviceSlam(cfg, seed=0, sync_every=32 if loop else 129)
    for i in range(n):
        dev.process(imgs[i], deps[i])
    traj, stats = dev.finish()
    lc = dev.loop_closing
    print(mode, repr(trajectory.ate_rmse(centers(traj), centers(poses))),
          repr(trajectory.ate_rmse(centers(dev.rebuilt_trajectory()),
                                   centers(poses))),
          "inserted", int(stats[:, 6].sum()), "live", int(dev.state.n_kfs),
          "loops", lc and (lc.loops, lc.consistent_revisits,
                           int(np.asarray(lc.db.kf_in_db).sum())), flush=True)


if __name__ == "__main__":
    t0 = time.time()
    mode = sys.argv[1]
    ricp() if mode == "ricp" else slam(mode)
    print(f"{time.time() - t0:.0f} s")

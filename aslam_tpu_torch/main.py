"""Command line: run the SLAM system on a TUM RGB-D sequence.

Port of `aslam_tpu/main.py`: the same flags, modes, engines and output
files, and one flag more, `--device` (default `cuda`): the port runs on the
card unless it is asked for the CPU, and stops when it is not asked and has
no card.

Usage:
  python -m aslam_tpu_torch.main --dataset /data/rgbd_dataset_freiburg1_xyz \\
      --camera fr1 --mode slam --out-dir results/

Writes CameraTrajectory.txt (TUM format) and metrics.json; the host engine
also KeyFrameTrajectory.txt and Histogram.csv.  In the SLAM modes, on either
engine, `--render-map` writes map.png (`utils/viewer.py`) and `--viewer PORT`
serves the live map (`utils/webviewer.py`), published every
`--viewer-every` frames and once more at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from aslam_tpu_torch import config as cfg_mod
from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.device import read_host

CAMERAS = {
    "fr1": cfg_mod.TUM_FR1,
    "fr2": cfg_mod.TUM_FR2,
    "fr3": cfg_mod.TUM_FR3,
    "icl": cfg_mod.ICL_NUIM,
}

def build_config(args, base: SystemConfig | None = None) -> SystemConfig:
    """The configuration the flags select, over `base` (default
    `SystemConfig()`)."""
    cfg = (base or SystemConfig()).replace(
        camera=CAMERAS[args.camera],
        use_gicp=args.mode == "slam+gicp",
        use_loop_closing=args.mode in ("slam+loop", "slam+gicp"))
    if args.detector != "FAST" or args.descriptor != "ORB":
        from aslam_tpu_torch.ops import desc as desc_ops
        from aslam_tpu_torch.ops import detectors

        try:
            detectors.canonical(args.detector)
            binary = desc_ops.is_binary(args.descriptor)
        except ValueError as e:   # a misspelt family: the message lists them
            raise SystemExit(f"aslam_tpu_torch.main: {e}") from None
        if not binary and args.mode != "vo":
            raise SystemExit(
                f"--descriptor {args.descriptor} is a float (L2) family; the "
                "map/BoW schema is binary — use it with --mode vo, or pick a "
                "binary descriptor (ORB, BRIEF, FREAK, LATCH) for SLAM modes"
            )
        cfg = cfg.replace(extractor=dataclasses.replace(
            cfg.extractor, detector=args.detector, descriptor=args.descriptor))
    if args.pose_prior is not None:
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, pose_prior_weight=args.pose_prior))
    if args.chain_prior is not None:
        cfg = cfg.replace(ba=dataclasses.replace(
            cfg.ba, chain_prior_weight=args.chain_prior))
    return cfg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="RGB-D SLAM on a CUDA device")
    ap.add_argument("--dataset", required=True,
                    help="TUM sequence dir with associations.txt")
    ap.add_argument("--camera", choices=sorted(CAMERAS), default="fr1")
    ap.add_argument("--mode", choices=["vo", "slam", "slam+loop", "slam+gicp"],
                    default="slam")
    ap.add_argument("--engine", choices=["host", "device"], default="host",
                    help="host: step-by-step Tracking / LocalMapping / "
                         "LoopClosing with checkpoints and exports; device: "
                         "the fused slam_step with one host read per frame")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    ap.add_argument("--detector", default="FAST",
                    help="FAST, GFTT, HARRIS, DOG, HESSIAN or STAR (or a "
                         "reference alias: ORB, SIFT, SURF, SHI_TOMASI, ...)")
    ap.add_argument("--descriptor", default="ORB",
                    help="ORB, BRIEF, FREAK, LATCH (binary) or SIFT (float, "
                         "--mode vo only)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames per process_chunk call (device engine "
                         "only); equivalent to streaming, with the sync "
                         "cadence run once per chunk")
    ap.add_argument("--pose-prior", type=float, default=None,
                    help="odometry motion-prior information in the "
                         "local-map pose refinement (1/m^2; default from "
                         "config; 0 = unconstrained re-solve)")
    ap.add_argument("--chain-prior", type=float, default=None,
                    help="odometry-chain regularizer information in "
                         "local/global BA (1/m^2; 0 disables)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--checkpoint", default="",
                    help="save map checkpoint here at the end")
    ap.add_argument("--resume", default="", help="load map checkpoint")
    ap.add_argument("--render-map", action="store_true")
    ap.add_argument("--export-cloud", action="store_true",
                    help="fuse depth maps into <out-dir>/map.ply")
    ap.add_argument("--viewer", type=int, default=-1, metavar="PORT",
                    help="serve a live web map viewer on this port "
                         "(0 = any free port)")
    ap.add_argument("--viewer-every", type=int, default=10,
                    help="publish a snapshot every N frames (one read of "
                         "the map per publish)")
    return ap


def run(argv=None, base_config: SystemConfig | None = None):
    """Run the CLI -> (Metrics, the engine it drove).  `base_config` is the
    configuration the flags modify (capacities, BA window, cadences), for
    callers that drive the CLI in process; the command line itself starts
    from `SystemConfig()`.  With `--viewer` the server goes on serving the
    final snapshot after the run, as the returned engine's `viewer`
    (`stop()` it; None without the flag), until the process ends."""
    args = _parser().parse_args(argv)
    if args.mode == "vo" and (args.render_map or args.viewer >= 0):
        raise SystemExit("--render-map (utils/viewer.py) and --viewer "
                         "(utils/webviewer.py) draw the map: use a SLAM mode "
                         "(slam, slam+loop, slam+gicp), not vo")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available; pass "
            "--device cpu to run on the CPU")

    from aslam_tpu_torch.utils.dataset import TumSequence
    from aslam_tpu_torch.utils.metrics import Metrics
    from aslam_tpu_torch.utils.trajectory import save_tum_trajectory

    cfg = build_config(args, base_config)
    seq = TumSequence(args.dataset, depth_factor=cfg.camera.depth_factor)
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    metrics = Metrics()
    os.makedirs(args.out_dir, exist_ok=True)
    traj_path = os.path.join(args.out_dir, "CameraTrajectory.txt")
    reads0 = read_host.count
    t0 = time.time()
    viewer = None
    if args.viewer >= 0:
        from aslam_tpu_torch.utils.webviewer import WebViewer

        viewer = WebViewer(port=args.viewer)
        print(f"live viewer: {viewer.url}", flush=True)
    every = max(args.viewer_every, 1)

    def publish(slam, frame, traj=None):
        from aslam_tpu_torch.utils import viewer as draw

        if traj is None:
            traj = draw.engine_trajectory(slam)
        viewer.update(draw.engine_map(slam), traj=traj,
                      stats=dict(draw.hud_counters(slam), frame=frame))

    def frames(lo, hi):
        for i in range(lo, hi):
            with metrics.timer("load"):
                item = seq[i]
            yield item

    if args.mode == "vo":
        from aslam_tpu_torch.models.vo import VisualOdometry

        slam = VisualOdometry(cfg, device)
        for t, img, depth in frames(0, n):
            with metrics.timer("track", sync=device):
                slam.process(img, depth, t)
            metrics.count("frames")
        save_tum_trajectory(traj_path, np.asarray(slam.timestamps),
                            np.stack(slam.poses))
    elif args.engine == "device":
        from aslam_tpu_torch.models.device_slam import DeviceSlam

        slam = DeviceSlam(cfg, device)
        lo = 0
        while lo < n:
            hi = min(lo + max(args.chunk, 1), n)
            if args.chunk > 1 and hi - lo == args.chunk:
                ts, imgs, depths = zip(*frames(lo, hi))
                with metrics.timer("track", sync=device):
                    slam.process_chunk(np.stack(imgs), np.stack(depths),
                                       list(ts))
            else:
                # frame by frame, and a tail shorter than the chunk
                for t, img, depth in frames(lo, hi):
                    with metrics.timer("track", sync=device):
                        slam.process(img, depth, t)
            metrics.count("frames", hi - lo)
            if viewer is not None and (hi - 1) // every > (lo - 1) // every:
                publish(slam, hi - 1)
            lo = hi
        traj, _ = slam.finish()
        if viewer is not None:
            publish(slam, n - 1, traj)
        save_tum_trajectory(traj_path, np.asarray(slam.timestamps), traj)
        metrics.count("keyframes", slam.state.kf_counter)
        print(f"{n} frames, {slam.kfs_mapped} keyframes, "
              f"{(time.time() - t0) / max(n, 1) * 1e3:.1f} ms/frame")
    else:
        from aslam_tpu_torch.models.system import SlamSystem
        from aslam_tpu_torch.utils import checkpoint as ckpt

        slam = SlamSystem(cfg, device)
        if args.resume:
            ckpt.load_system(args.resume, slam)
        for i, (t, img, depth) in enumerate(frames(0, n)):
            with metrics.timer("track", sync=device):
                slam.process(img, depth, t)
            metrics.count("frames")
            if viewer is not None and i % every == 0:
                publish(slam, i)
            if i % 50 == 0:
                mean_ms = 1e3 * (time.time() - t0) / max(i, 1)
                print(f"[{i}/{n}] mean {mean_ms:.1f} ms/frame", flush=True)
        if viewer is not None and n:
            publish(slam, n - 1)
        metrics.count("keyframes", len(slam.tracking.new_kf_slots))
        metrics.count("host_reads_tracking", read_host.count - reads0)
        slam.save_trajectory(traj_path)
        slam.save_keyframe_trajectory(
            os.path.join(args.out_dir, "KeyFrameTrajectory.txt"))
        slam.save_observation_histogram(
            os.path.join(args.out_dir, "Histogram.csv"))
        if args.checkpoint:
            ckpt.save_system(args.checkpoint, slam)
        if args.export_cloud:
            from aslam_tpu_torch.utils.pointcloud import export_dense_map

            n_pts = export_dense_map(
                slam, seq, os.path.join(args.out_dir, "map.ply"))
            print(f"dense map: {n_pts} points -> map.ply")
    if args.render_map:
        from aslam_tpu_torch.utils.viewer import render_map

        render_map(slam, os.path.join(args.out_dir, "map.png"))

    seq.close()
    metrics.count("host_reads", read_host.count - reads0)
    metrics.dump(os.path.join(args.out_dir, "metrics.json"))
    print(json.dumps(metrics.summary()["timers"], indent=2))
    slam.viewer = viewer
    return metrics, slam


def main(argv=None, base_config: SystemConfig | None = None):
    """`run`, returning the Metrics alone."""
    return run(argv, base_config)[0]


if __name__ == "__main__":
    main()

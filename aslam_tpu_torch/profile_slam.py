"""Where a SLAM frame's time, and a loop-closing sync's, go on the card.

    python -m aslam_tpu_torch.profile_slam [--frames 40] [--config 2|3]
        [--engine device|host] [--loop-closing] [--looped-map]
        [--out FILE.json]

Runs the port's `DeviceSlam` (`process`, inline mapping; with `--engine
host` the host engine, `SlamSystem.process`) at full width with
the JAX bench's config-2 settings (`bench_config2`; `--config 3` puts the
ADAPTIVE_RICP odometry in, `--loop-closing` turns loop closing on with the
shipped vocabulary and a sync every 16 frames) over the bench's walk
(`bench_walk`) on one card: after a warm-up, 12 frames under torch's sync
debug mode (every synchronising call counted), then three passes over
`--frames` frames:

  1. stage times: the engine's stage functions are wrapped with a host
     timer that synchronises the card before and after each call, so each
     stage is charged its own launches and device work.  Paths nest
     (`slam_step_frame/track_local_map/projection_match`); a time is the
     stage's total including its children;
  2. `torch.profiler` over the first `--profiled-frames` frames without
     the timers (bootstrap included): CUDA kernels launched per frame,
     device kernel time, the busy share of the wall time, and the kernels
     taking the most device time;
  3. the hot operations alone at the shapes the run gave them, with CUDA
     events: `projection_match` at proj_match_cap x 1024, the grouped
     assembly and the Schur solve of the last local BA, and the
     `pose_only_ba` of `track_local_map`.

With `--looped-map` it then times the stages of the loop-closing syncs over
a hand-built looped map at full capacities (`looped_map`, 24 keyframes,
windows of four through `LoopClosing.process_keyframes_batch`): database
rebuild, window query, verification, pose graph, correction, global BA.

Prints one table per pass and writes everything to `--out` as JSON.  Needs
a CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from collections import defaultdict

import numpy as np
import torch

from aslam_tpu_torch.config import BAConfig, CameraModel, SystemConfig


def bench_config2(loop_closing: bool = False) -> SystemConfig:
    """The JAX bench's config 2 (`bench.py:312-338`): 640x480, 1024
    keypoints, MapConfig() capacities (256 keyframes, 32768 landmarks,
    projection cap 8192), a 32+32-camera / 2048-point window, cull and
    local-BA cadence 2, one KF-cull round, 3+5 LBA iterations.  With
    `loop_closing` it is the bench's in full: loop closing on, with the
    shipped 10^4-word vocabulary."""
    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640,
                      height=480)
    cfg = SystemConfig(camera=cam, use_loop_closing=loop_closing)
    return cfg.replace(
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192,
                    local_iters_1=3, local_iters_2=5),
        map=dataclasses.replace(cfg.map, lm_cull_every=2, kf_cull_every=2,
                                lba_every=2, kf_cull_rounds=1),
        loop=dataclasses.replace(cfg.loop, use_pretrained_vocab=loop_closing))


def bench_config3(loop_closing: bool = False) -> SystemConfig:
    """Config 3: `bench_config2` with the ADAPTIVE_RICP odometry (RANSAC,
    then GICP where RANSAC is poor) in place of RANSAC + motion-only BA.
    With `loop_closing` it is the CLI's fullest mode, slam+gicp."""
    return bench_config2(loop_closing).replace(use_gicp=True)


def looped_map(cfg: SystemConfig, device, seed: int = 0, n_kfs: int = 20,
               n_pts: int = 600, drift_per_step: float = 0.008):
    """A hand-built map with a loop to close, the recipe of
    `tests/test_loopclosing.py::build_looped_map` in numpy: keyframes
    0..n-1 go out along +x and come back, the last at the true pose of the
    first; their estimated poses accumulate drift.  Each keyframe observes
    the points in front of its true pose (a narrow band, up to
    max_keypoints of them), the same world point always with the same
    descriptor; a point unseen for more than 3 keyframes gets a fresh
    duplicate landmark, as before a loop closure in the real pipeline.
    -> (MapState on `device`, T_true [n,4,4], T_est [n,4,4], drift of the
    last keyframe in metres)."""
    import torch as _torch

    from aslam_tpu_torch.models import mapstate as ms

    rng = np.random.default_rng(seed)
    cam = cfg.camera
    M = cfg.extractor.max_keypoints
    pts = np.stack([rng.uniform(-1.0, 3.0, n_pts), rng.uniform(-1.0, 1.0, n_pts),
                    rng.uniform(1.5, 3.5, n_pts)], -1).astype(np.float32)
    descs = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    xs = np.concatenate([np.linspace(0, 2.0, n_kfs // 2),
                         np.linspace(2.0, 0.0, n_kfs - n_kfs // 2)])
    xs[-1] = 0.0
    T_true = np.tile(np.eye(4, dtype=np.float32), (n_kfs, 1, 1))
    T_true[:, 0, 3] = -xs          # camera at world x: T_cw translation -x
    T_est = T_true.copy()
    acc = np.zeros(3, np.float32)
    for i in range(1, n_kfs):
        acc += rng.normal(0, drift_per_step, 3).astype(np.float32)
        T_est[i, :3, 3] += acc
    drift_final = float(np.linalg.norm(T_est[-1, :3, 3] - T_true[-1, :3, 3]))

    m = ms.init_map(cfg, "cpu")
    a = {name: getattr(m, name).numpy().copy() for name in m._fields}
    a["kf_desc"] = a["kf_desc"].view(np.uint32)
    a["lm_desc"] = a["lm_desc"].view(np.uint32)
    next_lm = 0
    lm_of_point = np.full(n_pts, -1, np.int64)
    last_seen = np.full(n_pts, -(10**6), np.int64)
    for k in range(n_kfs):
        pc = pts @ T_true[k, :3, :3].T + T_true[k, :3, 3]
        z = pc[:, 2]
        inv_z = np.float32(1.0) / np.where(np.abs(z) > 1e-9, z,
                                           np.float32(1e-9))
        uv = np.stack([cam.fx * pc[:, 0] * inv_z + cam.cx,
                       cam.fy * pc[:, 1] * inv_z + cam.cy], -1).astype(np.float32)
        vis = (z > 0.2) & (uv[:, 0] > 5) & (uv[:, 0] < cam.width - 5) \
            & (uv[:, 1] > 5) & (uv[:, 1] < cam.height - 5) \
            & (np.abs(pts[:, 0] - xs[k]) < 0.8)
        sel = np.nonzero(vis)[0][:M]
        n_f = len(sel)
        fresh = (lm_of_point[sel] < 0) | (k - last_seen[sel] > 3)
        new_ids = next_lm + np.arange(int(fresh.sum()))
        next_lm += len(new_ids)
        lm_of_point[sel[fresh]] = new_ids
        a["lm_pos"][new_ids] = pts[sel[fresh]]
        a["lm_desc"][new_ids] = descs[sel[fresh]]
        a["lm_valid"][new_ids] = True
        a["lm_first_kf"][new_ids] = k
        last_seen[sel] = k             # continuous visibility keeps the lm
        a["kf_xy"][k, :n_f] = uv[sel]
        a["kf_z"][k, :n_f] = z[sel]
        a["kf_desc"][k, :n_f] = descs[sel]
        a["kf_kp_valid"][k, :n_f] = True
        a["kf_lm"][k, :n_f] = lm_of_point[sel]
        kz = a["kf_z"][k]
        a["kf_ur"][k] = np.where(
            kz > 0, a["kf_xy"][k, :, 0] - cam.bf / np.maximum(kz, 1e-6), -1.0)
        a["kf_T_cw"][k] = T_est[k]
        a["kf_valid"][k] = True
        a["kf_id"][k] = k
    a["kf_desc"] = a["kf_desc"].view(np.int32)
    a["lm_desc"] = a["lm_desc"].view(np.int32)
    m = ms.MapState(**{name: _torch.from_numpy(v).to(device)
                       for name, v in a.items()})
    return ms.rebuild_observer_index(m), T_true, T_est, drift_final


def bench_walk(cam: CameraModel, n: int):
    """The bench's walk (`bench.py:343-355`: rng 11, 2000 points, 3 cm /
    0.012 rad steps, textures seed 12, splat 4) cut to n frames, as the
    sensor gives it -> (uint8 gray [n,H,W], uint16 depth counts, poses)."""
    from aslam_tpu_torch.utils import synthetic

    rng = np.random.default_rng(11)
    pts = synthetic.random_scene(rng, 2000)
    poses = synthetic.camera_trajectory(n, step_t=0.03, step_r=0.012, rng=rng)
    tex = synthetic.point_textures(2000, seed=12)
    imgs = np.stack([synthetic.render_intensity_image(cam, T, pts, tex)
                     for T in poses]).astype(np.float32)
    deps = np.stack([synthetic.render_depth_image(cam, T, pts, splat=4)
                     for T in poses]).astype(np.float32)
    return (np.clip(imgs, 0, 255).astype(np.uint8),
            np.clip(deps / cam.depth_factor, 0, 65535).astype(np.uint16), poses)


# (module, attribute) of every timed stage: the attribute the engine looks
# up at call time, so replacing it reaches every caller on the path
def _stages():
    from aslam_tpu_torch.models import (device_slam, frame, localmapping,
                                        loopclosing, system, tracking)
    from aslam_tpu_torch.models import mapstate as ms
    from aslam_tpu_torch.ops import (ba, global_ba, icp, lba, matching,
                                     pose_graph, ransac)

    return [
        (device_slam, "slam_step_frame"), (frame, "_make_frame_impl"),
        (system.SlamSystem, "process_frame"),
        (tracking.Tracking, "track_frame"), (tracking, "track_step"),
        (tracking, "bootstrap_track"),
        (localmapping.LocalMapping, "process_keyframe"),
        (loopclosing.LoopClosing, "process_keyframe"),
        (loopclosing.LoopClosing, "relocalize"),
        (tracking, "rba_step"), (tracking, "ricp_fused"),
        (ransac, "ransac_align"), (icp, "gicp_refine"), (icp, "icp_refine"),
        (icp, "normal_map"),
        (device_slam.DeviceSlam, "_background_mapping"),
        (loopclosing.LoopClosing, "process_keyframes_batch"),
        (loopclosing, "add_keyframes_batch"), (loopclosing, "batch_query"),
        (loopclosing, "verify_and_gate"), (loopclosing, "build_pose_graph"),
        (pose_graph, "optimize"), (loopclosing, "correct_map"),
        (global_ba, "global_ba"), (global_ba, "gn_cg_step"),
        (tracking, "track_local_map"),
        (matching, "projection_match"), (ba, "pose_only_ba"),
        (ms, "insert_keyframe"), (ms, "create_landmarks"),
        (device_slam, "map_keyframe_body"), (localmapping, "_refine_keyframe"),
        (ms, "refresh_landmark_descriptors_ids"), (ms, "landmark_culling"),
        (localmapping, "fuse_landmarks"),
        (ms, "refresh_landmark_positions_ids"),
        (ms, "refresh_landmark_positions"), (localmapping, "build_window"),
        (localmapping, "build_problem"), (lba, "local_ba"),
        (lba, "assemble_grouped"), (lba, "schur_solve"),
        (localmapping, "write_back"), (ms, "keyframe_culling"),
    ]


class StageTimer:
    """Wraps the stage functions with a synchronising host timer; keeps
    the last arguments of each, for pass 3."""

    def __init__(self):
        self.total = defaultdict(float)
        self.calls = defaultdict(int)
        self.last_args = {}
        self._stack: list[str] = []
        self._saved = []

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            self._stack.append(name)
            path = "/".join(self._stack)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.total[path] += time.perf_counter() - t0
                self.calls[path] += 1
                self.last_args[name] = (args, kw)
                self._stack.pop()
        return timed

    def __enter__(self):
        for mod, attr in _stages():
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(attr, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


def sync_sites(fn) -> dict[str, int]:
    """Run fn() under torch's sync debug mode and count the synchronising
    calls by their innermost call site in the package -> {"file:line
    source": count}, most frequent first.  Calls with no package frame on
    the stack (switching the mode warns once itself) count under
    "(outside the package)"."""
    import traceback
    import warnings

    sites: dict[str, int] = defaultdict(int)

    def record(message, *a, **kw):
        if "synchroniz" not in str(message):
            return
        for fr in reversed(traceback.extract_stack()[:-1]):
            if "aslam_tpu_torch" in fr.filename \
                    and "profile_slam" not in fr.filename:
                path = fr.filename[fr.filename.rindex("aslam_tpu_torch"):]
                sites[f"{path}:{fr.lineno} {fr.line}"] += 1
                return
        sites["(outside the package)"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def _events_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _run(cfg, dev, imgs, deps, engine="device"):
    from aslam_tpu_torch.models.device_slam import DeviceSlam
    from aslam_tpu_torch.models.system import SlamSystem

    if engine == "host":
        slam = SlamSystem(cfg, dev, seed=0)
    else:
        slam = DeviceSlam(cfg, dev, seed=0,
                          sync_every=16 if cfg.use_loop_closing else 10**9)
    for i in range(len(imgs)):
        slam.process(imgs[i], deps[i])
    torch.cuda.synchronize()
    return slam


def _print_stages(stages, per):
    print(f"{'stage path':72s} {'calls':>5s} {'ms/call':>9s} {'ms/' + per:>9s}")
    for p, s in stages.items():
        print(f"{p:72s} {s['calls']:5d} {s['ms_per_call']:9.2f} "
              f"{s['ms_per_unit']:9.2f}")


def _stage_dict(timer, units):
    return {p: {"calls": timer.calls[p], "ms_total": 1e3 * t,
                "ms_per_call": 1e3 * t / timer.calls[p],
                "ms_per_unit": 1e3 * t / units}
            for p, t in sorted(timer.total.items())}


def profile_looped_map(dev, card, n_kfs=24, n_pts=2500):
    """Stage times of the loop-closing syncs over the looped map at the
    bench's full config 2 -> dict for the JSON."""
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.loopclosing import LoopClosing

    cfg = bench_config2(loop_closing=True)
    K = cfg.map.max_keyframes
    arange = torch.arange(K, device=dev)

    def run(timer=None):
        m, *_ = looped_map(cfg, dev, seed=0, n_kfs=n_kfs, n_pts=n_pts)
        lc = LoopClosing(cfg, dev)
        for lo in range(0, n_kfs, 4):
            ids = list(range(lo, lo + 4))
            m_k = m._replace(kf_valid=m.kf_valid & (arange < lo + 4))
            out = lc.process_keyframes_batch(m_k, ids, ids, n_live=lo + 4)
            m = out._replace(kf_valid=m.kf_valid)
        torch.cuda.synchronize()
        return lc

    run()                                                    # warm-up
    reads = read_host.count
    torch.cuda.reset_peak_memory_stats()
    with StageTimer() as timer:
        lc = run()
    n_syncs = n_kfs // 4
    out = {"stages": _stage_dict(timer, n_syncs), "syncs": n_syncs,
           "loops": lc.loops, "host_reads": read_host.count - reads,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"looped map: {n_kfs} keyframes in {n_syncs} syncs, loops "
          f"{lc.loops}, {out['host_reads']} host reads, peak "
          f"{out['peak_gib']:.3f} GiB [{card}]")
    _print_stages(out["stages"], "sync")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--profiled-frames", type=int, default=8,
                    help="frames under torch.profiler (its event processing "
                    "is slow at ~45k kernels a frame)")
    ap.add_argument("--config", type=int, choices=(2, 3), default=2)
    ap.add_argument("--engine", choices=("device", "host"), default="device")
    ap.add_argument("--loop-closing", action="store_true")
    ap.add_argument("--looped-map", action="store_true")
    ap.add_argument("--out", default="profile_slam.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slam: needs a CUDA card")
    import subprocess

    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.ops import ba, icp, lba, matching

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = (bench_config3 if args.config == 3 else bench_config2)(
        args.loop_closing)
    imgs, deps, _ = bench_walk(cfg.camera, args.frames)
    _run(cfg, dev, imgs[:12], deps[:12], args.engine)       # warm-up
    out = {"card": card, "frames": args.frames, "config": args.config,
           "loop_closing": args.loop_closing, "engine": args.engine}

    # 0. synchronising calls the engine makes
    reads = read_host.count
    sites = sync_sites(lambda: _run(cfg, dev, imgs[:12], deps[:12],
                                    args.engine))
    out["syncs_12_frames"] = {"total": sum(sites.values()),
                              "read_host": read_host.count - reads,
                              "sites": sites}
    print(f"sync debug mode over 12 frames: {sum(sites.values())} "
          f"synchronising calls, {read_host.count - reads} read_host "
          f"calls [{card}]")
    for site, k in sites.items():
        print(f"  {k:6d}  {site}")

    # 1. stage times
    reads = read_host.count
    with StageTimer() as timer:
        t0 = time.perf_counter()
        slam = _run(cfg, dev, imgs, deps, args.engine)
        wall = time.perf_counter() - t0
    n_tracked = args.frames - 1
    n_kf = int(sum(c for p, c in timer.calls.items()
                   if p.endswith("_refine_keyframe")))
    out["stages"] = _stage_dict(timer, n_tracked)
    out["timed_wall_s"] = wall
    out["host_reads"] = read_host.count - reads
    out["keyframes_mapped"] = n_kf
    print(f"profile_slam: {args.frames} frames, {n_kf} keyframes mapped, "
          f"{out['host_reads']} host reads [{card}]")
    _print_stages(out["stages"], "frame")

    # 2. device busy share under the profiler, no stage timers
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run(cfg, dev, imgs[:args.profiled_frames],
             deps[:args.profiled_frames], args.engine)
        wall_p = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    out["profiler"] = {
        "wall_s": wall_p, "device_kernel_ms": dev_us / 1e3,
        "frames": args.profiled_frames, "cuda_kernels": n_kernels,
        "kernels_per_frame": n_kernels / args.profiled_frames,
        "busy_share": dev_us / 1e6 / wall_p,
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
                [:15]]}
    pr = out["profiler"]
    print(f"profiler: {pr['wall_s']:.2f} s wall, {pr['device_kernel_ms']:.1f} ms "
          f"device kernel time, {pr['cuda_kernels']} CUDA kernels "
          f"({pr['kernels_per_frame']:.0f} per frame), busy share "
          f"{pr['busy_share'] * 100:.1f}% [{card}]")
    for t in pr["top"]:
        print(f"  {t['device_ms']:9.2f} ms {t['count']:7d}x  {t['name']}")

    # 3. the hot operations alone, at the run's shapes
    ops = {}
    a, kw = timer.last_args["projection_match"]
    ops[f"projection_match {a[0].shape[0]}x{a[3].shape[0]}"] = (
        a, kw, matching.projection_match)
    for name in ("assemble_grouped", "schur_solve"):
        if name in timer.last_args:
            a, kw = timer.last_args[name]
            ops[name] = (a, kw, getattr(lba, name))
    for name in ("gicp_refine", "normal_map"):
        if name in timer.last_args:
            a, kw = timer.last_args[name]
            ops[f"{name} ({a[0].shape[0]} points)" if name == "gicp_refine"
                else f"{name} {tuple(a[0].shape[:2])}"] = (
                a, kw, getattr(icp, name))
    pose_calls = [p for p in timer.calls if p.endswith(
        "track_local_map/pose_only_ba")]
    if pose_calls:
        a, kw = timer.last_args["pose_only_ba"]
        ops["pose_only_ba (4x10, track_local_map)"] = (a, kw, ba.pose_only_ba)
    out["ops"] = {}
    for name, (a, kw, fn) in ops.items():
        ms = _events_ms(lambda: fn(*a, **kw))
        out["ops"][name] = ms
        print(f"op: {name:44s} {ms:9.3f} ms (CUDA events) [{card}]")
    m = slam.map if args.engine == "host" else slam.state.m
    out["n_kfs_live"] = int(m.kf_valid.sum())
    out["lm_live"] = int(m.lm_valid.sum())
    if args.looped_map:
        out["looped_map"] = profile_looped_map(dev, card)
    import os

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port's config-1 frame-to-frame VO once on a CUDA card.

    python3 chip_smoke.py          (from the repository root; needs one card)

Phases, one printed line each (or more, for phase 3):
  1. the card's name and power limit (nvidia-smi), then an nvcc build of
     every kernel of the path from `aslam_tpu_torch/csrc/`;
  2. the `hamming_top2` kernel against its plain PyTorch version at the
     main path's 1024 x 1024, exact integer equality, and both timed with
     CUDA events in turns (plain, kernel, kernel, plain);
  3. the full-width VO (640x480, 1024 keypoints, 8 levels, 256 RANSAC
     hypotheses) over 32 rendered frames fed as uint8 / uint16, through
     `VisualOdometry.process` and through one `track_sequence` call.  Each
     must give finite poses, one kernel launch per tracked frame, >= 30
     matches per frame, and an ATE below 1 cm and within 1.5x the JAX
     package's ATE on the same frames.
Then a JSON line on the kernels, and last `{"ok": true, "device": ...}`.
Any failure raises, so the script exits non-zero and prints no result.  It
refuses to run without a CUDA device, and it imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# ATE of the JAX package (`aslam_tpu.models.vo.VisualOdometry`, seed 0) on
# the same 32 frames, run on the CPU with jax 0.9.0 from the repository root:
#   JAX_PLATFORMS=cpu python -c "
#   import numpy as np
#   from aslam_tpu.config import SystemConfig, CameraModel
#   from aslam_tpu.models.vo import VisualOdometry
#   from aslam_tpu.utils import synthetic, trajectory, se3
#   cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
#   imgs, depths, poses, _ = synthetic.make_sequence(n_frames=32, n_points=1500, cam=cam, seed=5)
#   vo = VisualOdometry(SystemConfig(camera=cam))
#   for i in range(32): vo.process(np.clip(imgs[i], 0, 255).astype(np.uint8),
#       np.clip(depths[i] / cam.depth_factor, 0, 65535).astype(np.uint16))
#   c = lambda P: np.stack([np.asarray(se3.T_inv(T))[:3, 3] for T in P])
#   print(trajectory.ate_rmse(c(vo.poses), c(poses)))"
JAX_ATE_M = 0.005690574675354697
N_FRAMES = 32
MIN_MATCHES = 30


def phase1_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    from aslam_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = {name: build.build(name, verbose=True) for name in build.kernel_names()}
    print(f"phase 1: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"built {sorted(libs)} with nvcc in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return card


def _top2_inputs(rng, dev, n=1024, m=1024):
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    va, vb = rng.random(n) > 0.1, rng.random(m) > 0.1
    b[100:132] = b[100]                 # duplicated targets: tied minima
    a[:64] = b[100]
    a[64:96] = b[7] ^ np.uint32(1 << 31)
    b[500:508] = b[7]
    to = lambda x: torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                    else x).to(dev)
    return [to(a), to(va), to(b), to(vb)]


def _time_ms(fn, iters=200):
    for _ in range(10):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase2_kernel_vs_plain(dev):
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2, hamming_top2_plain

    rng = np.random.default_rng(0)
    cases = {"random+ties": _top2_inputs(rng, dev)}
    masked = _top2_inputs(rng, dev)
    masked[3] = torch.zeros_like(masked[3])            # no valid target at all
    cases["all-masked targets"] = masked
    err = 0.0
    for name, args in cases.items():
        out = hamming_top2(*args)
        ref = hamming_top2_plain(*args)
        torch.cuda.synchronize()
        for k, (x, y) in enumerate(zip(out, ref)):
            if not torch.equal(x, y):
                bad = (x != y).nonzero()[:5].flatten().tolist()
                raise AssertionError(f"hamming_top2 output {k} differs from the "
                                     f"plain version ({name}), rows {bad}")
            err = max(err, float((x.double() - y.double()).abs().max()))
    args = cases["random+ties"]
    plain = [_time_ms(lambda: hamming_top2_plain(*args))]
    kern = [_time_ms(lambda: hamming_top2(*args)) for _ in range(2)]
    plain.append(_time_ms(lambda: hamming_top2_plain(*args)))
    ms, plain_ms = sum(kern) / 2, sum(plain) / 2
    print(f"phase 2: hamming_top2 1024x1024 == plain exactly (tolerance 0, "
          f"{len(cases)} cases, max abs err {err}); kernel {ms * 1e3:.1f} us, "
          f"plain {plain_ms * 1e3:.1f} us (CUDA events, plain/kernel/kernel/plain)",
          flush=True)
    return err, ms, plain_ms


def _check_run(mode, poses, n_matches, launches, gt_poses, seconds, card):
    from aslam_tpu_torch.utils import trajectory

    poses = np.asarray(poses)
    if not np.isfinite(poses).all():
        raise AssertionError(f"{mode}: non-finite poses")
    n_tracked = len(poses) - 1
    if launches != n_tracked:
        raise AssertionError(f"{mode}: {launches} hamming_top2 launches for "
                             f"{n_tracked} tracked frames")
    if min(n_matches) < MIN_MATCHES:
        raise AssertionError(f"{mode}: a frame had {min(n_matches)} matches")
    ate = trajectory.ate_rmse(trajectory.camera_centers(poses),
                              trajectory.camera_centers(gt_poses))
    if not (ate < 0.01 and ate <= 1.5 * JAX_ATE_M):
        raise AssertionError(f"{mode}: ATE {ate:.5f} m vs JAX {JAX_ATE_M:.5f} m")
    print(f"phase 3: {mode}: {len(poses)} frames, ATE {ate * 100:.3f} cm "
          f"(JAX {JAX_ATE_M * 100:.3f} cm), min matches {min(n_matches)}, "
          f"{launches} kernel launches, {len(poses) / seconds:.2f} fps "
          f"[{card}]", flush=True)
    return ate


def phase3_vo(dev, card):
    from aslam_tpu_torch.config import CameraModel, SystemConfig
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import make_frame
    from aslam_tpu_torch.models.odometry import track_sequence
    from aslam_tpu_torch.models.vo import VisualOdometry
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.utils import synthetic

    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640,
                      height=480)
    cfg = SystemConfig(camera=cam)
    imgs, depths, gt, _ = synthetic.make_sequence(
        n_frames=N_FRAMES, n_points=1500, cam=cam, seed=5)
    imgs_u8 = np.clip(imgs, 0, 255).astype(np.uint8)
    depths_u16 = np.clip(depths / cam.depth_factor, 0, 65535).astype(np.uint16)

    # warm-up (allocator, cuBLAS handles, kernel library load)
    warm = VisualOdometry(cfg, dev)
    for i in range(3):
        warm.process(imgs_u8[i], depths_u16[i])
    torch.cuda.synchronize()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    # stream mode: the CLI's --mode vo engine, one frame at a time
    gen = torch.Generator(device=dev).manual_seed(0)
    vo = VisualOdometry(cfg, dev, generator=gen)
    hamming_top2.launches = 0
    start.record()
    for i in range(N_FRAMES):
        vo.process(imgs_u8[i], depths_u16[i])
    end.record()
    torch.cuda.synchronize()
    launches_stream = hamming_top2.launches
    ate_stream = _check_run(
        "VisualOdometry.process", vo.poses, [s["n_matches"] for s in vo.stats],
        launches_stream, gt, start.elapsed_time(end) / 1e3, card)

    # chunked mode: one track_sequence call over the recorded frames
    gen = torch.Generator(device=dev).manual_seed(0)
    hamming_top2.launches = 0
    start.record()
    imgs_d = torch.from_numpy(imgs_u8).to(dev)
    depths_d = torch.from_numpy(depths_u16).to(dev)
    f0, grid = make_frame(imgs_d[0], depths_d[0], cfg,
                          init_grid_thresholds(cfg.extractor, dev))
    _, _, seq = track_sequence(f0, imgs_d[1:], depths_d[1:], grid, gen, cfg)
    end.record()
    torch.cuda.synchronize()
    launches_seq = hamming_top2.launches
    poses = torch.cat([f0.T_cw[None], seq.T_cw]).cpu().numpy()
    ate_seq = _check_run("track_sequence", poses, seq.n_matches.tolist(),
                         launches_seq, gt, start.elapsed_time(end) / 1e3, card)
    return launches_stream + launches_seq, ate_stream, ate_seq


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run "
                         "only on the card")
    dev = torch.device("cuda", 0)
    import aslam_tpu_torch  # noqa: F401  (the port; sets the precision policy)

    card = phase1_device_and_build()
    err, ms, plain_ms = phase2_kernel_vs_plain(dev)
    launches, _, _ = phase3_vo(dev, card)
    print(json.dumps({"kernels": [{
        "name": "hamming_top2",
        "route": "cuda",
        "source": "aslam_tpu_torch/csrc/hamming_top2.cu",
        "replaces": "aslam_tpu/ops/pallas_kernels.py:57",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

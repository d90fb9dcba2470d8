#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on a CUDA card: config-1 VO, config-2
SLAM, config-3 (GICP escalation) VO and SLAM, loop closing, the host shell
(the CLI from a TUM directory on disk, both engines, sessions), the other
detector and descriptor families, batched VO and the viewers, distributed
BA over `torch.distributed`, and the benchmark's two cells.

    python3 chip_smoke.py          (from the repository root; needs one card)

Phases, one printed line each (or more, for phases 3 and 4):
  1. the card's name and power limit (nvidia-smi), then an nvcc build of
     every kernel of the path from `aslam_tpu_torch/csrc/`;
  2. the `hamming_top2` kernel against its plain PyTorch version, exact
     equality of all three outputs, at the main path's 1024 x 1024, at odd
     shapes, with ties and masks and past what its shared memory holds; then
     at 1024 x 1024 its eager per-call time beside the plain version's (CUDA
     events, in turns plain, kernel, kernel, plain), its device time (launches
     captured in a CUDA graph), an empty kernel's of the same grid and block,
     the host's time per call and the card's bound, with the 1-bit tensor-core
     rate that the bound divides by measured beside its constant; and its
     device time and bound at 8192 x 8192;
 2b. the motion-only BA kernel (`csrc/pose_ba.cu`, `pose_only_ba` on the
     card) against its plain PyTorch version on the cases of the `-m cuda`
     tests (`kernels/bench_pose_ba.py`: one VO frame's 1024 edges, 1, 37 and
     1000 edges, none valid, mono or stereo only, a NaN edge, the prior
     weight as a float and as a device scalar, 1 x 1 iterations): T to
     1e-5, chi2 to rtol 1e-4, inliers exactly but at near ties; B = 16
     lanes in one launch, each the bits of its lane alone; then at N = 1024
     and B = 16 its device time (CUDA graph), eager time beside the plain
     version's (in turns), host time and bound.  In phases 3 to 11 every run
     of the path must launch it once per tracked VO frame or batched step,
     twice per config-2 SLAM frame (`rba_step`, then `track_local_map`),
     once with GICP's odometry, never in the RICP odometry alone, and once
     more for each `bootstrap_track`;
  3. the full-width VO (640x480, 1024 keypoints, 8 levels, 256 RANSAC
     hypotheses) over 32 rendered frames fed as uint8 / uint16, through
     `VisualOdometry.process` and through one `track_sequence` call.  Each
     must give finite poses, one kernel launch per tracked frame, >= 30
     matches per frame, and an ATE below 1 cm and within 1.5x the JAX
     package's ATE on the same frames;
  4. the full-width config-2 SLAM engine (`DeviceSlam`: tracking against
     the local map, keyframe insertion, inline local mapping with the
     windowed Schur local BA, culling) with the JAX bench's config-2 settings
     minus loop closing, over 64 frames of the bench's walk fed as uint8 /
     uint16: two `process_chunk` calls of 32 frames, then `process` over the
     first 16.  Each run must give finite poses, one kernel launch per
     tracked frame and every keyframe mapped; the chunked run >= 3 keyframes,
     a local BA, and raw and rebuilt ATE below 3 cm and within 1.5x the JAX
     package's; a second chunked run the first's poses bit for bit; the
     stream run the chunked run's poses within 1 mm and its keyframe count.
  5. config 3 at full width (10 GICP iterations): (a) the ADAPTIVE_RICP
     odometry over phase 3's 32 frames, frame pair by frame pair, through
     `ricp_step` (branch on the host) and `ricp_fused` (no host read), with
     the escalation forced on every frame (`escalate_min_inliers=10**6`) and
     at the default thresholds: ATE below 1 cm and within 1.5x the JAX
     package's, one kernel launch per tracked frame, every forced frame
     escalated and converged, and `ricp_fused` equal to `ricp_step` to 1e-5;
     (b) `DeviceSlam` with `bench_config3()` over phase 4's 64 frames in two
     chunks, held to phase 4's gates against the JAX package's config 3;
  6. loop closing at full width: (a) `DeviceSlam` with the JAX bench's config
     2 in full (`bench_config2(loop_closing=True)`: shipped 10^4-word
     vocabulary, K = 256) over the 64 frames in two chunks, so the sync
     cadence runs after each chunk and in `finish()`: phase 4's gates, the
     database holding every live keyframe, the reads of each sync; (b) a
     hand-built looped map at full capacities (24 keyframes out and back
     with drifted poses, ~1000 features each, M = 1024, L = 32768, K = 256)
     through `LoopClosing.process_keyframes_batch` in windows of four: a
     loop closed between the return leg and the outbound leg, the drift at
     the closing keyframe cut by >= 20%, `map_chi2` around the post-loop
     global BA;
  7. the host shell at full width: (a) a TUM-layout directory (8-bit gray and
     16-bit depth PNGs, `associations.txt`) fabricated from the walk's 64
     frames in a temporary directory, read back through `TumSequence` (the
     decoder in use is printed; the native one, where it built, and the zlib
     one must both return the frames exactly); (b) the CLI in process over
     it: `--mode vo`, `--mode slam+gicp --engine device --chunk 32` and
     `--mode slam+gicp --engine host --checkpoint`: the output files, one
     finite row per frame, one kernel launch per tracked frame, ATE under
     the repo's gates and within 1.5x the JAX package's through the same
     path; (c) `DeviceSlam` over 32 frames, `save`, `resume` in a fresh
     object, 32 more: the uninterrupted run's poses bit for bit (every float
     scatter-add is ordered, `ops/index.py::index_add_ordered`) and its
     keyframe ids; then `new_sequence` on a frame of the first half, which must
     relocalize through the shipped vocabulary to within 2 cm / 0.02 rad of
     the truth, bind >= 10 landmarks and track the next frame; (d) the CLI
     with `--resume` from (b)'s checkpoint over the first 16 frames as a
     second sequence: anchored by relocalization, every frame tracked above
     `min_matches_tracked`, within 3 cm of the truth in the first map's frame;
  8. the detector and descriptor families at full width: (a) the six
     responses and the five descriptors on the 8 level images of one frame
     of phase 3, on the card and on the CPU from the same level images:
     response masks equal but within 1e-3 of the threshold, values to rtol
     1e-5; descriptor rows at the FAST keypoints of each level equal (SIFT to
     1e-5) but where the two IC angles steer a sample onto another pixel,
     and all equal on level 0; each family's ms per frame on the card;
     (b) VO over phase 3's 32 frames with DOG+SIFT (the float L2 matcher),
     HARRIS+FREAK, STAR+BRIEF and HESSIAN+LATCH: every frame tracked,
     `hamming_top2` launched once per frame for a binary pair and never for
     SIFT, ATE within 1.5x the JAX package's; make-frame ms per frame, with
     FAST+ORB's beside them; (c) the CLI `--mode slam+gicp --engine device
     --chunk 32 --detector GFTT --descriptor LATCH` over the walk's 64 PNGs,
     held to phase 7's gates against the JAX package through the same path;
     (d) a second run of (c), bit-identical to the first;
  9. batched VO at full width: (a) `hamming_top2` with its batch axis at B =
     16 x 1024 x 1024 with masks and ties, exactly equal to the batched plain
     version and to 16 unbatched calls; its device time (CUDA graph) beside
     16 unbatched launches', the floor and the bound x 16; (b)
     `BatchVisualOdometry` at B = 1, 4 and 16 over 16 frames of 16 rendered
     sequences (seeds 50 + b, uint8 / uint16), through `process` and through
     `process_chunk` in two chunks: chunked == stream bit for bit, one kernel
     launch per batched step, CUDA kernels per step (torch.profiler) at B =
     16 at most 100 more per extra lane than at B = 1,
     every lane's ATE below 1 cm and lanes 0-3 within 1.5x the JAX
     package's; aggregate frame-tracks per second,
     ms per step, busy share and peak memory per B; then at B = 16 with
     injected draws, lanes 0-3 against the unbatched `track_frame` chain
     within 1e-4 on T, with the descriptor bits that differ; (c) the CLI
     `--mode slam+gicp --engine device --chunk 32 --render-map --viewer 0`
     over the walk's 64 PNGs: a non-empty map.png, one GET of the viewer's
     state with keyframes and 64 trajectory rows, and phase 7(b)'s ATE;
 10. distributed BA (`aslam_tpu_torch/parallel/`) with the torch version:
     on a one-rank NCCL group, (a) `sharded_local_ba` against `local_ba` at
     `bench_config2()`'s full local-BA window (64 cameras, 2048 points,
     8192 edges, seeded noise) to 1e-3, equal edges, a bit-identical second
     run, ms per call of both in turns; (b) phase 6(b)'s looped map through
     `LoopClosing` with `post_gba_method="sharded_gn_cg"`, twice: phase
     6(b)'s gates, the two runs bit-identical, `map_chi2` and the GBA's ms
     beside phase 6(b)'s `gn_cg` ones; on the map as built,
     `sharded_global_ba` against `ba_sweep` x 4 and `partitioned_gn_cg_step`
     against `gn_cg_step` to 2e-3, with ms per call; (c) two processes on
     the card in a gloo group over CUDA tensors (NCCL takes one rank per
     card): `dryrun_multichip` in layouts 1x2 and 2x1, its parity lines
     gated as in the reference.  Phase 10 launches no kernel.
 11. the benchmark (`benchmark/`, `BENCHMARK.json`): both cells once through
     its own entry function `benchmark.run.run_cell`, cut short (VO 16
     timed frames; SLAM one chunk of 16), traced (the pass timed with
     tracing off, then again under the spans): each run correct (the
     cells' ATE gates), every metric `BENCHMARK.json` names for the cell
     printed with its unit, the top kernels and idle gaps, and one
     `hamming_top2` launch per tracked frame.
Then a JSON line on both kernels (launches: phases 3 to 11's runs), and last
`{"ok": true, "device": ...}`.
Any failure raises, so the script exits non-zero and prints no result.  It
refuses to run without a CUDA device, and it imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
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

# ATE of the JAX package's config-2 `DeviceSlam` (the settings of
# `aslam_tpu_torch.profile_slam.bench_config2`, `process` per frame, seed 0)
# on the 64 frames of `bench_walk`, raw and rebuilt, run on the CPU with jax
# 0.9.0 from the repository root by the code of those two functions with
# `aslam_tpu` in place of `aslam_tpu_torch`, then:
#   dev = DeviceSlam(cfg, seed=0, sync_every=129)
#   for i in range(64): dev.process(imgs_u8[i], deps_u16[i])
#   traj, _ = dev.finish(); ate(traj), ate(dev.rebuilt_trajectory())
#   (237 s on the CPU; 6 keyframes inserted, 7 live at the end)
JAX_SLAM_ATE_M = 0.0032870445811745406
JAX_SLAM_ATE_REBUILT_M = 0.0035003549024261184
N_SLAM = 64
N_STREAM = 16

# ATE of the JAX package on the frames of phases 5 and 6, run on the CPU with
# jax 0.9.0 from the repository root by `scripts/port_reference_ate.py`:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_reference_ate.py ricp
#     the ADAPTIVE_RICP odometry (`ricp_fused`) on phase 3's 32 frames, frame
#     pair by frame pair, at the default thresholds and with the escalation
#     forced on every frame (escalate_min_inliers=10**6)
JAX_RICP_ATE_M = {"default": 0.003546169572370281,
                  "forced": 0.006648484874044746}
#   ... port_reference_ate.py slam-gicp   (204 s; 6 keyframes inserted, 7 live)
#     `DeviceSlam` with config 3 on the 64 frames of `bench_walk`, `process`
#     per frame, seed 0: raw and rebuilt
JAX_SLAM3_ATE_M = (0.002102473097171833, 0.0022858326225181284)
#   ... port_reference_ate.py slam-loop   (196 s; 6 inserted, 7 in the database)
#     the same with the bench's config 2 in full (loop closing, shipped
#     vocabulary) and sync_every=32: the cadence runs after frames 32 and 64,
#     as it does after each chunk here
JAX_SLAM_LOOP_ATE_M = (0.0032870445811745406, 0.0035003549024261184)
N_LOOP_KFS = 24
N_LOOP_PTS = 2500

#   ... port_reference_ate.py vo-walk | device | host   (55 s, 153 s, 140 s)
#     the engines behind the CLI's three paths of phase 7 on the walk's 64
#     frames as the TUM loader hands them over (float32 gray, float32
#     metres), config 3 with loop closing: `VisualOdometry`; `DeviceSlam`
#     (raw, rebuilt; 6 keyframes inserted, 7 live); `SlamSystem` (raw,
#     rebuilt; 7 keyframes, none culled, no loop)
JAX_CLI_ATE_M = {"vo": 0.00831013053630803,
                 "device": (0.002102473097171833, 0.0022858326225181284),
                 "host": (0.002102553912453388, 0.002304286046556286)}
N_SECOND = 16           # frames of the second sequence
RELOC_FRAME = 10        # the first-half frame that `new_sequence` re-enters on

# ATE of the JAX package with the other detector and descriptor families:
#   ... port_reference_ate.py families   (148 s)
#     `VisualOdometry` over phase 3's 32 frames (uint8 / uint16) with each
#     pair of phase 8(b); every frame tracked on the JAX side too
JAX_FAMILY_ATE_M = {("DOG", "SIFT"): 0.002333074804979112,
                    ("HARRIS", "FREAK"): 0.0020125456521010456,
                    ("STAR", "BRIEF"): 0.0049640273807776275,
                    ("HESSIAN", "LATCH"): 0.003344138499346909}
#   ... port_reference_ate.py device-gftt-latch   (133 s; 6 inserted, 7 live)
#     the `device` mode above with --detector GFTT --descriptor LATCH: the CLI
#     of phase 8(c) (raw, rebuilt)
JAX_CLI_FAMILY_ATE_M = (0.0012753416043231815, 0.001177245822065391)
# ATE of the JAX package's batched VO, one per lane:
#   ... port_reference_ate.py batch   (78 s)
#     `BatchVisualOdometry` (B = 4) over 16 frames of the sequences of phase
#     9(b)'s lanes 0-3 (uint8 / uint16), `process` per frame
JAX_BATCH_ATE_M = (0.002146345737719163, 0.00566595295701858,
                   0.0010613850590123226, 0.0013762852774177224)
N_BATCH = 16            # sequences of phase 9, and the most lanes a run takes
N_BATCH_FRAMES = 16     # frames of each
BATCHES = (1, 4, 16)
MAX_KERNELS_PER_LANE = 100   # CUDA kernels a step adds per lane past the first
DETECTORS = ("FAST", "GFTT", "HARRIS", "DOG", "HESSIAN", "STAR")
DESCRIPTORS = ("ORB", "BRIEF", "FREAK", "LATCH", "SIFT")


# `pose_only_ba_kernel` launches of the main path's runs in phases 3-11, added
# by `_pose_launches` just after each run
POSE_LAUNCHES = {"total": 0}


def zero_launches():
    """Every kernel's launch count to 0, just before a run of the path."""
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    hamming_top2.launches = pose_only_ba_kernel.launches = 0


def _pose_launches(what, expected, count=None):
    """Just after a run: the motion-only BA kernel's launches in it (`count`,
    or the counter as the run left it) must be `expected`; they go into the
    kernels line's total.  -> the count."""
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    k = pose_only_ba_kernel.launches if count is None else count
    if k != expected:
        raise AssertionError(f"{what}: {k} pose_only_ba launches, {expected} "
                             f"expected")
    POSE_LAUNCHES["total"] += k
    return k


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


def _top2_cases(dev):
    """name -> [desc_a, valid_a, desc_b, valid_b] on the card: the main path's
    shape with tied minima and with no valid target, shapes that are no
    multiple of the kernel's partition, one and two targets, masked queries,
    all targets equal, and target counts beyond what stays resident in
    shared memory (the ring)."""
    from aslam_tpu_torch.kernels.bench_top2 import top2_inputs

    rng = np.random.default_rng(0)
    cases = {"1024x1024 random+ties": top2_inputs(rng, dev)}
    masked = top2_inputs(rng, dev)
    masked[3] = torch.zeros_like(masked[3])            # no valid target at all
    cases["1024x1024 all-masked targets"] = masked
    for n, m in ((1000, 1023), (1, 1), (5, 3), (257, 31), (7, 1), (7, 2),
                 (1024, 16384), (8192, 8192)):
        cases[f"{n}x{m}"] = top2_inputs(rng, dev, n, m)
    one = top2_inputs(rng, dev, 7, 2)
    one[3] = torch.tensor([False, True], device=dev)   # d2 with one valid target
    cases["7x2 one valid target"] = one
    no_query = top2_inputs(rng, dev, 300, 700)
    no_query[1] = torch.zeros_like(no_query[1])
    cases["300x700 all-masked queries"] = no_query
    for n, m in ((300, 700), (64, 7000)):
        equal = top2_inputs(rng, dev, n, m)
        equal[2] = equal[2][:1].repeat(m, 1)           # every target the same
        equal[3] = torch.ones_like(equal[3])
        cases[f"{n}x{m} all targets equal"] = equal
    return cases


@functools.lru_cache(maxsize=1)
def _empty_kernel():
    import ctypes

    from aslam_tpu_torch.kernels import build

    empty = build.load("hamming_top2").hamming_top2_empty_launch
    empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    return empty


def launch_empty(n, m, b=1):
    """The kernel of `csrc/hamming_top2.cu` that does nothing, at the grid,
    block and shared memory of a b x [n] x [m] call: a launch's floor."""
    if _empty_kernel()(b, n, m, torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("the empty kernel did not launch")


def phase2_kernel_vs_plain(dev):
    """-> the `hamming_top2` entry of the kernels line, its launches apart."""
    from aslam_tpu_torch.kernels.bench_top2 import (event_us, graph_us, host_us,
                                                    mma_peak_ops_per_s)
    from aslam_tpu_torch.ops.hamming_top2 import (MMA_OPS_PER_S, hamming_top2,
                                                  hamming_top2_bound,
                                                  hamming_top2_plain)

    cases = _top2_cases(dev)
    err = 0.0
    for name, args in cases.items():
        out = hamming_top2(*args)
        a, va, b, vb = args
        if len(b) == 1:
            # the plain version sorts two values a row: give it a second,
            # masked target, which the kernel's INVALID_DIST for d2 equals
            args = [a, va, torch.cat([b, b]), torch.cat([vb, torch.zeros_like(vb)])]
        ref = hamming_top2_plain(*args)
        torch.cuda.synchronize()
        for k, (x, y) in enumerate(zip(out, ref)):
            if not torch.equal(x, y):
                bad = (x != y).nonzero()[:5].flatten().tolist()
                raise AssertionError(f"hamming_top2 output {k} differs from the "
                                     f"plain version ({name}), rows {bad}")
            err = max(err, float((x.double() - y.double()).abs().max()))
        del out, ref
    print(f"phase 2: hamming_top2 == plain exactly (tolerance 0, max abs err "
          f"{err}) on {len(cases)} cases: {', '.join(cases)}", flush=True)

    # the main path's shape: eager per-call times in turns, then the device
    # time free of the host, the least a launch of this shape takes, and the
    # host's own time per call
    args = cases["1024x1024 random+ties"]
    plain = [event_us(lambda: hamming_top2_plain(*args))]
    kern = [event_us(lambda: hamming_top2(*args)) for _ in range(2)]
    plain.append(event_us(lambda: hamming_top2_plain(*args)))
    call_us, plain_us = sum(kern) / 2, sum(plain) / 2
    device_us = graph_us(lambda: hamming_top2(*args))
    floor_us = graph_us(lambda: launch_empty(1024, 1024))
    host = host_us(lambda: hamming_top2(*args))
    bound = hamming_top2_bound(1024, 1024)
    print(f"phase 2: 1-bit mma rate of this card {mma_peak_ops_per_s(dev) / 1e12:.0f} "
          f"TOP/s (probe kernel, best of 3); the bound divides by "
          f"{MMA_OPS_PER_S / 1e12:.0f} TOP/s", flush=True)
    print(f"phase 2: 1024x1024: device {device_us:.2f} us (20 launches in a "
          f"CUDA graph, 50 replays), floor {floor_us:.2f} us (empty kernel, "
          f"same grid and block), bound {bound['bound_us']:.2f} us "
          f"({bound['bound_by']}; {bound['popc_us']:.2f} us as popcounts); per "
          f"eager call {call_us:.1f} us, plain {plain_us:.1f} us (CUDA events, "
          f"plain/kernel/kernel/plain); host {host:.1f} us per call (median "
          f"of 3 x 1000 unsynchronised calls)", flush=True)

    # where the work and not the launch sets the time
    big = cases["8192x8192"]
    big_us = graph_us(lambda: hamming_top2(*big), launches=5, replays=10)
    big_floor = graph_us(lambda: launch_empty(8192, 8192))
    big_plain = event_us(lambda: hamming_top2_plain(*big), iters=3)
    big_b = hamming_top2_bound(8192, 8192)
    big_bound = big_b["bound_us"]
    print(f"phase 2: 8192x8192: device {big_us:.1f} us, bound {big_bound:.1f} "
          f"us ({big_b['bound_by']}; {big_bound / big_us:.1%} of the bound "
          f"reached; {big_b['popc_us']:.1f} us as popcounts), floor "
          f"{big_floor:.2f} us, plain {big_plain:.0f} us", flush=True)
    return {
        "name": "hamming_top2",
        "route": "cuda",
        "source": "aslam_tpu_torch/csrc/hamming_top2.cu",
        "replaces": "aslam_tpu/ops/pallas_kernels.py:57",
        "max_abs_err": err,
        "ms": call_us / 1e3,
        "plain_ms": plain_us / 1e3,
        "device_ms": device_us / 1e3,
        "floor_ms": floor_us / 1e3,
        "host_ms": host / 1e3,
        "bound_ms": bound["bound_us"] / 1e3,
        "bound_by": "operations" if bound["bound_by"] == "mma" else "bytes",
        "library_ms": None,       # no single PyTorch call computes this function
        "device_ms_8192": big_us / 1e3,
        "bound_ms_8192": big_bound / 1e3,
    }


def phase2b_pose_ba_vs_plain(dev):
    """The motion-only BA kernel against its plain version on the card, at
    the cases of tests/test_torch_cuda.py (`bench_pose_ba.CASES`) and at B =
    16 lanes (each the bits of its lane alone), then its times at one VO
    frame's N = 1024 edges and at B = 16 x 1024.  -> the `pose_only_ba`
    entry of the kernels line, its launches apart."""
    from aslam_tpu_torch.config import BAConfig
    from aslam_tpu_torch.kernels import bench_pose_ba as PB
    from aslam_tpu_torch.ops import ba

    cam = PB.camera()
    err, ties = {}, 0
    for case in PB.CASES:
        args, cfg, prior = PB.pose_ba_case(case, dev)
        out = ba.pose_only_ba(*args, cam, cfg, prior)
        ref = ba.pose_only_ba_plain(*args, cam, cfg, prior)
        torch.cuda.synchronize()
        got = PB.check_against_plain(out, ref, args, cam, cfg, prior)
        err[case] = got["dT"]
        ties += got["near_ties"]
    cfg = BAConfig()
    lanes, batch = PB.pose_ba_batch(dev)
    out = ba.pose_only_ba(*batch, cam, cfg)
    for k, lane in enumerate(lanes):
        if not all(PB.same_bits(x, y[k])
                   for x, y in zip(ba.pose_only_ba(*lane, cam, cfg), out)):
            raise AssertionError(f"pose_ba: lane {k} of B = 16 differs from "
                                 f"the same problem alone")
    got = PB.check_against_plain(out, ba.pose_only_ba_plain(*batch, cam, cfg),
                                 batch, cam, cfg, 0.0)
    err["B=16"] = got["dT"]
    ties += got["near_ties"]
    print(f"phase 2b: pose_only_ba kernel == plain (T to 1e-5, chi2 to rtol "
          f"1e-4 / atol 1e-3, inliers exactly but {ties} near-tie flags) on "
          f"{len(err)} cases, max |dT| "
          + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
          + f"; B = 16 lanes == 16 single calls bit for bit", flush=True)

    args, cfg, _ = PB.pose_ba_case("vo_frame_1024", dev)
    t1 = PB.timings(args, cam, cfg)
    t16 = PB.timings(batch, cam, cfg)
    for name, t in (("N = 1024 (a VO frame)", t1), ("B = 16 x 1024", t16)):
        print(f"phase 2b: {name}: device {t['device_us']:.1f} us (20 launches "
              f"in a CUDA graph, 10 replays), bound {t['bound_us']:.3f} us "
              f"({t['bound_by']}); per eager call {t['eager_us']:.1f} us, "
              f"plain {t['plain_us'] / 1e3:.1f} ms (CUDA events, "
              f"plain/kernel/kernel/plain); host {t['host_us']:.1f} us per "
              f"call (median of 3 x 200 unsynchronised calls)", flush=True)
    return {
        "name": "pose_only_ba",
        "route": "cuda",
        "source": "aslam_tpu_torch/csrc/pose_ba.cu",
        "replaces": "aslam_tpu/ops/ba.py:100",
        "max_abs_err": max(err.values()),
        "ms": t1["eager_us"] / 1e3,
        "plain_ms": t1["plain_us"] / 1e3,
        "device_ms": t1["device_us"] / 1e3,
        "host_ms": t1["host_us"] / 1e3,
        "bound_ms": t1["bound_us"] / 1e3,
        "bound_by": t1["bound_by"],
        "library_ms": None,       # no single PyTorch call computes motion-only BA
        "device_ms_b16": t16["device_us"] / 1e3,
        "ms_b16": t16["eager_us"] / 1e3,
        "plain_ms_b16": t16["plain_us"] / 1e3,
        "bound_ms_b16": t16["bound_us"] / 1e3,
    }


def _check_run(mode, poses, n_matches, launches, gt_poses, seconds, card):
    from aslam_tpu_torch.utils import trajectory

    poses = np.asarray(poses)
    if not np.isfinite(poses).all():
        raise AssertionError(f"{mode}: non-finite poses")
    n_tracked = len(poses) - 1
    if launches != n_tracked:
        raise AssertionError(f"{mode}: {launches} hamming_top2 launches for "
                             f"{n_tracked} tracked frames")
    pose = _pose_launches(mode, n_tracked)      # one motion-only BA a frame
    if min(n_matches) < MIN_MATCHES:
        raise AssertionError(f"{mode}: a frame had {min(n_matches)} matches")
    ate = trajectory.ate_rmse(trajectory.camera_centers(poses),
                              trajectory.camera_centers(gt_poses))
    if not (ate < 0.01 and ate <= 1.5 * JAX_ATE_M):
        raise AssertionError(f"{mode}: ATE {ate:.5f} m vs JAX {JAX_ATE_M:.5f} m")
    print(f"phase 3: {mode}: {len(poses)} frames, ATE {ate * 100:.3f} cm "
          f"(JAX {JAX_ATE_M * 100:.3f} cm), min matches {min(n_matches)}, "
          f"{launches} hamming_top2 and {pose} pose_only_ba launches, "
          f"{len(poses) / seconds:.2f} fps [{card}]", flush=True)
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
    zero_launches()
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
    zero_launches()
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
    return launches_stream + launches_seq, (cfg, imgs_u8, depths_u16, gt)


def _slam_run(mode, cfg, dev, imgs, deps, chunk=None, sync_every=129):
    """One DeviceSlam run with every counter zeroed just before it ->
    (DeviceSlam, traj, stats, counts, seconds)."""
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.device_slam import DeviceSlam
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.ops.lba import local_ba
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    torch.cuda.synchronize()
    zero_launches()
    read_host.count = local_ba.runs = 0
    t0 = time.perf_counter()
    slam = DeviceSlam(cfg, dev, seed=0, sync_every=sync_every)
    if chunk is None:
        for i in range(len(imgs)):
            slam.process(imgs[i], deps[i], t=0.033 * i)
    else:
        for c0 in range(0, len(imgs), chunk):
            slam.process_chunk(imgs[c0:c0 + chunk], deps[c0:c0 + chunk],
                               ts=[0.033 * i for i in range(c0, c0 + chunk)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    traj, stats = slam.finish()
    # with loop closing, finish() runs the cadence once more and reads
    counts = {"launches": hamming_top2.launches, "reads": read_host.count,
              "lba": local_ba.runs, "pose_ba": pose_only_ba_kernel.launches}
    return slam, traj, stats, counts, seconds


def _check_slam(mode, slam, traj, stats, counts, seconds, gt, card,
                phase=4, jax_ate=(JAX_SLAM_ATE_M, JAX_SLAM_ATE_REBUILT_M),
                pose_per_frame=2):
    """`pose_per_frame`: motion-only BAs a tracked frame, 2 with the RBA
    odometry (`rba_step`, then `track_local_map`), 1 with GICP's."""
    from aslam_tpu_torch.utils import trajectory

    if not np.isfinite(traj).all():
        raise AssertionError(f"{mode}: non-finite poses")
    n_tracked = len(traj) - 1
    if counts["launches"] != n_tracked:
        raise AssertionError(f"{mode}: {counts['launches']} hamming_top2 "
                             f"launches for {n_tracked} tracked frames")
    _pose_launches(mode, pose_per_frame * n_tracked, counts["pose_ba"])
    n_kfs = int(slam.state.n_kfs)
    if slam.kfs_mapped != n_kfs:
        raise AssertionError(f"{mode}: {slam.kfs_mapped} KFs mapped of {n_kfs}")
    inserted = int(stats[:, 6].sum())
    ate = trajectory.ate_rmse(trajectory.camera_centers(traj),
                              trajectory.camera_centers(gt))
    ate_r = trajectory.ate_rmse(
        trajectory.camera_centers(slam.rebuilt_trajectory()),
        trajectory.camera_centers(gt))
    m = slam.state.m
    culled = len(slam.culled_registry())
    print(f"phase {phase}: {mode}: {len(traj)} frames, ATE {ate * 100:.3f} cm, "
          f"rebuilt {ate_r * 100:.3f} cm (JAX {jax_ate[0] * 100:.3f} / "
          f"{jax_ate[1] * 100:.3f} cm); {inserted + 1} KFs "
          f"inserted, {n_kfs} live, {culled} culled; "
          f"{int(m.lm_valid.sum())} landmarks live of "
          f"{slam.state.next_lm.item()} created; {counts['lba']} local BAs; "
          f"{counts['launches']} hamming_top2 and {counts['pose_ba']} "
          f"pose_only_ba launches; {counts['reads']} host reads "
          f"({counts['reads'] / n_tracked:.2f} per tracked frame); "
          f"min tracked {int(stats[:, 0].min())}; "
          f"{len(traj) / seconds:.2f} fps [{card}]", flush=True)
    return ate, ate_r, inserted


def _gate_slam_ate(mode, ate, ate_r, jax_ate):
    for name, a, ref in (("raw", ate, jax_ate[0]), ("rebuilt", ate_r, jax_ate[1])):
        if not (a < 0.03 and a <= 1.5 * ref):
            raise AssertionError(f"{mode}: {name} ATE {a:.5f} m vs JAX "
                                 f"{ref:.5f} m")


def phase4_slam(dev, card, walk):
    from aslam_tpu_torch.profile_slam import bench_config2

    cfg = bench_config2()
    imgs, deps, gt = walk

    # warm-up: allocator, cuBLAS / cuSOLVER handles, one local BA
    _slam_run("warm-up", cfg, dev, imgs[:12], deps[:12], chunk=12)

    torch.cuda.reset_peak_memory_stats()
    chunked = _slam_run("chunked", cfg, dev, imgs, deps, chunk=N_SLAM // 2)
    peak = torch.cuda.max_memory_allocated()
    ate, ate_r, inserted = _check_slam(
        f"process_chunk 2x{N_SLAM // 2}", *chunked, gt, card)
    if inserted < 3 or chunked[3]["lba"] < 1:
        raise AssertionError(f"chunked: {inserted} KFs inserted, "
                             f"{chunked[3]['lba']} local BAs")
    _gate_slam_ate("chunked", ate, ate_r,
                   (JAX_SLAM_ATE_M, JAX_SLAM_ATE_REBUILT_M))

    # a second run of the same 64 frames in this call: the same bits
    again = _slam_run("chunked again", cfg, dev, imgs, deps, chunk=N_SLAM // 2)
    same = (np.array_equal(again[1], chunked[1])
            and np.array_equal(again[0].rebuilt_trajectory(),
                               chunked[0].rebuilt_trajectory())
            and torch.equal(again[0].state.m.kf_id, chunked[0].state.m.kf_id)
            and again[3] == chunked[3])
    if not same:
        raise AssertionError(
            f"a second chunked run differs: max |dT| "
            f"{np.abs(again[1] - chunked[1]).max()}, counts {again[3]} vs "
            f"{chunked[3]}")
    _pose_launches("chunked again", again[3]["pose_ba"])
    print(f"phase 4: a second process_chunk 2x{N_SLAM // 2} run in this "
          f"call: bit-identical poses, rebuilt poses and keyframe ids (max "
          f"|dT| 0.0), {again[3]['launches']} hamming_top2 and "
          f"{again[3]['pose_ba']} pose_only_ba launches, "
          f"{N_SLAM / again[4]:.2f} fps [{card}]", flush=True)

    stream = _slam_run("stream", cfg, dev, imgs[:N_STREAM], deps[:N_STREAM])
    _check_slam(f"process x{N_STREAM}", *stream, gt[:N_STREAM], card)
    d = np.abs(stream[1] - chunked[1][:N_STREAM]).max()
    kfs_s = int(stream[0].state.n_kfs)
    kfs_c = int(chunked[2][N_STREAM - 2, 7])
    if not (d < 1e-3 and kfs_s == kfs_c):
        raise AssertionError(f"stream vs chunked: max |dT| {d}, "
                             f"{kfs_s} vs {kfs_c} KFs")
    print(f"phase 4: stream == chunked over {N_STREAM} frames: max |dT| "
          f"{d:.2e}, {kfs_s} KFs; peak device memory "
          f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated, "
          f"chunked run) [{card}]", flush=True)
    return (chunked[3]["launches"] + again[3]["launches"]
            + stream[3]["launches"])


def _ricp_run(policy, cfg, dev, imgs_d, depths_d):
    """The ADAPTIVE_RICP odometry over a recorded sequence, frame pair by
    frame pair (`make_frame`, then `policy`), with every counter zeroed just
    before -> (poses [T,4,4], results per tracked frame, counts, seconds)."""
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import make_frame, with_pose
    from aslam_tpu_torch.models.odometry import ricp_step
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    zero_launches()
    read_host.count = 0
    ricp_step.escalated = ricp_step.converged = 0
    t0 = time.perf_counter()
    grid = init_grid_thresholds(cfg.extractor, dev)
    prev, poses, results = None, [], []
    for i in range(imgs_d.shape[0]):
        f, grid = make_frame(imgs_d[i], depths_d[i], cfg, grid)
        if prev is not None:
            res = policy(prev, f, gen, cfg)
            f = with_pose(f, res.T_cw2)
            results.append(res)
        prev = f
        poses.append(f.T_cw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"launches": hamming_top2.launches, "reads": read_host.count,
              "escalated": ricp_step.escalated,
              "converged": ricp_step.converged,
              "pose_ba": pose_only_ba_kernel.launches}
    return torch.stack(poses).cpu().numpy(), results, counts, seconds


def phase5_config3(dev, card, vo_frames, walk):
    import dataclasses

    from aslam_tpu_torch.models.odometry import (_escalation, ricp_fused,
                                                 ricp_step)
    from aslam_tpu_torch.profile_slam import bench_config3
    from aslam_tpu_torch.utils import trajectory

    # (a) the odometry alone, on phase 3's frames
    cfg_vo, imgs_u8, depths_u16, gt = vo_frames
    imgs_d = torch.from_numpy(imgs_u8).to(dev)
    depths_d = torch.from_numpy(depths_u16).to(dev)
    base = cfg_vo.replace(use_gicp=True)
    forced = base.replace(icp=dataclasses.replace(
        base.icp, escalate_min_inliers=10**6))
    n_tracked = imgs_d.shape[0] - 1
    launches = 0
    _ricp_run(ricp_fused, forced, dev, imgs_d[:4], depths_d[:4])    # warm-up
    for name, cfg in (("forced", forced), ("default", base)):
        poses = {}
        for policy in (ricp_step, ricp_fused):
            mode = f"{policy.__name__} ({name} escalation)"
            poses[policy], results, counts, seconds = _ricp_run(
                policy, cfg, dev, imgs_d, depths_d)
            launches += counts["launches"]
            if not np.isfinite(poses[policy]).all():
                raise AssertionError(f"{mode}: non-finite poses")
            if counts["launches"] != n_tracked:
                raise AssertionError(f"{mode}: {counts['launches']} hamming_top2 "
                                     f"launches for {n_tracked} tracked frames")
            # the RICP odometry runs no motion-only BA
            _pose_launches(mode, 0, counts["pose_ba"])
            # what the predicate said on each frame (read after the run)
            n_esc = sum(int(_escalation(r, cfg)[0]) for r in results)
            if policy is ricp_step and (
                    counts["escalated"] != n_esc
                    or counts["reads"] != n_tracked + counts["escalated"]):
                raise AssertionError(f"{mode}: counted {counts}")
            if policy is ricp_fused and counts["reads"] != 0:
                raise AssertionError(f"{mode}: {counts['reads']} host reads")
            if name == "forced" and (n_esc != n_tracked or (
                    policy is ricp_step and counts["converged"] != n_tracked)):
                raise AssertionError(f"{mode}: {n_esc} frames escalated, "
                                     f"{counts['converged']} converged")
            if min(int(r.n_matches) for r in results) < MIN_MATCHES:
                raise AssertionError(f"{mode}: a frame had too few matches")
            ate = trajectory.ate_rmse(trajectory.camera_centers(poses[policy]),
                                      trajectory.camera_centers(gt))
            ref = JAX_RICP_ATE_M[name]
            if not (ate < 0.01 and ate <= 1.5 * ref):
                raise AssertionError(f"{mode}: ATE {ate:.5f} m vs JAX {ref:.5f} m")
            conv = (f"{counts['converged']} converged"
                    if policy is ricp_step else "convergence not read")
            print(f"phase 5: {mode}: {len(poses[policy])} frames, ATE "
                  f"{ate * 100:.3f} cm (JAX {ref * 100:.3f} cm), {n_esc} of "
                  f"{n_tracked} frames escalated, {conv}, "
                  f"{counts['launches']} kernel launches, {counts['reads']} "
                  f"host reads ({counts['reads'] / n_tracked:.2f} per tracked "
                  f"frame), {len(poses[policy]) / seconds:.2f} fps [{card}]",
                  flush=True)
        d = np.abs(poses[ricp_fused] - poses[ricp_step]).max()
        if not d < 1e-5:
            raise AssertionError(f"ricp_fused vs ricp_step ({name}): max |dT| {d}")
        print(f"phase 5: ricp_fused == ricp_step ({name} escalation): max |dT| "
              f"{d:.2e} (tolerance 1e-5) [{card}]", flush=True)

    # (b) the SLAM engine with the config-3 odometry
    imgs, deps, gt_walk = walk
    run = _slam_run("config 3", bench_config3(), dev, imgs, deps,
                    chunk=N_SLAM // 2)
    ate, ate_r, inserted = _check_slam(
        f"config 3, process_chunk 2x{N_SLAM // 2}", *run, gt_walk, card,
        phase=5, jax_ate=JAX_SLAM3_ATE_M, pose_per_frame=1)
    if inserted < 3 or run[3]["lba"] < 1:
        raise AssertionError(f"config 3: {inserted} KFs inserted, "
                             f"{run[3]['lba']} local BAs")
    _gate_slam_ate("config 3", ate, ate_r, JAX_SLAM3_ATE_M)
    return launches + run[3]["launches"]


def phase6_loop_closing(dev, card, walk):
    """-> (kernel launches, phase 6(b)'s looped-map run)."""
    from aslam_tpu_torch.profile_slam import bench_config2

    cfg = bench_config2(loop_closing=True)

    # (a) the engine with the sync cadence serving loop closing
    imgs, deps, gt = walk
    torch.cuda.reset_peak_memory_stats()
    run = _slam_run("loop closing", cfg, dev, imgs, deps, chunk=N_SLAM // 2,
                    sync_every=16)
    slam, counts = run[0], run[3]
    ate, ate_r, inserted = _check_slam(
        f"loop closing, process_chunk 2x{N_SLAM // 2}", *run, gt, card,
        phase=6, jax_ate=JAX_SLAM_LOOP_ATE_M)
    _gate_slam_ate("loop closing", ate, ate_r, JAX_SLAM_LOOP_ATE_M)
    lc = slam.loop_closing
    in_db = int(lc.db.kf_in_db.sum())
    if len(slam.sync_reads) < 3 or in_db != slam.last_n_kfs or in_db < 4:
        raise AssertionError(f"loop closing: syncs {slam.sync_reads}, "
                             f"{in_db} KFs in the database, "
                             f"{slam.last_n_kfs} live")
    print(f"phase 6: sync cadence ran {len(slam.sync_reads)} times, host reads "
          f"per sync {slam.sync_reads} (ring, packed query, verifications); "
          f"{in_db} KFs in the database of {lc.vocab.n_words} words; "
          f"{len(lc.loops)} loops closed, {len(lc.consistent_revisits)} "
          f"consistent revisits; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]",
          flush=True)

    # (b) a loop to close, at full capacities
    loop6 = _run_looped_map(cfg, dev)
    m, lc, times, chi2 = (loop6[k] for k in ("m", "lc", "times", "chi2"))
    q, before, after = _gate_loop(loop6, "loop closing")
    quiet = [t for t, closed in times[1:] if not closed]
    closing = [t for t, closed in times if closed]
    print(f"phase 6: looped map ({N_LOOP_KFS} KFs, up to {loop6['n_feat']} "
          f"features each, {int(m.lm_valid.sum())} landmarks; M = "
          f"{m.kf_lm.shape[1]}, L = {m.lm_pos.shape[0]}, K = "
          f"{m.kf_valid.shape[0]}): loops "
          f"{lc.loops}, drift at KF {q} {before * 100:.2f} -> "
          f"{after * 100:.2f} cm, map_chi2 around the post-loop GBA "
          f"{chi2[0]:.4g} -> {chi2[1]:.4g} "
          f"({1e3 * loop6['gba_s'][0]:.1f} ms); "
          f"{loop6['reads']} host reads in "
          f"{len(times)} syncs; ms per sync without a correction "
          f"{1e3 * sum(quiet) / max(len(quiet), 1):.1f}, with one "
          f"{1e3 * sum(closing) / max(len(closing), 1):.1f} [{card}]",
          flush=True)
    return counts["launches"], loop6


def _run_looped_map(cfg, dev):
    """The looped map at full capacities (24 keyframes out and back with
    drifted poses) through `LoopClosing.process_keyframes_batch` in windows
    of four, as the map stood when each window's last keyframe came in,
    with `map_chi2` and the synchronised time around each post-loop GBA ->
    dict of the final map, the LoopClosing, the true and drifted poses, the
    (seconds, closed) of each sync, the chi2 pairs, the GBA seconds and the
    host reads."""
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.loopclosing import LoopClosing
    from aslam_tpu_torch.ops import global_ba
    from aslam_tpu_torch.profile_slam import looped_map

    m, T_true, T_est, _ = looped_map(cfg, dev, seed=0, n_kfs=N_LOOP_KFS,
                                     n_pts=N_LOOP_PTS)
    n_feat = int(m.kf_kp_valid.sum(1).max())
    lc = LoopClosing(cfg, dev)
    chi2, gba_s = [], []
    post_gba = lc._post_loop_gba

    def measured_gba(mm):
        chi2.append(float(global_ba.map_chi2(mm, cfg.camera, cfg.ba)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = post_gba(mm)
        torch.cuda.synchronize()
        gba_s.append(time.perf_counter() - t0)
        chi2.append(float(global_ba.map_chi2(out, cfg.camera, cfg.ba)))
        return out

    lc._post_loop_gba = measured_gba
    K = m.kf_valid.shape[0]
    arange = torch.arange(K, device=dev)
    torch.cuda.synchronize()
    read_host.count = 0
    times = []
    for lo in range(0, N_LOOP_KFS, 4):
        ids = list(range(lo, lo + 4))
        # the map as it stood when the window's last keyframe came in
        m_k = m._replace(kf_valid=m.kf_valid & (arange < lo + 4))
        t0 = time.perf_counter()
        n_loops = len(lc.loops)
        out = lc.process_keyframes_batch(m_k, ids, ids, n_live=lo + 4)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0, len(lc.loops) > n_loops))
        m = out._replace(kf_valid=m.kf_valid)
    return dict(m=m, lc=lc, T_true=T_true, T_est=T_est, times=times,
                chi2=chi2, gba_s=gba_s, reads=read_host.count, n_feat=n_feat)


def _gate_loop(run, what):
    """Phase 6(b)'s gates on a looped-map run: a finite map, a loop between
    the return leg and the outbound leg, the drift at the closing keyframe
    cut by >= 20% -> (closing slot, drift before, after) in metres."""
    m, lc, T_true, T_est = (run[k] for k in ("m", "lc", "T_true", "T_est"))
    if not torch.isfinite(m.kf_T_cw).all() or not torch.isfinite(m.lm_pos).all():
        raise AssertionError(f"{what}: non-finite map")
    if not lc.loops:
        raise AssertionError(f"{what}: no loop closed on the looped map")
    q, c = lc.loops[0]
    if not (q >= N_LOOP_KFS // 2 and c < N_LOOP_KFS // 2):
        raise AssertionError(f"{what}: loop {q} <-> {c} does not join "
                             f"the return leg to the outbound leg")
    T_after = m.kf_T_cw.cpu().numpy()
    before = float(np.linalg.norm(T_est[q][:3, 3] - T_true[q][:3, 3]))
    after = float(np.linalg.norm(T_after[q][:3, 3] - T_true[q][:3, 3]))
    if not after < 0.8 * before:
        raise AssertionError(f"{what}: drift at KF {q} {before:.4f} -> "
                             f"{after:.4f} m")
    return q, before, after


def _cli(root, out, cfg, *flags):
    """One run of the CLI in process, the launch counts zeroed just before ->
    (Metrics, engine, hamming_top2 launches, seconds, the loader's line,
    pose_only_ba launches)."""
    from aslam_tpu_torch import main as cli
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    torch.cuda.synchronize()
    zero_launches()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        metrics, engine = cli.run(
            ["--dataset", root, "--camera", "bench", "--out-dir", out, *flags],
            base_config=cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    loader = [ln for ln in printed.getvalue().splitlines()
              if ln.startswith("TumSequence")]
    return (metrics, engine, hamming_top2.launches, seconds, loader[0],
            pose_only_ba_kernel.launches)


def _file_centers(mode, path, n):
    """Camera centres [n,3] of a TUM trajectory file with one finite row per
    frame and unit quaternions."""
    from aslam_tpu_torch.utils import trajectory

    ts, xyz, quat = trajectory.load_tum_trajectory(path)
    if not (len(ts) == n and np.isfinite(xyz).all() and np.isfinite(quat).all()
            and np.allclose(np.linalg.norm(quat, axis=1), 1.0, atol=1e-4)):
        raise AssertionError(f"{mode}: {path} holds {len(ts)} rows for {n} "
                             f"frames, or a row that is no pose")
    return xyz


def _cli_line(metrics, launches, seconds, n):
    t = metrics.summary()["timers"]
    return (f"{launches} kernel launches; load {t['load']['mean_ms']:.1f} ms, "
            f"track {t['track']['total_s'] * 1e3 / n:.1f} ms per frame; "
            f"{n / seconds:.2f} fps")


def _mib(prefix, *suffixes):
    return sum(os.path.getsize(prefix + s) for s in suffixes
               if os.path.exists(prefix + s)) / 2**20


def _pose_error(T, T_true):
    """(metres between the camera centres, radians between the rotations)."""
    d = np.asarray(T, np.float64) @ np.linalg.inv(np.asarray(T_true, np.float64))
    return (float(np.linalg.norm(d[:3, 3])),
            float(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))))


def phase7_host_shell(dev, card, walk):
    from aslam_tpu_torch import main as cli
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.device_slam import DeviceSlam
    from aslam_tpu_torch.native import loader as native_loader
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.profile_slam import bench_config3
    from aslam_tpu_torch.utils import dataset, trajectory

    cfg = bench_config3(loop_closing=True)
    cam = cfg.camera
    cli.CAMERAS["bench"] = cam
    imgs, deps, gt = walk
    n = len(imgs)
    ts = [0.033 * i for i in range(n)]
    gt_c = trajectory.camera_centers(gt)
    launches = 0
    with tempfile.TemporaryDirectory(prefix="aslam_smoke_") as tmp:
        # (a) the sequence on disk, and back
        root = os.path.join(tmp, "walk")
        t0 = time.perf_counter()
        dataset.write_tum_sequence(root, imgs, deps, ts)
        write_ms = 1e3 * (time.perf_counter() - t0) / n
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        seq = dataset.TumSequence(root, depth_factor=cam.depth_factor,
                                  lookahead=0, verbose=False)
        decoders = {seq.decoder: lambda i: seq[i][1:]}
        if native_loader.available():
            decoders["zlib"] = lambda i: (
                dataset.decode_png_zlib(seq.assoc.rgb_paths[i]).astype(np.float32),
                dataset.decode_png_zlib(seq.assoc.depth_paths[i])
                .astype(np.float32) * cam.depth_factor)
        decode_ms = {}
        for name, decode in decoders.items():
            t0 = time.perf_counter()
            pairs = [decode(i) for i in range(0, n, 4)]
            decode_ms[name] = 1e3 * (time.perf_counter() - t0) / len(pairs)
            for i, (g, d) in zip(range(0, n, 4), pairs):
                if not (np.array_equal(g, imgs[i].astype(np.float32))
                        and np.array_equal(d, deps[i].astype(np.float32)
                                           * np.float32(cam.depth_factor))):
                    raise AssertionError(f"{name} decoder: frame {i} differs "
                                         f"from what was written")
        seq.close()
        print(f"phase 7: TUM directory of {n} frame pairs, {size / 2**20:.1f} "
              f"MiB, written at {write_ms:.1f} ms a pair; PNG decoder in use: "
              f"{seq.decoder}; decode ms per frame pair "
              + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
              + f" (one thread, {len(pairs)} pairs, equal to the frames "
              f"written) [{card}]", flush=True)

        # (b) the CLI over it: VO, the device engine, the host engine
        out = os.path.join(tmp, "vo")
        metrics, vo, k, seconds, loader, pose = _cli(root, out, cfg, "--mode",
                                                     "vo")
        _pose_launches("main --mode vo", n - 1, pose)
        ate = trajectory.ate_rmse(
            _file_centers("vo", out + "/CameraTrajectory.txt", n), gt_c)
        ref = JAX_CLI_ATE_M["vo"]
        if not (ate < 0.01 and ate <= 1.5 * ref and k == n - 1
                and os.path.exists(out + "/metrics.json")):
            raise AssertionError(f"main --mode vo: ATE {ate:.5f} m vs JAX "
                                 f"{ref:.5f} m, {k} launches")
        launches += k
        print(f"phase 7: {loader} [{card}]", flush=True)
        print(f"phase 7: main --mode vo: {n} frames, ATE {ate * 100:.3f} cm "
              f"(JAX {ref * 100:.3f} cm); {metrics.counters['host_reads']} "
              f"host reads; {_cli_line(metrics, k, seconds, n)} "
              f"[{card}]", flush=True)

        out = os.path.join(tmp, "device")
        metrics, slam, k, seconds, _, pose = _cli(
            root, out, cfg, "--mode", "slam+gicp", "--engine", "device",
            "--chunk", str(n // 2))
        _pose_launches("main --engine device", n - 1, pose)
        ate = trajectory.ate_rmse(
            _file_centers("device", out + "/CameraTrajectory.txt", n), gt_c)
        ate_r = trajectory.ate_rmse(
            trajectory.camera_centers(slam.rebuilt_trajectory()), gt_c)
        ref = JAX_CLI_ATE_M["device"]
        _gate_slam_ate("main --engine device", ate, ate_r, ref)
        n_kfs = metrics.counters["keyframes"]
        if not (k == n - 1 and n_kfs >= 4 and slam.kfs_mapped == slam.last_n_kfs
                and len(metrics.timers["track"]) == 2):
            raise AssertionError(f"main --engine device: {k} launches, "
                                 f"{n_kfs} keyframes")
        launches += k
        reads = metrics.counters["host_reads"]
        ate_device = ate
        print(f"phase 7: main --mode slam+gicp --engine device --chunk "
              f"{n // 2}: {n} frames, ATE {ate * 100:.3f} cm, rebuilt "
              f"{ate_r * 100:.3f} cm (JAX {ref[0] * 100:.3f} / "
              f"{ref[1] * 100:.3f} cm); {n_kfs} keyframes; {reads} host reads "
              f"({reads / (n - 1):.2f} per tracked frame, the export's "
              f"included); {_cli_line(metrics, k, seconds, n)} "
              f"[{card}]", flush=True)

        out = os.path.join(tmp, "host")
        ckpt = os.path.join(tmp, "map")
        metrics, sys1, k, seconds, _, pose = _cli(
            root, out, cfg, "--mode", "slam+gicp", "--engine", "host",
            "--checkpoint", ckpt)
        _pose_launches("main --engine host", n - 1, pose)
        for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt",
                     "Histogram.csv", "metrics.json"):
            if not os.path.exists(os.path.join(out, name)):
                raise AssertionError(f"main --engine host wrote no {name}")
        for suffix in (".npz", ".meta.json", ".vocab.npz", ".loopdb.npz"):
            if not os.path.exists(ckpt + suffix):
                raise AssertionError(f"--checkpoint wrote no {ckpt + suffix}")
        tr = sys1.tracking
        ate = trajectory.ate_rmse(trajectory.camera_centers(tr.poses), gt_c)
        ate_r = trajectory.ate_rmse(
            _file_centers("host", out + "/CameraTrajectory.txt", n), gt_c)
        ref = JAX_CLI_ATE_M["host"]
        _gate_slam_ate("main --engine host", ate, ate_r, ref)
        n_kfs = metrics.counters["keyframes"]
        kf_rows = np.loadtxt(out + "/KeyFrameTrajectory.txt").reshape(-1, 8)
        min_tracked = min(s["n_tracked"] for s in tr.stats)
        if not (k == n - 1 and n_kfs >= 4 and len(kf_rows) == tr.n_kfs
                and min_tracked >= cfg.tracking.min_matches_tracked
                and tr.state == "OK"):
            raise AssertionError(
                f"main --engine host: {k} launches, {n_kfs} keyframes, "
                f"{len(kf_rows)} rows for {tr.n_kfs} live, min tracked "
                f"{min_tracked}, state {tr.state}")
        launches += k
        reads = metrics.counters["host_reads_tracking"]
        ck_mib = _mib(ckpt, ".npz", ".vocab.npz", ".loopdb.npz")
        print(f"phase 7: main --mode slam+gicp --engine host --checkpoint: "
              f"{n} frames, ATE {ate * 100:.3f} cm, rebuilt (the file) "
              f"{ate_r * 100:.3f} cm (JAX {ref[0] * 100:.3f} / "
              f"{ref[1] * 100:.3f} cm); {n_kfs} keyframes, {tr.n_kfs} live, "
              f"{len(sys1.local_mapping.culled)} culled; {reads} host reads in "
              f"the frame loop: 1 per tracked frame and "
              f"{(reads - (n - 1)) / n_kfs:.2f} per keyframe; min tracked "
              f"{min_tracked}; checkpoint {ck_mib:.1f} MiB; "
              f"{_cli_line(metrics, k, seconds, n)} [{card}]",
              flush=True)

        # (c) the device engine's session: save, resume, new sequence
        half = n // 2
        whole = _slam_run("uninterrupted", cfg, dev, imgs, deps, chunk=half,
                          sync_every=16)
        launches += whole[3]["launches"]
        _pose_launches("uninterrupted", n - 1, whole[3]["pose_ba"])
        zero_launches()
        first = DeviceSlam(cfg, dev, seed=0, sync_every=16)
        first.process_chunk(imgs[:half], deps[:half], ts=ts[:half])
        torch.cuda.synchronize()
        prefix = os.path.join(tmp, "session")
        t0 = time.perf_counter()
        first.save(prefix)
        save_ms = 1e3 * (time.perf_counter() - t0)
        del first
        t0 = time.perf_counter()
        second = DeviceSlam.resume(prefix, cfg, dev, sync_every=16)
        torch.cuda.synchronize()
        resume_ms = 1e3 * (time.perf_counter() - t0)
        second.process_chunk(imgs[half:], deps[half:], ts=ts[half:])
        traj_r, stats_r = second.finish()
        d = float(np.abs(traj_r - whole[1]).max())
        d_rb = float(np.abs(second.rebuilt_trajectory()
                            - whole[0].rebuilt_trajectory()).max())
        same_kfs = (torch.equal(second.state.m.kf_id, whole[0].state.m.kf_id)
                    and torch.equal(second.state.m.kf_valid,
                                    whole[0].state.m.kf_valid))
        if not (d == 0.0 and d_rb == 0.0 and same_kfs
                and hamming_top2.launches == n - 1
                and second.timestamps == whole[0].timestamps):
            raise AssertionError(
                f"resume: max |dT| {d} ({d_rb} rebuilt) against the "
                f"uninterrupted run, same keyframes: {same_kfs}, "
                f"{hamming_top2.launches} launches")
        launches += hamming_top2.launches
        _pose_launches("save / resume", n - 1)
        mib = _mib(prefix, ".session.npz", ".vocab.npz", ".loopdb.npz")
        print(f"phase 7: DeviceSlam {half} frames, save ({save_ms:.0f} ms, "
              f"{mib:.1f} MiB), resume in a fresh object ({resume_ms:.0f} ms), "
              f"{n - half} more == the uninterrupted {n}: max |dT| {d:.2e}, "
              f"rebuilt {d_rb:.2e} (tolerance 0), the same "
              f"{int(second.state.n_kfs)} keyframe ids; "
              f"{hamming_top2.launches} kernel launches [{card}]", flush=True)

        lc = second.loop_closing
        zero_launches()
        reads0 = read_host.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = second.new_sequence(imgs[RELOC_FRAME], deps[RELOC_FRAME], t=100.0)
        torch.cuda.synchronize()
        reloc_ms = 1e3 * (time.perf_counter() - t0)
        reloc_reads = read_host.count - reads0
        n_bound = int((second.state.last_assoc >= 0).sum())
        e_t, e_r = _pose_error(second.state.last_frame.T_cw.cpu().numpy(),
                               gt[RELOC_FRAME])
        second.process(imgs[RELOC_FRAME + 1], deps[RELOC_FRAME + 1], t=100.033)
        traj_n, stats_n = second.finish()
        e_next = _pose_error(traj_n[-1], gt[RELOC_FRAME + 1])
        if not (ok and len(lc.relocalized) == 1 and n_bound >= 10
                and e_t < 0.02 and e_r < 0.02 and traj_n.shape[0] == n + 2
                and stats_n[-1, 0] >= cfg.tracking.min_matches_tracked
                and e_next[0] < 0.02 and e_next[1] < 0.02
                and hamming_top2.launches == 1):
            raise AssertionError(
                f"new_sequence: anchored {ok}, relocalized {lc.relocalized}, "
                f"{n_bound} bindings, pose error {e_t:.4f} m / {e_r:.4f} rad, "
                f"next frame {e_next}, tracked {stats_n[-1, 0]}")
        launches += hamming_top2.launches
        # bootstrap_track, then the next frame's track_local_map
        _pose_launches("new_sequence", 2)
        print(f"phase 7: DeviceSlam.new_sequence on frame {RELOC_FRAME}: "
              f"relocalized against keyframe slot {lc.relocalized[0]} "
              f"(shipped vocabulary, {int(lc.db.kf_in_db.sum())} keyframes in "
              f"the database), {n_bound} bindings from bootstrap_track, pose "
              f"{e_t * 100:.2f} cm / {e_r:.4f} rad from the truth (gate 2 cm "
              f"/ 0.02 rad), {reloc_ms:.0f} ms, {reloc_reads} host reads; the "
              f"next frame tracked {int(stats_n[-1, 0])} landmarks at "
              f"{e_next[0] * 100:.2f} cm / {e_next[1]:.4f} rad [{card}]",
              flush=True)
        del whole, second

        # (d) the host engine resumed from the checkpoint, a second sequence
        out = os.path.join(tmp, "second")
        metrics, sys2, k, seconds, _, pose = _cli(
            root, out, cfg, "--mode", "slam+gicp", "--engine", "host",
            "--resume", ckpt, "--max-frames", str(N_SECOND))
        # bootstrap_track on the first frame, then one a tracked frame
        _pose_launches("main --resume", N_SECOND, pose)
        xyz = _file_centers("resumed", out + "/CameraTrajectory.txt", N_SECOND)
        ate = trajectory.ate_rmse(xyz, gt_c[:N_SECOND])
        off = float(np.linalg.norm(xyz - gt_c[:N_SECOND], axis=1).max())
        tr = sys2.tracking
        tracked = [s["n_tracked"] for s in tr.stats[1:]]
        faults = [s for s in tr.stats[1:]
                  if s.get("motion_model") or s.get("reacquired")
                  or s.get("relocalized")]
        if not (tr.stats[0] == {"new_sequence": True}
                and len(sys2.loop_closing.relocalized) == 1
                and min(tracked) >= cfg.tracking.min_matches_tracked
                and not faults and tr.state == "OK" and k == N_SECOND - 1
                and ate < 0.03 and off < 0.03
                and tr.kf_counter >= sys1.tracking.kf_counter):
            raise AssertionError(
                f"main --resume: first frame {tr.stats[0]}, relocalized "
                f"{sys2.loop_closing.relocalized}, tracked {tracked}, faults "
                f"{faults}, state {tr.state}, {k} launches, ATE {ate:.4f} m, "
                f"farthest {off:.4f} m")
        launches += k
        print(f"phase 7: main --engine host --resume, the first {N_SECOND} "
              f"frames as a second sequence: NEW_SEQUENCE anchored by "
              f"relocalization against keyframe slot "
              f"{sys2.loop_closing.relocalized[0]}, min tracked "
              f"{min(tracked)} (limit {cfg.tracking.min_matches_tracked}), no "
              f"frame lost; ATE {ate * 100:.3f} cm, farthest {off * 100:.2f} "
              f"cm from the truth in the first map's frame; "
              f"{tr.kf_counter - sys1.tracking.kf_counter} keyframes added to "
              f"{sys1.tracking.kf_counter}; "
              f"{_cli_line(metrics, k, seconds, N_SECOND)} [{card}]",
              flush=True)
    return launches, ate_device


def _events_ms(fn, iters=5):
    """Mean ms per call of `fn` on the card (CUDA events, after one call)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _with_family(cfg, det, des):
    import dataclasses

    return cfg.replace(extractor=dataclasses.replace(
        cfg.extractor, detector=det, descriptor=des))


def _phase8a_card_vs_cpu(dev, card, cfg, img_u8):
    """Every response and descriptor family on the 8 level images of one
    frame, on the card and on the CPU, from the same level images."""
    from aslam_tpu_torch.ops import desc as desc_ops
    from aslam_tpu_torch.ops import detectors, fast, pyramid, select

    ec = cfg.extractor
    levels = pyramid.build_pyramid(torch.from_numpy(img_u8).float(),
                                   ec.n_levels, ec.scale_factor)
    levels_d = [lv.to(dev) for lv in levels]
    factors = torch.tensor([[0.7, 1.0, 1.3], [1.1, 0.9, 1.2], [0.8, 1.0, 1.0]])
    # responses: masks equal except within 1e-3 of the threshold, values to
    # rtol 1e-5
    resp_line = []
    for det in DETECTORS:
        grid = factors * detectors.defaults(det)["threshold"]
        err = flips = n_pos = 0
        for lv, lv_d in zip(levels, levels_d):
            th = fast.threshold_map_from_grid(grid, *lv.shape)
            ref = detectors.response(det, lv, th)
            out = detectors.response(det, lv_d, th.to(dev)).cpu()
            differ = (ref > 0) != (out > 0)
            raw = torch.maximum(ref, out)
            if not bool((torch.abs(raw - th)[differ] <= 1e-3 * th[differ]).all()):
                raise AssertionError(f"{det}: card and CPU masks differ away "
                                     f"from the threshold")
            both = (ref > 0) & (out > 0)
            rel = (torch.abs(out - ref) / torch.clamp(ref.abs(), min=1e-6))[both]
            if rel.numel() and float(rel.max()) > 1e-5:
                raise AssertionError(f"{det}: card vs CPU rel err "
                                     f"{float(rel.max())}")
            err = max(err, float(rel.max()) if rel.numel() else 0.0)
            flips += int(differ.sum())
            n_pos += int(both.sum())
        ths_d = [fast.threshold_map_from_grid(grid.to(dev), *lv_d.shape)
                 for lv_d in levels_d]
        ms = _events_ms(lambda: [detectors.response(det, lv_d, th_d)
                                 for lv_d, th_d in zip(levels_d, ths_d)])
        resp_line.append(f"{det} {n_pos} px, {flips} near-tie flips, rel err "
                         f"{err:.1e}, {ms:.2f} ms")
    print(f"phase 8: responses card vs CPU on 8 levels (masks equal but "
          f"within 1e-3 of the threshold, values to rtol 1e-5; ms per frame "
          f"on the card): " + "; ".join(resp_line) + f" [{card}]", flush=True)

    # descriptors at the FAST keypoints of each level; a row may differ only
    # where the two IC angles steer a sample onto another pixel
    # (`desc.steered_index`), and none on level 0
    kps = []
    for l, lv in enumerate(levels):
        resp = fast.nms_3x3(fast.fast_response(lv, 20.0))
        xy, _, valid = select.grid_topk(resp, ec.cell_px, k_cell=ec.cell_topk,
                                        n_out=max(int(ec.features_per_level[l]), 1))
        kps.append(xy[valid])
    kps_d = [k.to(dev) for k in kps]
    blurs = [pyramid.gaussian_blur(lv) for lv in levels]
    blurs_d = [pyramid.gaussian_blur(lv) for lv in levels_d]
    desc_line = []
    for des in DESCRIPTORS:
        tied = n_rows = 0
        err = 0.0
        for l in range(len(levels)):
            d_c, a_c = desc_ops.describe(des, blurs[l], kps[l])
            d_g, a_g = desc_ops.describe(des, blurs_d[l], kps_d[l])
            # each side's sample indices as that side computes them
            tie = (desc_ops.steered_index(des, a_c)
                   != desc_ops.steered_index(des, a_g).cpu()).any(1)
            d_g = d_g.cpu()
            if desc_ops.is_binary(des):
                bad = (d_c != d_g).any(1)
            else:
                diff = torch.abs(d_c - d_g).amax(1)
                bad = diff > 1e-5
                err = max(err, float(diff[~tie].max()))
            if bool((bad & ~tie).any()) or (l == 0 and bool(bad.any())):
                rows = torch.nonzero(bad & ~tie)[:, 0][:5].tolist()
                raise AssertionError(
                    f"{des}, level {l}: {int(bad.sum())} rows differ between "
                    f"the card and the CPU, {int((bad & ~tie).sum())} of them "
                    f"not on an angle tie: rows {rows}, angles "
                    f"{a_c[rows].tolist()} / {a_g.cpu()[rows].tolist()}, "
                    f"max abs diff {float(torch.abs(d_c - d_g)[rows].max())}")
            tied += int(bad.sum())
            n_rows += len(kps[l])
        ms = _events_ms(lambda: [desc_ops.describe(des, b, k)
                                 for b, k in zip(blurs_d, kps_d)])
        what = "bits" if desc_ops.is_binary(des) else f"max abs err {err:.1e}"
        desc_line.append(f"{des} {n_rows} keypoints, {tied} rows on an angle "
                         f"tie, {what}, {ms:.2f} ms")
    print(f"phase 8: descriptors card vs CPU at the FAST keypoints of 8 levels "
          f"(binary bits equal, SIFT to 1e-5; level 0 all equal; ms per frame "
          f"on the card): " + "; ".join(desc_line) + f" [{card}]", flush=True)


def phase8_families(dev, card, vo_frames, walk):
    from aslam_tpu_torch import main as cli
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import make_frame
    from aslam_tpu_torch.models.vo import VisualOdometry
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.profile_slam import bench_config3
    from aslam_tpu_torch.utils import dataset, trajectory

    cfg_vo, imgs_u8, depths_u16, gt = vo_frames
    # (a) each family, the card against the CPU
    _phase8a_card_vs_cpu(dev, card, cfg_vo, imgs_u8[N_FRAMES // 2])

    # (b) VO over phase 3's frames for four pairs
    imgs_d = torch.from_numpy(imgs_u8).to(dev)
    depths_d = torch.from_numpy(depths_u16).to(dev)
    launches = 0
    for det, des in (("FAST", "ORB"),) + tuple(JAX_FAMILY_ATE_M):
        cfg = _with_family(cfg_vo, det, des)

        def frames():
            grid = init_grid_thresholds(cfg.extractor, dev)
            for i in range(N_FRAMES):
                _, grid = make_frame(imgs_d[i], depths_d[i], cfg, grid)

        frame_ms = _events_ms(frames, iters=1) / N_FRAMES
        if (det, des) == ("FAST", "ORB"):
            print(f"phase 8: FAST+ORB (the default) make frame "
                  f"{frame_ms:.1f} ms per frame [{card}]", flush=True)
            continue
        vo = VisualOdometry(cfg, dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        for i in range(N_FRAMES):
            vo.process(imgs_u8[i], depths_u16[i])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k = hamming_top2.launches
        launches += k
        # one motion-only BA a frame, whatever the matcher
        _pose_launches(f"VO {det}+{des}", N_FRAMES - 1)
        poses = np.asarray(vo.poses)
        ate = trajectory.ate_rmse(trajectory.camera_centers(poses),
                                  trajectory.camera_centers(gt))
        ref = JAX_FAMILY_ATE_M[(det, des)]
        min_inl = min(st["n_inliers"] for st in vo.stats)
        binary = des != "SIFT"
        if not (np.isfinite(poses).all()
                and min_inl >= cfg.ransac.min_inliers
                and k == (N_FRAMES - 1 if binary else 0)
                and ate <= 1.5 * ref):
            raise AssertionError(
                f"{det}+{des}: ATE {ate:.5f} m vs JAX {ref:.5f} m, min "
                f"inliers {min_inl}, {k} hamming_top2 launches")
        print(f"phase 8: VO {det}+{des}: {N_FRAMES} frames, every frame "
              f"tracked (min matches {min(st['n_matches'] for st in vo.stats)}"
              f", min inliers {min_inl}), ATE {ate * 100:.3f} cm (JAX "
              f"{ref * 100:.3f} cm), {k} hamming_top2 launches, make frame "
              f"{frame_ms:.1f} ms per frame, {N_FRAMES / seconds:.2f} fps "
              f"[{card}]", flush=True)

    # (c) and (d): the CLI with GFTT + LATCH on the walk's PNGs, twice
    cfg = bench_config3(loop_closing=True)
    cli.CAMERAS["bench"] = cfg.camera
    imgs, deps, gt_w = walk
    n = len(imgs)
    gt_c = trajectory.camera_centers(gt_w)
    ref = JAX_CLI_FAMILY_ATE_M
    flags = ("--mode", "slam+gicp", "--engine", "device", "--chunk",
             str(n // 2), "--detector", "GFTT", "--descriptor", "LATCH")
    runs = []
    with tempfile.TemporaryDirectory(prefix="aslam_smoke_") as tmp:
        root = os.path.join(tmp, "walk")
        dataset.write_tum_sequence(root, imgs, deps, [0.033 * i for i in range(n)])
        for run in ("first", "second"):
            out = os.path.join(tmp, run)
            metrics, slam, k, seconds, _, pose = _cli(root, out, cfg, *flags)
            launches += k
            _pose_launches("GFTT+LATCH CLI", n - 1, pose)
            ate = trajectory.ate_rmse(
                _file_centers(run, out + "/CameraTrajectory.txt", n), gt_c)
            ate_r = trajectory.ate_rmse(
                trajectory.camera_centers(slam.rebuilt_trajectory()), gt_c)
            _gate_slam_ate("main --detector GFTT --descriptor LATCH", ate,
                           ate_r, ref)
            n_kfs = metrics.counters["keyframes"]
            if not (k == n - 1 and n_kfs >= 4
                    and slam.kfs_mapped == slam.last_n_kfs):
                raise AssertionError(f"GFTT+LATCH CLI: {k} launches, {n_kfs} "
                                     f"keyframes, {slam.kfs_mapped} mapped")
            runs.append((open(out + "/CameraTrajectory.txt").read(),
                         slam.rebuilt_trajectory(), slam.state.m.kf_id.cpu()))
            print(f"phase 8: main {' '.join(flags)} ({run} run): {n} frames, "
                  f"ATE {ate * 100:.3f} cm, rebuilt {ate_r * 100:.3f} cm (JAX "
                  f"{ref[0] * 100:.3f} / {ref[1] * 100:.3f} cm); {n_kfs} "
                  f"keyframes; {_cli_line(metrics, k, seconds, n)} [{card}]",
                  flush=True)
    (f1, rb1, ids1), (f2, rb2, ids2) = runs
    if not (f1 == f2 and np.array_equal(rb1, rb2) and torch.equal(ids1, ids2)):
        raise AssertionError(f"GFTT+LATCH CLI: two runs differ, rebuilt max "
                             f"|dT| {np.abs(rb1 - rb2).max()}")
    print(f"phase 8: the two GFTT+LATCH CLI runs are bit-identical (the "
          f"trajectory files byte for byte, rebuilt poses and keyframe ids) "
          f"[{card}]", flush=True)
    return launches


def _batched_top2_inputs(rng, dev, b, n=1024, m=1024):
    """`top2_inputs` for b lanes, stacked: masks and ties in every lane, one
    lane with no valid target and one with no valid query."""
    from aslam_tpu_torch.kernels.bench_top2 import top2_inputs

    lanes = [top2_inputs(rng, dev, n, m) for _ in range(b)]
    lanes[1][3] = torch.zeros_like(lanes[1][3])
    lanes[2][1] = torch.zeros_like(lanes[2][1])
    return lanes, [torch.stack([lane[k] for lane in lanes]) for k in range(4)]


def _phase9a_kernel(dev, card, kernel):
    """The batched kernel at B = 16: exact against the batched plain version
    and against 16 unbatched calls, then its device time, 16 unbatched
    launches' and the floor, beside the bound x 16.  Adds its numbers to the
    kernel's entry of the kernels line."""
    from aslam_tpu_torch.kernels.bench_top2 import event_us, graph_us
    from aslam_tpu_torch.ops.hamming_top2 import (hamming_top2,
                                                  hamming_top2_bound,
                                                  hamming_top2_plain)

    rng = np.random.default_rng(9)
    lanes, args = _batched_top2_inputs(rng, dev, N_BATCH)
    out = hamming_top2(*args)
    ref = hamming_top2_plain(*args)
    single = [hamming_top2(*lane) for lane in lanes]
    torch.cuda.synchronize()
    err = 0.0
    for k in range(3):
        per_lane = torch.stack([x[k] for x in single])
        for name, y in (("the batched plain version", ref[k]),
                        ("16 unbatched calls", per_lane)):
            if not torch.equal(out[k], y):
                bad = (out[k] != y).nonzero()[:5].tolist()
                raise AssertionError(f"batched hamming_top2 output {k} differs "
                                     f"from {name} at [lane, row] {bad}")
            err = max(err, float((out[k].double() - y.double()).abs().max()))
    del out, ref, single

    def sixteen():
        for lane in lanes:
            hamming_top2(*lane)

    device_us = graph_us(lambda: hamming_top2(*args))
    loop_us = graph_us(sixteen, launches=4)
    floor_us = graph_us(lambda: launch_empty(1024, 1024, N_BATCH))
    call_us = event_us(lambda: hamming_top2(*args))
    plain_us = event_us(lambda: hamming_top2_plain(*args), iters=20)
    bound = hamming_top2_bound(1024, 1024, N_BATCH)
    print(f"phase 9: batched hamming_top2, B = {N_BATCH} x 1024 x 1024 with "
          f"masks and ties: == the batched plain version and == {N_BATCH} "
          f"unbatched calls exactly (tolerance 0, max abs err {err}); device "
          f"{device_us:.2f} us (CUDA graph) against {loop_us:.2f} us for "
          f"{N_BATCH} unbatched launches, floor {floor_us:.2f} us (empty "
          f"kernel, same grid), bound {bound['bound_us']:.3f} us "
          f"({bound['bound_by']}, the 1024 x 1024 bound x {N_BATCH}); per eager "
          f"call {call_us:.1f} us, plain {plain_us:.0f} us [{card}]",
          flush=True)
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    kernel.update({
        "device_ms_b16": device_us / 1e3,
        "unbatched_x16_device_ms": loop_us / 1e3,
        "floor_ms_b16": floor_us / 1e3,
        "ms_b16": call_us / 1e3,
        "plain_ms_b16": plain_us / 1e3,
        "bound_ms_b16": bound["bound_us"] / 1e3,
    })


def _batch_frames(cam):
    """16 frames of each of the 16 rendered sequences of phase 9, as uint8 /
    uint16 [B,F,H,W], and their true poses [B,F,4,4]."""
    from aslam_tpu_torch.utils import synthetic

    seqs = [synthetic.make_sequence(n_frames=N_BATCH_FRAMES, n_points=1500,
                                    cam=cam, seed=50 + b)
            for b in range(N_BATCH)]
    imgs = np.stack([np.clip(s[0], 0, 255).astype(np.uint8) for s in seqs])
    deps = np.stack([np.clip(s[1] / cam.depth_factor, 0, 65535)
                     .astype(np.uint16) for s in seqs])
    return imgs, deps, np.stack([s[2] for s in seqs])


def _lane_ates(traj, gt):
    """ATE of each lane of a [F-1,B,4,4] trajectory (frame 0 at the
    identity) against its [B,F,4,4] truth."""
    from aslam_tpu_torch.utils import trajectory

    return [trajectory.ate_rmse(
        trajectory.camera_centers(np.concatenate([np.eye(4)[None], traj[:, b]])),
        trajectory.camera_centers(gt[b])) for b in range(traj.shape[1])]


def _profiled_step(bvo, img, dep):
    """One batched step under torch.profiler -> (CUDA kernels, device ms,
    wall s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bvo.process(img, dep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels) / 1e3, wall)


def _phase9b_batch_vo(dev, card, cfg):
    """`BatchVisualOdometry` at B = 1, 4 and 16 -> kernel launches."""
    from aslam_tpu_torch.models import odometry
    from aslam_tpu_torch.models.batch_vo import BatchVisualOdometry
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import make_frame
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.ops.orb import unpack_bits

    imgs, deps, gt = _batch_frames(cfg.camera)
    F = N_BATCH_FRAMES
    half = F // 2
    launches = 0
    kernels = {}
    for B in BATCHES:
        # warm-up at this batch's shapes (allocator, cuBLAS handles)
        warm = BatchVisualOdometry(cfg, B, dev, seed=1)
        for f in range(3):
            warm.process(imgs[:B, f], deps[:B, f])
        n_k, dev_ms, wall = _profiled_step(warm, imgs[:B, 3], deps[:B, 3])
        kernels[B] = n_k
        torch.cuda.reset_peak_memory_stats(dev)

        zero_launches()
        t0 = time.perf_counter()
        stream = BatchVisualOdometry(cfg, B, dev, seed=0)
        for f in range(F):
            stream.process(imgs[:B, f], deps[:B, f])
        traj = stream.trajectories()
        s_stream = time.perf_counter() - t0
        k_stream = hamming_top2.launches
        # one launch a batched step for all B lanes
        _pose_launches(f"B = {B} stream", F - 1)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30

        zero_launches()
        t0 = time.perf_counter()
        chunked = BatchVisualOdometry(cfg, B, dev, seed=0)
        chunked.process_chunk(imgs[:B, :half], deps[:B, :half])
        chunked.process_chunk(imgs[:B, half:], deps[:B, half:])
        traj_c = chunked.trajectories()
        s_chunk = time.perf_counter() - t0
        k_chunk = hamming_top2.launches
        _pose_launches(f"B = {B} chunked", F - 1)
        launches += k_stream + k_chunk

        if not (k_stream == k_chunk == F - 1):
            raise AssertionError(f"B = {B}: {k_stream} / {k_chunk} "
                                 f"hamming_top2 launches for {F - 1} steps")
        if not (np.isfinite(traj).all() and np.array_equal(traj, traj_c)
                and torch.equal(stream.grids, chunked.grids)):
            raise AssertionError(f"B = {B}: process_chunk differs from "
                                 f"process, max |dT| "
                                 f"{np.abs(traj - traj_c).max()}")
        ates = _lane_ates(traj, gt)
        jax = JAX_BATCH_ATE_M[:min(B, len(JAX_BATCH_ATE_M))]
        if not (max(ates) < 0.01
                and all(a <= 1.5 * j for a, j in zip(ates, jax))):
            raise AssertionError(f"B = {B}: lane ATEs {ates} (JAX lanes 0-3 "
                                 f"{JAX_BATCH_ATE_M})")
        print(f"phase 9: BatchVisualOdometry B = {B}: {F} frames of {B} "
              f"sequences, {B * (F - 1) / s_stream:.2f} frame-tracks/s stream, "
              f"{B * (F - 1) / s_chunk:.2f} chunked ({half} + {half}; == "
              f"stream bit for bit), {1e3 * s_stream / F:.0f} ms per batched "
              f"step; {k_stream} kernel launches per run (1 per step); "
              f"{n_k} CUDA kernels in a profiled step, {dev_ms:.1f} ms of "
              f"device time in {wall * 1e3:.0f} ms (busy "
              f"{dev_ms / 1e3 / wall:.1%}); "
              f"peak {peak:.2f} GiB; lane ATE max {max(ates) * 100:.3f} cm, "
              f"lanes 0-{len(jax) - 1} "
              f"{', '.join(f'{a * 100:.3f}' for a in ates[:len(jax)])} cm (JAX "
              f"{', '.join(f'{j * 100:.3f}' for j in jax)}; ratio up to "
              f"{max(a / j for a, j in zip(ates, jax)):.2f}) [{card}]",
              flush=True)
    # the pyramid resize and the IC angle run once per lane (module
    # docstrings of ops/pyramid.py and ops/orb.py): ~90 kernels per extra
    # lane on an H100.  A further per-lane loop shows in the limit per lane.
    # (The ratio to B = 1 is printed, not gated: since motion-only BA is one
    # kernel a call, a B = 1 step is ~5.9k kernels, not ~25k, and those 90
    # kernels a lane are 1.25x at B = 16.)
    per_lane = (kernels[N_BATCH] - kernels[1]) / (N_BATCH - 1)
    if per_lane > MAX_KERNELS_PER_LANE:
        raise AssertionError(f"a step at B = {N_BATCH} runs {kernels[N_BATCH]} "
                             f"CUDA kernels, B = 1 {kernels[1]} ({per_lane:.1f} "
                             f"per extra lane, limit {MAX_KERNELS_PER_LANE}): "
                             f"not batched")
    print(f"phase 9: CUDA kernels per step {kernels[1]} at B = 1, "
          f"{kernels[N_BATCH]} at B = {N_BATCH}: "
          f"{kernels[N_BATCH] / kernels[1]:.3f}x, {per_lane:.1f} "
          f"per extra lane (limit {MAX_KERNELS_PER_LANE}) [{card}]", flush=True)

    # lanes 0-3 of a B = 16 run against the unbatched chain, same draws
    H, S = cfg.ransac.n_hypotheses, cfg.ransac.sample_size
    rng = np.random.default_rng(90)
    draws = torch.from_numpy(rng.integers(0, 100, (N_BATCH, F - 1, H, S))).to(dev)
    imgs_d, deps_d = torch.from_numpy(imgs).to(dev), torch.from_numpy(deps).to(dev)
    bvo = BatchVisualOdometry(cfg, N_BATCH, dev)
    batched_desc = []
    for f in range(F):
        bvo.process(imgs_d[:, f], deps_d[:, f],
                    draws=None if f == 0 else draws[:, f - 1])
        batched_desc.append(bvo.prev.feat.desc[:4])
    traj = bvo.trajectories()
    dT, bits = 0.0, 0
    for b in range(4):
        grid = init_grid_thresholds(cfg.extractor, dev)
        frame, grid = make_frame(imgs_d[b, 0], deps_d[b, 0], cfg, grid)
        bits += int((unpack_bits(frame.feat.desc)
                     != unpack_bits(batched_desc[0][b])).sum())
        for f in range(1, F):
            frame, grid, res = odometry.track_frame(
                frame, imgs_d[b, f], deps_d[b, f], grid, None, cfg,
                draws=draws[b, f - 1])
            bits += int((unpack_bits(frame.feat.desc)
                         != unpack_bits(batched_desc[f][b])).sum())
            dT = max(dT, float(np.abs(res.T_cw2.cpu().numpy()
                                      - traj[f - 1, b]).max()))
        if not torch.equal(grid, bvo.grids[b]):
            raise AssertionError(f"lane {b}: threshold grid differs from the "
                                 f"unbatched chain's")
    if dT > 1e-4:
        raise AssertionError(f"lanes 0-3 differ from the unbatched chain by "
                             f"{dT} on T ({bits} descriptor bits differ)")
    print(f"phase 9: B = {N_BATCH} with injected draws, lanes 0-3 against "
          f"the unbatched track_frame chain over {F} frames: max |dT| {dT:.2e} "
          f"(tolerance 1e-4), grids equal, {bits} of "
          f"{4 * F * cfg.extractor.max_keypoints * 256} descriptor bits "
          f"differ [{card}]", flush=True)
    return launches


def _phase9c_viewers(dev, card, walk, ate_device):
    """The CLI with --render-map and --viewer 0 over the walk's 64 PNGs."""
    import urllib.request

    from aslam_tpu_torch import main as cli
    from aslam_tpu_torch.profile_slam import bench_config3
    from aslam_tpu_torch.utils import dataset, trajectory

    cfg = bench_config3(loop_closing=True)
    cli.CAMERAS["bench"] = cfg.camera
    imgs, deps, gt = walk
    n = len(imgs)
    gt_c = trajectory.camera_centers(gt)
    with tempfile.TemporaryDirectory(prefix="aslam_smoke_") as tmp:
        root = os.path.join(tmp, "walk")
        dataset.write_tum_sequence(root, imgs, deps, [0.033 * i for i in range(n)])
        out = os.path.join(tmp, "device")
        metrics, slam, k, seconds, _, pose = _cli(
            root, out, cfg, "--mode", "slam+gicp", "--engine", "device",
            "--chunk", str(n // 2), "--render-map", "--viewer", "0")
        _pose_launches("--render-map / --viewer", n - 1, pose)
        viewer = slam.viewer
        try:
            page = urllib.request.urlopen(viewer.url, timeout=10).read()
            state = json.loads(urllib.request.urlopen(
                viewer.url + "state", timeout=10).read())
        finally:
            viewer.stop()
        png = os.path.getsize(os.path.join(out, "map.png"))
        ate = trajectory.ate_rmse(
            _file_centers("viewer", out + "/CameraTrajectory.txt", n), gt_c)
    if not (png > 5000 and len(state["traj"]) == n and len(state["kfs"]) >= 4
            and len(state["landmarks"]) > 0 and b"live map" in page
            and k == n - 1):
        raise AssertionError(f"--render-map / --viewer: map.png {png} bytes, "
                             f"{len(state['traj'])} trajectory rows, "
                             f"{len(state['kfs'])} keyframes, {k} launches")
    if ate != ate_device:
        raise AssertionError(f"--render-map / --viewer: ATE {ate} differs from "
                             f"the same mode without them, {ate_device}")
    _gate_slam_ate("main --render-map --viewer 0", ate, ate,
                   JAX_CLI_ATE_M["device"])
    print(f"phase 9: main --mode slam+gicp --engine device --chunk {n // 2} "
          f"--render-map --viewer 0: map.png {png / 1024:.0f} KiB; one GET of "
          f"the state: {len(state['kfs'])} keyframes, {len(state['landmarks'])} "
          f"landmarks, {len(state['traj'])} trajectory rows, HUD "
          f"{state['stats']}; ATE {ate * 100:.3f} cm "
          f"(== phase 7); "
          f"{_cli_line(metrics, k, seconds, n)} [{card}]", flush=True)
    return k


def phase9_batch(dev, card, kernel, walk, ate_device):
    """Batched VO, its kernel, and the viewers -> kernel launches."""
    from aslam_tpu_torch.config import CameraModel, SystemConfig

    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640,
                      height=480)
    _phase9a_kernel(dev, card, kernel)
    launches = _phase9b_batch_vo(dev, card, SystemConfig(camera=cam))
    return launches + _phase9c_viewers(dev, card, walk, ate_device)


def _lba_window(cfg, dev, seed=0):
    """A seeded noisy local-BA problem at the window's full capacities of
    `cfg.ba` (max_fixed_cams fixed and max_window_cams free cameras,
    max_window_points points, max_edges edges), built as
    tests/test_torch_lba.py::make_problem builds one: cameras 5 cm apart
    along a track, fixed and free in turn (a window's fixed cameras are the
    covisible keyframes around it), each point seen by the E / L cameras
    nearest it with 0.3 px of noise, the free poses (1 cm, 10 mrad) and the
    points (2 cm) perturbed.  As there, each point keeps two stereo edges (a
    point left with one moves by millimetres under float32 reordering
    alone): a fifth of the free cameras' other edges are mono.  No
    outliers: with them the fixed-lam sharded schedule and the monotone
    `local_ba` prune different edges."""
    from aslam_tpu_torch.ops.lba import BAProblem
    from aslam_tpu_torch.utils.synthetic import _np_se3_exp

    ba, cam = cfg.ba, cfg.camera
    if ba.max_fixed_cams != ba.max_window_cams:
        raise ValueError("the window alternates fixed and free cameras")
    C = 2 * ba.max_window_cams
    L, E = ba.max_window_points, ba.max_edges
    rng = np.random.default_rng(seed)
    xs = 0.05 * np.arange(C)
    fixed = np.arange(C) % 2 == 0
    T_true = np.stack([_np_se3_exp(np.concatenate(
        [[-xs[c], 0.0, 0.0], rng.normal(0, 0.01, 3)])) for c in range(C)])
    pts = np.stack([rng.uniform(xs[0] - 0.3, xs[-1] + 0.3, L),
                    rng.uniform(-0.8, 0.8, L), rng.uniform(2.0, 4.0, L)],
                   -1).astype(np.float32)
    e_lm = np.repeat(np.arange(L), E // L)
    e_cam = np.argsort(np.abs(pts[:, None, 0] - xs[None, :]), axis=1,
                       kind="stable")[:, :E // L].reshape(-1)
    pc = np.einsum("eij,ej->ei", T_true[e_cam, :3, :3], pts[e_lm]) \
        + T_true[e_cam, :3, 3]
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1) \
        + rng.normal(0, 0.3, (E, 2))
    nearest = np.tile(np.arange(E // L), L)       # rank of e_cam for e_lm
    mono = (rng.random(E) < 0.2) & ~fixed[e_cam] & (nearest >= 2)
    cam_T = T_true.copy()
    for c in np.nonzero(~fixed)[0]:
        cam_T[c] = _np_se3_exp(rng.normal(0, 0.01, 6)) @ T_true[c]
    points = pts + rng.normal(0, 0.02, pts.shape)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return BAProblem(
        cam_T=put(cam_T, np.float32), cam_fixed=put(fixed, bool),
        cam_valid=put(np.ones(C), bool), points=put(points, np.float32),
        point_valid=put(np.ones(L), bool), e_cam=put(e_cam, np.int32),
        e_lm=put(e_lm, np.int32), e_uv=put(uv, np.float32),
        e_ur=put(np.where(mono, -1.0, uv[:, 0] - cam.bf / pc[:, 2]),
                 np.float32),
        e_z=put(np.where(mono, 0.0, pc[:, 2]), np.float32),
        e_valid=put(np.ones(E), bool))


def _phase10a_local_ba(dev, card, mesh):
    """`sharded_local_ba` on the world-1 mesh against `local_ba` at the
    local-BA window's full capacities of `bench_config2()`."""
    from aslam_tpu_torch.ops import lba
    from aslam_tpu_torch.parallel.sharded_ba import (pad_problem,
                                                     sharded_local_ba)
    from aslam_tpu_torch.profile_slam import bench_config2

    cfg = bench_config2()
    prob = _lba_window(cfg, dev)
    cam, ba = cfg.camera, cfg.ba
    _, _, _, _, chi2_e, active = lba.edge_terms(prob, cam, ba, robust=False)
    before = float(torch.sum(torch.where(active, chi2_e, 0.0)))
    padded = pad_problem(prob, mesh)
    out, chi2, n_edges = sharded_local_ba(padded, cam, ba, mesh)
    again = sharded_local_ba(padded, cam, ba, mesh)[0]
    ref, stats = lba.local_ba(prob, cam, ba)
    dT = float((out.cam_T - ref.cam_T).abs().max())
    dX = float((out.points - ref.points).abs().max())
    same = torch.equal(out.cam_T, again.cam_T) and torch.equal(out.points,
                                                                again.points)
    if not (dT <= 1e-3 and dX <= 1e-3 and int(n_edges) == int(stats.n_edges)
            and same and float(chi2) < before):
        raise AssertionError(
            f"sharded_local_ba vs local_ba: max |dT| {dT}, |dX| {dX}, edges "
            f"{int(n_edges)} vs {int(stats.n_edges)}, second run equal "
            f"{same}, chi2 {before} -> {float(chi2)}")
    # ms per call in turns: one device, sharded, sharded, one device
    ms = {"local_ba": [], "sharded_local_ba": []}
    for name in ("local_ba", "sharded_local_ba", "sharded_local_ba",
                 "local_ba"):
        fn = ((lambda: lba.local_ba(prob, cam, ba)) if name == "local_ba"
              else (lambda: sharded_local_ba(padded, cam, ba, mesh)))
        ms[name].append(_events_ms(fn, iters=3))
    C, L, E = (prob.cam_T.shape[0], prob.points.shape[0],
               prob.e_cam.shape[0])
    print(f"phase 10: sharded_local_ba on a world-1 NCCL group ({C} cameras, "
          f"{L} points, {E} edges): chi2 {before:.4g} -> {float(chi2):.4g} "
          f"(local_ba {float(stats.chi2):.4g}), {int(n_edges)} edges as "
          f"local_ba; max |dT| {dT:.2e}, |dX| {dX:.2e} (tolerance 1e-3); a "
          f"second run bit-identical; ms per call (CUDA events, in turns) "
          f"local_ba {ms['local_ba'][0]:.1f} / {ms['local_ba'][1]:.1f}, "
          f"sharded {ms['sharded_local_ba'][0]:.1f} / "
          f"{ms['sharded_local_ba'][1]:.1f} [{card}]", flush=True)


def _phase10b_session(dev, card, mesh, loop6):
    """The session's sharded post-loop GBA on phase 6(b)'s looped map, run
    twice, then the global solvers on the world-1 mesh against one
    device."""
    import dataclasses

    from aslam_tpu_torch.ops import global_ba
    from aslam_tpu_torch.parallel.partition import partitioned_gn_cg_step
    from aslam_tpu_torch.parallel.sharded_global_ba import sharded_global_ba
    from aslam_tpu_torch.profile_slam import bench_config2, looped_map

    cfg = bench_config2(loop_closing=True)
    cfg = cfg.replace(loop=dataclasses.replace(
        cfg.loop, post_gba_method="sharded_gn_cg"))
    runs = [_run_looped_map(cfg, dev) for _ in range(2)]
    run = runs[0]
    q, before, after = _gate_loop(run, "sharded post-loop GBA")
    m, m2 = runs[0]["m"], runs[1]["m"]
    if not (torch.equal(m.kf_T_cw, m2.kf_T_cw)
            and torch.equal(m.lm_pos, m2.lm_pos)):
        raise AssertionError("sharded post-loop GBA: a second run differs")
    chi2, gba_ms = run["chi2"], [1e3 * t for r in runs for t in r["gba_s"]]
    fix_ms = [1e3 * t for r in runs for t, closed in r["times"] if closed]
    fix6_ms = [1e3 * t for t, closed in loop6["times"] if closed]
    _, before6, after6 = _gate_loop(loop6, "loop closing")
    print(f"phase 10: looped map through LoopClosing with post_gba_method="
          f"sharded_gn_cg: loops {run['lc'].loops}, drift at KF {q} "
          f"{before * 100:.2f} -> {after * 100:.2f} cm (phase 6 gn_cg "
          f"{after6 * 100:.2f}); map_chi2 around the post-loop GBA "
          f"{chi2[0]:.4g} -> {chi2[1]:.4g} (gn_cg {loop6['chi2'][0]:.4g} -> "
          f"{loop6['chi2'][1]:.4g}); GBA ms "
          f"{' / '.join(f'{t:.1f}' for t in gba_ms)} "
          f"against gn_cg {1e3 * loop6['gba_s'][0]:.1f}; ms per sync with "
          f"the correction {' / '.join(f'{t:.1f}' for t in fix_ms)} against "
          f"gn_cg {' / '.join(f'{t:.1f}' for t in fix6_ms)}; {run['reads']} host "
          f"reads (phase 6: {loop6['reads']}); a second run bit-identical "
          f"[{card}]", flush=True)

    # the global solvers on the looped map as built, against one device
    m0 = looped_map(cfg, dev, seed=0, n_kfs=N_LOOP_KFS, n_pts=N_LOOP_PTS)[0]
    cam, ba = cfg.camera, cfg.ba
    out, _ = sharded_global_ba(m0, cam, ba, mesh, iters=4, robust_iters=2)
    ref = m0
    for i in range(4):
        ref, _ = global_ba.ba_sweep(ref, cam, ba, robust=i < 2)
    part, st = partitioned_gn_cg_step(m0, cam, ba, mesh)
    one, st1 = global_ba.gn_cg_step(m0, cam, ba)
    d = {}
    for name, a, b in (("sweep", out, ref), ("gn_cg", part, one)):
        d[name] = max(float((a.kf_T_cw - b.kf_T_cw).abs().max()),
                      float((a.lm_pos - b.lm_pos).abs().max()))
    if not (d["sweep"] <= 2e-3 and d["gn_cg"] <= 2e-3
            and int(st.n_edges) == int(st1.n_edges)):
        raise AssertionError(f"global solvers on the world-1 mesh vs one "
                             f"device: {d}, edges {int(st.n_edges)} vs "
                             f"{int(st1.n_edges)}")
    ms = {"ba_sweep x4": _events_ms(lambda: [global_ba.ba_sweep(
              m0, cam, ba, robust=i < 2) for i in range(4)], iters=2),
          "sharded_global_ba": _events_ms(lambda: sharded_global_ba(
              m0, cam, ba, mesh, iters=4, robust_iters=2), iters=2),
          "gn_cg_step": _events_ms(lambda: global_ba.gn_cg_step(
              m0, cam, ba), iters=2),
          "partitioned_gn_cg_step": _events_ms(lambda: partitioned_gn_cg_step(
              m0, cam, ba, mesh), iters=2)}
    print(f"phase 10: on the looped map ({m0.kf_valid.shape[0]} KF slots, "
          f"{m0.lm_pos.shape[0]} landmark slots): sharded_global_ba vs "
          f"ba_sweep x 4 max abs diff {d['sweep']:.2e}, partitioned_gn_cg_step"
          f" vs gn_cg_step {d['gn_cg']:.2e} (tolerance 2e-3), "
          f"{int(st.n_edges)} edges; ms per call (CUDA events) "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) + f" [{card}]",
          flush=True)


_DRYRUN_RANK = """
import sys, torch, torch.distributed as dist
from aslam_tpu_torch.parallel.dryrun import dryrun_multichip
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
try:
    for dp, lm in ((1, 2), (2, 1)):
        dryrun_multichip(2, dp=dp, lm=lm, device=torch.device("cuda", 0))
finally:
    dist.destroy_process_group()
"""


def _phase10c_two_ranks(card, timeout_s=180):
    """`dryrun_multichip` on two ranks on the card (gloo on CUDA tensors;
    NCCL refuses two ranks on one card), layouts 1x2 and 2x1."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_RANK, str(r), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(timeout_s - (time.perf_counter() - t0), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs) or len(outs) < 2:
        raise AssertionError("two-rank dry run failed:\n"
                             + "\n---\n".join(outs))
    lines = [ln for ln in outs[0].splitlines()
             if ln.startswith("dryrun_multichip")]
    if len(lines) != 4:
        raise AssertionError("two-rank dry run: expected 4 lines:\n" + outs[0])
    for ln in lines:
        print(f"phase 10: 2 ranks on cuda:0 (gloo): {ln} [{card}]", flush=True)
    print(f"phase 10: the two-rank dry run took "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


def phase10_parallel(dev, card, loop6):
    """`parallel/` on the card: (a) the sharded local BA and (b) the
    session's sharded post-loop GBA and the global solvers on a world-1
    NCCL group, (c) the dry run on two ranks.  Launches no kernel."""
    import torch.distributed as dist

    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel
    from aslam_tpu_torch.parallel import launch
    from aslam_tpu_torch.parallel.mesh import make_mesh

    print(f"phase 10: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s) [{card}]", flush=True)
    launches = hamming_top2.launches
    pose = pose_only_ba_kernel.launches
    launch.initialize_local(dev)
    try:
        mesh = make_mesh(1)
        _phase10a_local_ba(dev, card, mesh)
        _phase10b_session(dev, card, mesh, loop6)
    finally:
        dist.destroy_process_group()
    _phase10c_two_ranks(card)
    if hamming_top2.launches != launches:
        raise AssertionError("phase 10 launched hamming_top2")
    if pose_only_ba_kernel.launches != pose:
        raise AssertionError("phase 10 launched pose_only_ba")


# the benchmark's cells as phase 11 cuts them: (cell, timed frames, warm-up
# frames, profiled frames); the SLAM cell runs one chunk of 16
BENCH_CUTS = (("vo_tum640_stream", 16, 2, 2),
              ("slam_loop_tum640_chunk64", 16, 2, 2))
# metrics a cut run may leave unset: the VO p90 needs 100 samples, and the
# SLAM stages that run per keyframe, per local BA or per sync may not occur
BENCH_MAY_BE_NULL = {"frame_ms_p90", "map_keyframe_ms", "local_ba_ms",
                     "loop_sync_ms"}


def _check_bench_lines(res, lines, bench):
    """Every metric `BENCHMARK.json` names for the cell is printed once,
    with its unit, and has a value (but those a cut run may not reach); the
    breakdown's top kernels and idle gaps are printed."""
    for m in bench["metrics"] + bench["layer_metrics"]:
        if res["cell"] not in m["workloads"]:
            continue
        printed = [ln for ln in lines
                   if ln.startswith(f"metric {m['name']} = ")]
        if len(printed) != 1 or f" {m['unit']} (" not in printed[0]:
            raise AssertionError(f"phase 11: {res['cell']}: metric "
                                 f"{m['name']} not printed with its unit "
                                 f"{m['unit']}: {printed}")
        if res["metrics"].get(m["name"]) is None \
                and m["name"] not in BENCH_MAY_BE_NULL:
            raise AssertionError(f"phase 11: {res['cell']}: {m['name']} unset")
    if not (any(ln.startswith("kernel[0] ") for ln in lines)
            and any(ln.startswith("gap[0] ") for ln in lines)):
        raise AssertionError(f"phase 11: {res['cell']}: no breakdown")


def phase11_benchmark(card):
    """The benchmark's two cells, cut short, once each through its own entry
    function (`benchmark.run.run_cell`) traced, which times the pass with
    tracing off and then again under the spans: correct, every metric of
    `BENCHMARK.json` printed with its unit, one `hamming_top2` launch per
    tracked frame and one `pose_only_ba` launch (VO) or two (SLAM).  ->
    hamming_top2 launches."""
    from aslam_tpu_torch.ops.hamming_top2 import hamming_top2
    from benchmark import run as bench_run

    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    t0 = time.perf_counter()
    launches = 0
    with tempfile.TemporaryDirectory(prefix="aslam_bench_") as tmp:
        for name, frames, warmup, profiled in BENCH_CUTS:
            lines = []

            def echo(*a, **kw):
                lines.append(" ".join(map(str, a)))
                print(*a, **kw)

            # a traced run times its pass untraced first, then traced
            zero_launches()
            res = bench_run.run_cell(
                name, traced=True, cut=(frames, warmup, profiled),
                out=os.path.join(tmp, f"{name}.json"), echo=echo)
            if not res["correct"]:
                raise AssertionError(f"phase 11: {name}: {res['failures']}")
            _check_bench_lines(res, lines, bench)
            if res["metrics"]["hamming_top2_launches_per_frame"] != 1.0:
                raise AssertionError(f"phase 11: {name}: not one "
                                     f"hamming_top2 launch per frame")
            # every tracked frame of every pass launched hamming_top2 once
            launches += hamming_top2.launches
            per_frame = 1 if name.startswith("vo_") else 2
            _pose_launches(f"phase 11: {name}", per_frame * hamming_top2.launches)
            print(f"phase 11: {name}: correct, {len(res['metrics'])} "
                  f"metrics, fps {res['metrics']['fps']:.3f} untraced, "
                  f"{res['metrics']['fps_traced']:.3f} traced [{card}]",
                  flush=True)
    print(f"phase 11: took {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run "
                         "only on the card")
    dev = torch.device("cuda", 0)
    import aslam_tpu_torch  # noqa: F401  (the port; sets the precision policy)

    t0 = time.perf_counter()
    card = phase1_device_and_build()
    kernel = phase2_kernel_vs_plain(dev)
    pose_kernel = phase2b_pose_ba_vs_plain(dev)
    from aslam_tpu_torch.profile_slam import bench_config2, bench_walk

    launches, vo_frames = phase3_vo(dev, card)
    walk = bench_walk(bench_config2().camera, N_SLAM)
    launches += phase4_slam(dev, card, walk)
    print(f"chip_smoke: phases 1-4 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    launches += phase5_config3(dev, card, vo_frames, walk)
    k, loop6 = phase6_loop_closing(dev, card, walk)
    launches += k
    print(f"chip_smoke: phases 1-6 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    k, ate_device = phase7_host_shell(dev, card, walk)
    launches += k
    print(f"chip_smoke: phases 1-7 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    launches += phase8_families(dev, card, vo_frames, walk)
    print(f"chip_smoke: phases 1-8 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    launches += phase9_batch(dev, card, kernel, walk, ate_device)
    print(f"chip_smoke: phases 1-9 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    phase10_parallel(dev, card, loop6)
    print(f"chip_smoke: phases 1-10 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    launches += phase11_benchmark(card)
    print(f"chip_smoke: phases 1-11 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": [
        {**kernel, "launches": launches},
        {**pose_kernel, "launches": POSE_LAUNCHES["total"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()

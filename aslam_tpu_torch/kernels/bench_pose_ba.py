"""Inputs, checks and times of the motion-only BA kernel (`csrc/pose_ba.cu`).

`pose_ba_case` builds the problems the kernel is held to its plain version
on (`CASES`: the edges of a rendered 640x480 VO frame pair at the main path's
1024 keypoint slots, odd edge counts, no valid edge, mono and stereo edges
only, a NaN edge, the prior weight as a float and as a device tensor, the
constant information model at 1 x 1 iterations) and `pose_ba_batch` a batch
of 16 lanes; `check_against_plain` holds one kernel result to the plain
version's and `timings` times the kernel.  tests/test_torch_cuda.py and
`chip_smoke.py` (phase 2b) use them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aslam_tpu_torch.kernels.bench_top2 import event_us, graph_us, host_us

CASES = ("vo_frame_1024", "n1", "n37", "n1000", "all_invalid", "all_mono",
         "all_stereo", "nonfinite", "prior_float", "prior_tensor",
         "constant_1x1")


def camera():
    """TUM fr1's camera, 640x480 (the benchmark's and the VO path's)."""
    from aslam_tpu_torch.config import CameraModel

    return CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640,
                       height=480)


def pose_ba_inputs(n, seed, dev, lead=(), p_mono=0.2, p_invalid=0.05):
    """Edges of one frame (or a batch `lead`): points 0.8-3.5 m ahead seen
    from a pose near the truth with 0.5 px noise, a tenth 30 px off, a share
    mono (uR < 0) and a share invalid -> [T_cw_init, pts_w, obs_uv, obs_ur,
    obs_z, valid] on `dev`."""
    from aslam_tpu_torch.utils.se3 import se3_exp

    cam = camera()
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (n,)
    pts = np.stack([rng.uniform(-1.5, 1.5, shape), rng.uniform(-1, 1, shape),
                    rng.uniform(0.8, 3.5, shape)], -1).astype(np.float32)
    T_true = se3_exp(torch.from_numpy(
        rng.normal(0, 0.03, 6).astype(np.float32))).numpy()
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                   cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[..., : n // 10, :] += 30.0
    z = (pc[..., 2] + rng.normal(0, 0.005, shape)).astype(np.float32)
    ur = np.where(rng.random(shape) >= p_mono, uv[..., 0] - cam.bf / z,
                  -1.0).astype(np.float32)
    valid = rng.random(shape) >= p_invalid
    T_init = se3_exp(torch.from_numpy(
        rng.normal(0, 0.01, 6).astype(np.float32))).numpy() @ T_true
    T_init = np.broadcast_to(T_init, tuple(lead) + (4, 4)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (T_init, pts, uv, ur, z, valid)]


def vo_frame_edges(dev):
    """The motion-only BA of `rba_step` on a rendered 640x480 frame pair at
    full width (1024 keypoint slots): its inputs as the VO path builds them,
    recorded on the way in -> (inputs, BAConfig)."""
    from aslam_tpu_torch.config import SystemConfig
    from aslam_tpu_torch.models import odometry
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import make_frame
    from aslam_tpu_torch.ops import ba
    from aslam_tpu_torch.utils import synthetic

    cam = camera()
    cfg = SystemConfig(camera=cam)
    imgs, depths, _, _ = synthetic.make_sequence(n_frames=2, n_points=1500,
                                                 cam=cam, seed=5)
    u8 = torch.from_numpy(np.clip(imgs, 0, 255).astype(np.uint8)).to(dev)
    u16 = torch.from_numpy(np.clip(depths / cam.depth_factor, 0, 65535)
                           .astype(np.uint16)).to(dev)
    grid = init_grid_thresholds(cfg.extractor, dev)
    f1, grid = make_frame(u8[0], u16[0], cfg, grid)
    f2, _ = make_frame(u8[1], u16[1], cfg, grid)
    seen = []
    real = ba.pose_only_ba

    def record(*args, **kw):
        seen.append(args[:6])
        return real(*args, **kw)

    ba.pose_only_ba = record
    try:
        odometry.rba_step(f1, f2, torch.Generator(device=dev).manual_seed(0),
                          cfg)
    finally:
        ba.pose_only_ba = real
    args = [a.contiguous() for a in seen[0]]
    if args[1].shape != (1024, 3) or int(args[5].sum()) <= 100:
        raise AssertionError(f"VO frame edges: {tuple(args[1].shape)}, "
                             f"{int(args[5].sum())} valid")
    return args, cfg.ba


def pose_ba_case(case, dev):
    """-> (inputs, BAConfig, prior weight) of a case named in `CASES`."""
    from aslam_tpu_torch.config import BAConfig

    cfg = BAConfig()
    if case == "vo_frame_1024":
        args, cfg = vo_frame_edges(dev)
        return args, cfg, 0.0
    n = {"n1": 1, "n37": 37, "n1000": 1000}.get(case, 1024)
    args = pose_ba_inputs(
        n, CASES.index(case), dev,
        p_mono={"all_mono": 1.0, "all_stereo": 0.0}.get(case, 0.2))
    prior = 0.0
    if case == "all_invalid":
        args[5] = torch.zeros_like(args[5])
    elif case == "nonfinite":
        args[2][3, 0] = float("nan")      # a valid edge: NaN sums every pass
        args[5][3] = True
    elif case == "prior_float":
        prior = 2.0e6
    elif case == "prior_tensor":
        prior = torch.tensor(2.0e6, device=dev)
    elif case == "constant_1x1":
        cfg = dataclasses.replace(cfg, info_model="constant", pose_rounds=1,
                                  pose_iters=1)
    return args, cfg, prior


def pose_ba_batch(dev, b=16, n=1024):
    """b problems of n edges, lane 1 with no valid edge and lane 2 with a
    NaN edge -> (the lanes' inputs, the stacked inputs)."""
    lanes = [pose_ba_inputs(n, 100 + k, dev) for k in range(b)]
    lanes[1][5] = torch.zeros_like(lanes[1][5])
    lanes[2][2][7, 1] = float("nan")
    return lanes, [torch.stack([lane[k] for lane in lanes]) for k in range(6)]


def same_bits(x, y) -> bool:
    """Equal bit for bit (NaN included, which torch.equal calls unequal)."""
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def check_against_plain(out, ref, args, cam, cfg, prior) -> dict:
    """Holds the kernel's result `out` to the plain version's `ref` on the
    same inputs, or raises: T_cw to 1e-5; chi2 to rtol 1e-4 (atol 1e-3: a
    well-fit edge's chi2 is the square of a difference of two ~300-px
    numbers, whose float32 rounding alone moves it by ~1e-4); inliers and
    counts exactly but for edges within 1e-4 relative of their threshold.
    Where the two T differ by more, the system is ill-conditioned (one or
    two edges): both float32 versions stray from the float64 solve, and the
    kernel may stray at most twice as far as the plain version.
    -> {"dT": max |dT|, "near_ties": inlier flags that differ}."""
    from aslam_tpu_torch.ops import ba

    dT = float((out.T_cw - ref.T_cw).abs().max())
    if not dT <= 1e-5:
        a64 = [a.double() if a.is_floating_point() else a for a in args]
        ref64 = ba.pose_only_ba_plain(*a64, cam, cfg, prior)
        e_k = float((out.T_cw.double() - ref64.T_cw).abs().max())
        e_p = float((ref.T_cw.double() - ref64.T_cw).abs().max())
        if not e_k <= 2 * e_p:
            raise AssertionError(f"pose_ba: max |dT| {dT} to the plain "
                                 f"version; {e_k} to the float64 solve, the "
                                 f"plain version {e_p}")
    torch.testing.assert_close(out.chi2, ref.chi2, rtol=1e-4, atol=1e-3,
                               equal_nan=True)
    th = torch.where(args[3] >= 0, torch.full_like(args[4], cfg.chi2_stereo),
                     torch.full_like(args[4], cfg.chi2_mono))
    near = (ref.chi2 - th).abs() <= 1e-4 * th
    differ = out.inliers != ref.inliers
    if bool((differ & ~near).any()):
        raise AssertionError(f"pose_ba: inlier flags differ away from the "
                             f"threshold at {differ.nonzero()[:5].tolist()}")
    counted = out.inliers.to(torch.int32).sum(-1, dtype=torch.int32)
    n_differ = int(differ.sum())
    if not (torch.equal(out.n_inliers, counted) and
            int((out.n_inliers - ref.n_inliers).abs().max()) <= n_differ):
        raise AssertionError(f"pose_ba: n_inliers {out.n_inliers.tolist()} "
                             f"vs {ref.n_inliers.tolist()}")
    return {"dT": dT, "near_ties": n_differ}


def timings(args, cam, cfg) -> dict:
    """At these inputs: the kernel's device time (20 launches in a CUDA
    graph), its eager time and the plain version's (CUDA events, in turns
    plain, kernel, kernel, plain), its host time per unsynchronised call and
    its bound, in microseconds."""
    from aslam_tpu_torch.ops import ba
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_ba_bound

    def kernel():
        ba.pose_only_ba(*args, cam, cfg)

    def plain():
        ba.pose_only_ba_plain(*args, cam, cfg)

    plain_us = [event_us(plain, iters=3, warmup=1)]
    kernel_us = [event_us(kernel, iters=50) for _ in range(2)]
    plain_us.append(event_us(plain, iters=3, warmup=1))
    lead = args[1].shape[:-2]
    bound = pose_ba_bound(args[1].shape[-2], lead[0] if lead else 1,
                          cfg.pose_rounds, cfg.pose_iters)
    return {"device_us": graph_us(kernel, launches=20, replays=10),
            "eager_us": sum(kernel_us) / 2, "plain_us": sum(plain_us) / 2,
            # fewer calls than the launch queue holds: the host's own time
            "host_us": host_us(kernel, iters=200),
            "bound_us": bound["bound_us"], "bound_by": bound["bound_by"]}

"""Motion-only BA in one CUDA launch: the kernel's wrapper, its bound and its
launch counter.

The counterpart of `aslam_tpu/ops/ba.py::pose_only_ba` on the card.
`ops/ba.py::pose_only_ba` calls `pose_only_ba_kernel` for CUDA tensors; the
wrapper launches the hand-written Hopper kernel `csrc/pose_ba.cu` (built by
`kernels/build.py`) once per call, one thread block per problem, whatever
the batch, or raises.  It has no CPU path: on the CPU `pose_only_ba` runs
`ops/ba.py::pose_only_ba_plain`, the same computation as PyTorch ops.
"""

from __future__ import annotations

import ctypes

import torch

# What `pose_ba_bound` divides by: one NVIDIA H100 SXM at its 700 W limit
# (NVIDIA's data sheet, outside the tensor cores)
FP32_PER_S = 67e12
FP64_PER_S = 34e12
BYTES_PER_S = 3.35e12               # HBM3

# operations an edge, counted from csrc/pose_ba.cu: a pass of an LM
# iteration does the projection, residual, Jacobian, chi2, Huber weight and
# Jw in float32 (95) and the 27 products-and-adds of each of the 3 rows into
# H's lower triangle and b in float64 (162); a chi2 pass after each round
# does the projection, residual and chi2 (37).  A solve (6x6 Cholesky, the
# prior's se3_log, se3_exp, two 4x4 products) is ~700 float32 operations.
EDGE_FP32, EDGE_FP64, CHI2_FP32, SOLVE_FP32 = 95, 162, 37, 700


def pose_ba_bound(n: int, b: int = 1, rounds: int = 4, iters: int = 10) -> dict:
    """The least time one H100 could take for a call on b problems of n edges
    with `rounds` x `iters` iterations.  The operations are those of
    csrc/pose_ba.cu (`EDGE_FP32` ...) over the card's peak rate for their
    type (float32 and float64 outside the tensor cores run side by side, so
    the larger of the two times); the bytes are every input read once and
    every output written once over the 3.35 TB/s of HBM3.  The bound is the
    larger of the two times.  No loop ends early: the work is fixed by the
    shapes."""
    passes = rounds * iters
    fp32 = b * (passes * (n * EDGE_FP32 + SOLVE_FP32) + rounds * n * CHI2_FP32)
    fp64 = b * passes * n * EDGE_FP64
    # T [4,4], points, uv, uR, z float32 and valid bytes in; T, chi2,
    # inliers and the count out
    nbytes = b * (64 + n * (12 + 8 + 4 + 4 + 1) + 64 + n * (4 + 1) + 4)
    ops_us = max(fp32 / FP32_PER_S, fp64 / FP64_PER_S) * 1e6
    bytes_us = nbytes / BYTES_PER_S * 1e6
    return {"fp32": fp32, "fp64": fp64, "bytes": nbytes,
            "bound_us": max(ops_us, bytes_us),
            "bound_by": "operations" if ops_us >= bytes_us else "bytes"}


_launch = None


def _kernel():
    global _launch
    if _launch is None:
        from aslam_tpu_torch.kernels import build

        fn = build.load("pose_ba").pose_ba_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(T_cw_init, pts_w, obs_uv, obs_ur, obs_z, valid, prior_weight, cfg):
    """Raise on what the kernel does not take: shapes first, then types,
    then devices and layout."""
    if pts_w.dim() not in (2, 3) or pts_w.shape[-1] != 3:
        raise ValueError(f"pose_only_ba_kernel takes points [N,3] or a batch "
                         f"[B,N,3], got {tuple(pts_w.shape)}")
    lead, n = tuple(pts_w.shape[:-2]), pts_w.shape[-2]
    shapes = (("T_cw_init", T_cw_init, lead + (4, 4)),
              ("obs_uv", obs_uv, lead + (n, 2)), ("obs_ur", obs_ur, lead + (n,)),
              ("obs_z", obs_z, lead + (n,)), ("valid", valid, lead + (n,)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape} beside points "
                             f"{tuple(pts_w.shape)}, got {tuple(t.shape)}")
    tensors = (("T_cw_init", T_cw_init), ("pts_w", pts_w), ("obs_uv", obs_uv),
               ("obs_ur", obs_ur), ("obs_z", obs_z), ("valid", valid))
    for name, t in tensors:
        dtype = torch.bool if name == "valid" else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if isinstance(prior_weight, torch.Tensor):
        if prior_weight.numel() != 1 or prior_weight.dtype != torch.float32:
            raise TypeError(f"prior_weight must be a float or a float32 scalar "
                            f"tensor, got {prior_weight.dtype} of shape "
                            f"{tuple(prior_weight.shape)}")
    if cfg.pose_rounds < 1 or cfg.pose_iters < 0:
        raise ValueError(f"pose_only_ba_kernel needs pose_rounds >= 1 and "
                         f"pose_iters >= 0, got {cfg.pose_rounds} x "
                         f"{cfg.pose_iters}")
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"pose_only_ba_kernel runs on the card: {name} "
                             f"lies on {t.device} (CPU tensors take "
                             f"ops/ba.py::pose_only_ba_plain)")
    dev = pts_w.device
    for name, t in tensors:
        if t.device != dev:
            raise ValueError("pose_only_ba_kernel inputs lie on different cards")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if isinstance(prior_weight, torch.Tensor) and prior_weight.device != dev:
        raise ValueError(f"prior_weight lies on {prior_weight.device}, the "
                         f"points on {dev}")


def pose_only_ba_kernel(T_cw_init: torch.Tensor, pts_w: torch.Tensor,
                        obs_uv: torch.Tensor, obs_ur: torch.Tensor,
                        obs_z: torch.Tensor, valid: torch.Tensor, cam, cfg,
                        prior_weight: float | torch.Tensor = 0.0):
    """`ops/ba.py::pose_only_ba` on CUDA tensors in one launch: T_cw_init
    [4,4], pts_w [N,3], obs_uv [N,2], obs_ur [N], obs_z [N] float32 and
    valid [N] bool, or a batch of B problems ([B,4,4], [B,N,3], ...), on one
    card and contiguous; `prior_weight` a float or a float32 scalar tensor on
    the same card, read by the kernel.  -> (T_cw [...,4,4], inliers [...,N]
    bool, n_inliers [...] int32, chi2 [...,N] float32).

    The launch goes on the card's current stream, does not synchronise and
    allocates only the outputs, through PyTorch's allocator, so it can be
    captured in a CUDA graph once a first call has built and loaded the
    kernel; it adds one to `pose_only_ba_kernel.launches` (during a capture:
    the calls captured, not the replays)."""
    _check(T_cw_init, pts_w, obs_uv, obs_ur, obs_z, valid, prior_weight, cfg)
    dev = pts_w.device
    lead, n = pts_w.shape[:-2], pts_w.shape[-2]
    b = lead[0] if lead else 1
    T_out = torch.empty(lead + (4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty(lead, dtype=torch.int32, device=dev)
    chi2 = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    if b == 0:
        return T_out, inliers, n_inliers, chi2
    launch = _launch or _kernel()
    if isinstance(prior_weight, torch.Tensor):
        w, w_ptr = 0.0, prior_weight.data_ptr()
    else:
        w, w_ptr = float(prior_weight), None
    args = (T_cw_init.data_ptr(), pts_w.data_ptr(), obs_uv.data_ptr(),
            obs_ur.data_ptr(), obs_z.data_ptr(), valid.data_ptr(), b, n,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cfg.pose_rounds,
            cfg.pose_iters, cfg.chi2_mono, cfg.chi2_stereo,
            int(cfg.info_model == "constant"), w, w_ptr, T_out.data_ptr(),
            inliers.data_ptr(), n_inliers.data_ptr(), chi2.data_ptr())
    # the raw handle of the card's current stream, read at call time
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = launch(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"pose_ba kernel launch failed: cudaError {err}")
    pose_only_ba_kernel.launches += 1
    return T_out, inliers, n_inliers, chi2


pose_only_ba_kernel.launches = 0

"""Fused masked Hamming 2-NN: the kernel's wrapper, its plain version and
its launch counter.

The counterpart of `aslam_tpu/ops/pallas_kernels.py::hamming_top2`.  For
CUDA tensors `hamming_top2` launches the hand-written Hopper kernel
`csrc/hamming_top2.cu` (built by `kernels/build.py`) or raises; for CPU
tensors it runs `hamming_top2_plain`.  Both return, per query row, what the
reference's default path returns (`masked_distance_matrix` then
`lax.top_k`): d1 the smallest distance, i1 the lowest index attaining it, d2
the second value of the sorted row (d2 == d1 on a tie), with every masked
pair at exactly INVALID_DIST.
"""

from __future__ import annotations

import ctypes

import torch

from aslam_tpu_torch.ops.hamming import masked_distance_matrix


def hamming_top2_plain(desc_a: torch.Tensor, valid_a: torch.Tensor,
                       desc_b: torch.Tensor, valid_b: torch.Tensor):
    """Masked distance matrix + a stable ascending sort of each row.
    -> (d1 [N] f32, i1 [N] int32, d2 [N] f32)."""
    d = masked_distance_matrix(desc_a, valid_a, desc_b, valid_b)
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, 0], idx[:, 0].to(torch.int32), vals[:, 1]


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from aslam_tpu_torch.kernels import build

        lib = build.load("hamming_top2")
        fn = lib.hamming_top2_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.hamming_top2_launch


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on the card, not {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def hamming_top2(desc_a: torch.Tensor, valid_a: torch.Tensor,
                 desc_b: torch.Tensor, valid_b: torch.Tensor):
    """desc_a [N,8] int32, valid_a [N] bool, desc_b [M,8] int32, valid_b [M]
    bool -> (d1 [N] f32, i1 [N] int32, d2 [N] f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream and add one to `hamming_top2.launches`."""
    if desc_a.device.type == "cpu":
        return hamming_top2_plain(desc_a, valid_a, desc_b, valid_b)
    n, m = desc_a.shape[0], desc_b.shape[0]
    _check("desc_a", desc_a, torch.int32, (n, 8))
    _check("desc_b", desc_b, torch.int32, (m, 8))
    _check("valid_a", valid_a, torch.bool, (n,))
    _check("valid_b", valid_b, torch.bool, (m,))
    # a bool tensor is one byte of 0/1 per element: the kernel reads it as
    # uint8 in place
    va, vb = valid_a.view(torch.uint8), valid_b.view(torch.uint8)
    if any(t.device != desc_a.device for t in (valid_a, desc_b, valid_b)):
        raise ValueError("hamming_top2 inputs lie on different cards")
    launch = _kernel()
    d1 = torch.empty(n, dtype=torch.float32, device=desc_a.device)
    i1 = torch.empty(n, dtype=torch.int32, device=desc_a.device)
    d2 = torch.empty(n, dtype=torch.float32, device=desc_a.device)
    with torch.cuda.device(desc_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(desc_a.data_ptr(), va.data_ptr(), desc_b.data_ptr(),
                     vb.data_ptr(), n, m, d1.data_ptr(), i1.data_ptr(),
                     d2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hamming_top2 kernel launch failed: cudaError {err}")
    hamming_top2.launches += 1
    return d1, i1, d2


hamming_top2.launches = 0

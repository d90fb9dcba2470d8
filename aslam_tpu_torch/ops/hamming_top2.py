"""Fused masked Hamming 2-NN: the kernel's wrapper, its plain version, its
bound and its launch counter.

The counterpart of `aslam_tpu/ops/pallas_kernels.py::hamming_top2`.  For
CUDA tensors `hamming_top2` launches the hand-written Hopper kernel
`csrc/hamming_top2.cu` (built by `kernels/build.py`) or raises; for CPU
tensors it runs `hamming_top2_plain`.  Both return, per query row, what the
reference's default path returns (`masked_distance_matrix` then
`lax.top_k`): d1 the smallest distance, i1 the lowest index attaining it, d2
the second value of the sorted row (d2 == d1 on a tie), with every masked
pair at exactly INVALID_DIST.  Both also take a batch of B independent
problems, [B,N,8] x [B,M,8] (batched VO): one launch of the kernel for all
B, its grid's y the lane.
"""

from __future__ import annotations

import ctypes

import torch

from aslam_tpu_torch.ops.hamming import masked_distance_matrix

# The kernel's partition of the work, equal to the constants of the same
# names (kTileRows, ...) in csrc/hamming_top2.cu.  One tensor-core instruction
# scores GROUP targets against the TILE_ROWS query rows of a block; the targets are staged
# CHUNK = WARPS * 32 at a time into SLOTS slots of shared memory (a ring
# beyond SLOTS * CHUNK targets); of every chunk warp w takes the groups w, w +
# WARPS, ..., and in a group 8 lanes share a query row, each with targets g
# and g + 8.  A pair's key is distance << KEY_SHIFT | index, plus MASKED <<
# KEY_SHIFT for a masked target.
TILE_ROWS = 8
GROUP = 16
WARPS = 16
CHUNK = WARPS * 32
SLOTS = 12
KEY_SHIFT = 22
MASKED = 512
MAX_TARGETS = 1 << KEY_SHIFT
MAX_LANES = 65535                   # the grid's y

# What `hamming_top2_bound` divides by: one NVIDIA H100 SXM at its 700 W limit.
# 1-bit tensor-core rate: no data sheet gives one for this card, so it is the
# rate that `kernels/bench_top2.py::mma_peak_ops_per_s` measured for
# mma.sync m16n8k256 .b1 .and.popc alone on an H100 at 700 W: 9,526 to 9,787
# TOP/s over several runs, rounded up; 4.95 times the data sheet's int8 rate
# of 1,979 TOP/s
MMA_OPS_PER_S = 9800e12
POPC_PER_S = 132 * 16 * 1.98e9      # SMs x __popc results per clock per SM x Hz
BYTES_PER_S = 3.35e12               # HBM3


def hamming_top2_plain(desc_a: torch.Tensor, valid_a: torch.Tensor,
                       desc_b: torch.Tensor, valid_b: torch.Tensor):
    """Masked distance matrix + a stable ascending sort of each row, over
    [N,8] x [M,8] or a batch [B,N,8] x [B,M,8].
    -> (d1 [..., N] f32, i1 [..., N] int32, d2 [..., N] f32)."""
    d = masked_distance_matrix(desc_a, valid_a, desc_b, valid_b)
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., 0], idx[..., 0].to(torch.int32), vals[..., 1]


def hamming_top2_bound(n: int, m: int, b: int = 1) -> dict:
    """The least time one H100 could take for an [n] x [m] call (or for b
    of them in one batched call: work and bytes times b).

    The operations are those of one 256-deep 1-bit product per pair on the
    tensor cores, 2*n*m*256, over the rate that the card was measured to
    sustain for that instruction (`MMA_OPS_PER_S`; the data sheet gives no
    1-bit rate).  The bytes are every input read once and every output
    written once (descriptors 32 B a row, masks 1 B, three 4-byte outputs per
    query row) over the 3.35 TB/s of HBM3 (`BYTES_PER_S`).  The bound is the
    larger of the two times.  `popc` and `popc_us` are what the same work
    costs outside the tensor cores, as n*m*8 popcounts of 32-bit words at 16
    results per clock per SM (NVIDIA's table of arithmetic
    instruction throughput, compute capability 9.0) on 132 SMs at 1.98 GHz
    (`POPC_PER_S`): the bound of a design on XOR and `__popc`."""
    mma_ops, popc = 2 * b * n * m * 256, b * n * m * 8
    nbytes = b * ((n + m) * (32 + 1) + 3 * n * 4)
    mma_us, bytes_us = mma_ops / MMA_OPS_PER_S * 1e6, nbytes / BYTES_PER_S * 1e6
    return {"mma_ops": mma_ops, "popc": popc, "bytes": nbytes,
            "popc_us": popc / POPC_PER_S * 1e6,
            "bound_us": max(mma_us, bytes_us),
            "bound_by": "mma" if mma_us >= bytes_us else "bytes"}


_launch = None


def _kernel():
    global _launch
    if _launch is None:
        from aslam_tpu_torch.kernels import build

        fn = build.load("hamming_top2").hamming_top2_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _raise_bad_input(desc_a, valid_a, desc_b, valid_b):
    """The detailed message for inputs that the kernel does not take."""
    dev = desc_a.device
    lead = tuple(desc_a.shape[:-2])
    if not 2 <= desc_a.dim() == desc_b.dim() <= 3:
        raise ValueError(f"hamming_top2 takes [N,8] x [M,8] or a batch "
                         f"[B,N,8] x [B,M,8], got {tuple(desc_a.shape)} x "
                         f"{tuple(desc_b.shape)}")
    for name, t, dtype, width in (("desc_a", desc_a, torch.int32, 8),
                                  ("valid_a", valid_a, torch.bool, None),
                                  ("desc_b", desc_b, torch.int32, 8),
                                  ("valid_b", valid_b, torch.bool, None)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must lie on the card, not {t.device}")
        if t.device != dev:
            raise ValueError("hamming_top2 inputs lie on different cards")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        side = desc_a if name.endswith("_a") else desc_b
        rows = side.shape[-2]
        shape = lead + ((rows,) if width is None else (rows, width))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if width is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a multiple of 16 bytes")
    if lead and lead[0] > MAX_LANES:
        raise ValueError(f"hamming_top2 takes at most {MAX_LANES} lanes, "
                         f"got {lead[0]}")
    raise ValueError(f"hamming_top2 takes at most {MAX_TARGETS} targets, "
                     f"got {desc_b.shape[-2]}")


def hamming_top2(desc_a: torch.Tensor, valid_a: torch.Tensor,
                 desc_b: torch.Tensor, valid_b: torch.Tensor):
    """desc_a [N,8] int32, valid_a [N] bool, desc_b [M,8] int32, valid_b [M]
    bool -> (d1 [N] f32, i1 [N] int32, d2 [N] f32), the three rows of one
    [3, N] buffer.  Or a batch: [B,N,8], [B,N], [B,M,8], [B,M] -> [B,N] each,
    the rows of one [B, 3, N] buffer.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    their card's current stream, once whatever B is, and add one to
    `hamming_top2.launches`.  The call does not synchronise and allocates
    only its output, through PyTorch's allocator, so it can be captured in a
    CUDA graph once a first call has built and loaded the kernel; `launches`
    then counts the calls made while capturing, not the replays."""
    dev = desc_a.device
    if dev.type == "cpu":
        return hamming_top2_plain(desc_a, valid_a, desc_b, valid_b)
    if not 2 <= desc_a.dim() == desc_b.dim() <= 3:
        _raise_bad_input(desc_a, valid_a, desc_b, valid_b)
    lead = desc_a.shape[:-2]
    b = desc_a.shape[0] if lead else 1
    n, m = desc_a.shape[-2], desc_b.shape[-2]
    pa, pb = desc_a.data_ptr(), desc_b.data_ptr()
    # a bool tensor is one byte of 0/1 per element: the kernel reads it in place
    if not (desc_a.dtype == desc_b.dtype == torch.int32
            and valid_a.dtype == valid_b.dtype == torch.bool
            and desc_a.shape == lead + (n, 8) and desc_b.shape == lead + (m, 8)
            and valid_a.shape == lead + (n,) and valid_b.shape == lead + (m,)
            and dev == valid_a.device == desc_b.device == valid_b.device
            and desc_a.is_contiguous() and desc_b.is_contiguous()
            and valid_a.is_contiguous() and valid_b.is_contiguous()
            and pa % 16 == 0 and pb % 16 == 0 and m <= MAX_TARGETS
            and b <= MAX_LANES):
        _raise_bad_input(desc_a, valid_a, desc_b, valid_b)
    launch = _launch or _kernel()
    # rows d1, i1, d2 per lane; the kernel writes i1's bits into the float32
    # buffer
    out = torch.empty(lead + (3, n), dtype=torch.float32, device=dev)
    args = (pa, valid_a.data_ptr(), pb, valid_b.data_ptr(), b, n, m,
            out.data_ptr())
    # the raw handle of the card's current stream, read at call time (what
    # torch.cuda.current_stream(dev).cuda_stream gives, without building a
    # Stream object: 0.1 us for 3-4 us)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = launch(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"hamming_top2 kernel launch failed: cudaError {err}")
    hamming_top2.launches += 1
    d1, i1, d2 = out.unbind(-2)
    return d1, i1.view(torch.int32), d2


hamming_top2.launches = 0

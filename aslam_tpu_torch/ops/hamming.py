"""Batched 256-bit Hamming distance — the matcher's core primitive.

Port of `aslam_tpu/ops/hamming.py` for packed binary descriptors (int32
[N,8] words holding uint32 bit patterns, see `ops/orb.py`).

  * `distance_matrix_popcount`: XOR plus a bit-sliced popcount, the exact
    definition.
  * `distance_matrix`: D = (256 - A·Bᵀ)/2 over ±1 planes.  Every dot product
    is an integer in [-256, 256] and the matmul runs in full float32
    (`device.py`), so it is exact and equal to the popcount.

The float (SIFT-family) L2 path of the reference is not ported yet.
"""

from __future__ import annotations

import torch

from aslam_tpu_torch.ops.orb import unpack_bits

BITS = 256
INVALID_DIST = 1e6


def signs_from_packed(words: torch.Tensor) -> torch.Tensor:
    """int32 [N,8] -> ±1 float32 [N,256]."""
    return unpack_bits(words).to(torch.float32) * 2.0 - 1.0


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Hamming distances [Na, Nb] float32 over packed descriptors."""
    dot = signs_from_packed(desc_a) @ signs_from_packed(desc_b).T
    return (BITS - dot) * 0.5


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of the low 32 bits of int64 values (SWAR bit slicing)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def distance_matrix_popcount(desc_a: torch.Tensor,
                             desc_b: torch.Tensor) -> torch.Tensor:
    """Exact XOR/popcount Hamming distances [Na, Nb] float32."""
    x = desc_a.to(torch.int64)[:, None, :] ^ desc_b.to(torch.int64)[None, :, :]
    return torch.sum(_popcount32(x), dim=-1).to(torch.float32)


def masked_distance_matrix(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
) -> torch.Tensor:
    """Distance matrix with INVALID_DIST where either side is padding."""
    d = distance_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    return torch.where(mask, d, torch.full_like(d, INVALID_DIST))

"""Descriptor distances — the matcher's core primitive.

Port of `aslam_tpu/ops/hamming.py`.  Binary descriptors are packed int32
[N,8] words holding uint32 bit patterns (see `ops/orb.py`); the SIFT family
is float32 [N,128].

  * `distance_matrix_popcount`: XOR plus a bit-sliced popcount, the exact
    Hamming definition.
  * `distance_matrix`: dispatches on the dtype, as the reference does.  For
    packed words, D = (256 - A·Bᵀ)/2 over ±1 planes: every dot product is an
    integer in [-256, 256] and the matmul runs in full float32
    (`device.py`), so it is exact and equal to the popcount.  For float
    descriptors, `l2_distance_matrix`.

Each takes a leading batch axis ([..., Na, 8] x [..., Nb, 8] -> [..., Na,
Nb]): a batched matmul over the lanes.
"""

from __future__ import annotations

import torch

from aslam_tpu_torch.ops.orb import unpack_bits

BITS = 256
INVALID_DIST = 1e6


def signs_from_packed(words: torch.Tensor) -> torch.Tensor:
    """int32 [..., N, 8] -> ±1 float32 [..., N, 256]."""
    return unpack_bits(words).to(torch.float32) * 2.0 - 1.0


def is_packed(desc: torch.Tensor) -> bool:
    """True for packed binary words (int32, or uint32 where the caller has
    them), False for float descriptors."""
    return desc.dtype in (torch.int32, torch.uint32)


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Descriptor distances [..., Na, Nb] float32: Hamming over packed
    words, L2 over float descriptors (the reference's dtype dispatch)."""
    if not is_packed(desc_a):
        return l2_distance_matrix(desc_a, desc_b)
    dot = signs_from_packed(desc_a) @ signs_from_packed(desc_b).transpose(-1, -2)
    return (BITS - dot) * 0.5


def l2_distance_matrix(desc_a: torch.Tensor,
                       desc_b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [..., Na, Nb] float32 between float descriptors:
    |a-b|² = |a|² + |b|² - 2ab, the cross term a full-float32 matmul."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    sq = (torch.sum(a * a, dim=-1)[..., :, None]
          + torch.sum(b * b, dim=-1)[..., None, :]
          - 2.0 * (a @ b.transpose(-1, -2)))
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of the low 32 bits of int64 values (SWAR bit slicing)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def distance_matrix_popcount(desc_a: torch.Tensor,
                             desc_b: torch.Tensor) -> torch.Tensor:
    """Exact XOR/popcount Hamming distances [..., Na, Nb] float32 between
    [..., Na, 8] and [..., Nb, 8] descriptor sets (batched over the leading
    dims, as the reference vmaps it)."""
    x = (desc_a.to(torch.int64)[..., :, None, :]
         ^ desc_b.to(torch.int64)[..., None, :, :])
    return torch.sum(_popcount32(x), dim=-1).to(torch.float32)


def masked_distance_matrix(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
) -> torch.Tensor:
    """Distance matrix with INVALID_DIST where either side is padding."""
    d = distance_matrix(desc_a, desc_b)
    mask = valid_a[..., :, None] & valid_b[..., None, :]
    return torch.where(mask, d, torch.full_like(d, INVALID_DIST))

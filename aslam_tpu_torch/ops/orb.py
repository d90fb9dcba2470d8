"""Oriented-BRIEF descriptors: patch extraction, IC angle, rBRIEF, packing.

Port of `aslam_tpu/ops/orb.py`.  The sampling pattern is the reference's
own seeded construction (`brief_pattern`, seed 0x0B5E55ED), copied here in
numpy.  The reference evaluates rBRIEF as a [K,961] @ [961,30*256] matmul
with ±1 comparison rows, which stands in for a gather on the TPU; the port
gathers the two pixels of each rotated test pair from per-bin index tables
built with the same rotation and rounding.  Both read `I(p1') < I(p2')`, and
a pair that rotates onto one pixel is 0 in both, so the bits are the same
and no matmul precision is involved.

Descriptors are packed into int32 words [K, 8] holding the reference's
uint32 bit patterns (bit i -> word i // 32): torch on the CPU has no shift
for uint32, and an arithmetic shift of int32 followed by `& 1` reads every
bit, bit 31 included.

`extract_patches` takes a leading batch axis (img [..., H, W], xy [..., K,
2]) and gathers each lane's patches from its own image, and `ic_angle` takes
the batch of patches with one product per lane (a [B*K, 961] product rounds
its rows otherwise than the [K, 961] one on an H100, and an angle an ulp off
can change a rotation bin).  What follows the angle works on rows, so a
batch is folded into them ([B*K, 31, 31]).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aslam_tpu_torch.ops.index import take_pixels

PATCH_RADIUS = 15
PATCH = 2 * PATCH_RADIUS + 1  # 31
N_BITS = 256
N_ANGLE_BINS = 30  # the ORB paper's 2*pi/30 rotation quantization


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2) test-pair offsets, all within the
    radius-15 disc so any in-plane rotation stays inside the 31x31 patch."""
    rng = np.random.default_rng(0x0B5E55ED)
    sigma = PATCH / 5.0

    def sample(n):
        pts = np.empty((0, 2), np.float64)
        while len(pts) < n:
            cand = rng.normal(0.0, sigma, (2 * n, 2))
            keep = np.linalg.norm(cand, axis=1) <= PATCH_RADIUS - 0.5
            pts = np.concatenate([pts, cand[keep]])
        return np.round(pts[:n]).astype(np.int32)

    p1 = sample(N_BITS)
    p2 = sample(N_BITS)
    # avoid degenerate identical pairs
    same = np.all(p1 == p2, axis=1)
    p2[same, 0] = np.clip(p2[same, 0] + 1, -PATCH_RADIUS + 1, PATCH_RADIUS - 1)
    return np.concatenate([p1, p2], axis=1)


@functools.lru_cache(maxsize=1)
def _circle_weights() -> tuple[np.ndarray, np.ndarray]:
    """(x-weights, y-weights) [961] of the IC-angle circular patch."""
    ys, xs = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                      -PATCH_RADIUS:PATCH_RADIUS + 1]
    mask = (xs * xs + ys * ys) <= PATCH_RADIUS * PATCH_RADIUS
    return ((xs * mask).astype(np.float32).reshape(-1),
            (ys * mask).astype(np.float32).reshape(-1))


@functools.lru_cache(maxsize=1)
def _binned_pair_index() -> np.ndarray:
    """[N_ANGLE_BINS, 256, 2] int64 flat patch indices of (p1', p2'): test
    pair t rotated by bin angle b, with the rotation and rounding of
    `aslam_tpu/ops/orb.py::_binned_delta_rows`."""
    pat = brief_pattern().astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, N_BITS, 2), np.int64)
    for b in range(N_ANGLE_BINS):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        for t, (px, py, qx, qy) in enumerate(pat):
            for j, (x, y) in enumerate(((px, py), (qx, qy))):
                ix = int(np.clip(np.round(x * ca - y * sa),
                                 -PATCH_RADIUS, PATCH_RADIUS))
                iy = int(np.clip(np.round(x * sa + y * ca),
                                 -PATCH_RADIUS, PATCH_RADIUS))
                out[b, t, j] = (iy + PATCH_RADIUS) * PATCH + ix + PATCH_RADIUS
    return out


@functools.lru_cache(maxsize=8)
def _tables_on(device: torch.device):
    """(wx, wy, binned pair index) on `device`, copied there once: a copy
    from host memory waits for the device's stream."""
    wx, wy = _circle_weights()
    return tuple(torch.from_numpy(a).to(device)
                 for a in (wx, wy, _binned_pair_index()))


def extract_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Gather 31x31 patches centred at the rounded keypoint coords, clamped so
    every patch fits.  img [..., H, W], xy [..., K, 2] (x, y) ->
    [..., K, 31, 31]."""
    H, W = img.shape[-2:]
    x = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), PATCH_RADIUS,
                    W - PATCH_RADIUS - 1)
    y = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), PATCH_RADIUS,
                    H - PATCH_RADIUS - 1)
    off = torch.arange(-PATCH_RADIUS, PATCH_RADIUS + 1, device=img.device)
    rows = (y[..., None] + off)[..., :, None]                # [...,K,31,1]
    cols = (x[..., None] + off)[..., None, :]                # [...,K,1,31]
    rows, cols = torch.broadcast_tensors(rows, cols)
    return take_pixels(img, rows, cols)


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per patch: [..., K, 31, 31] -> [..., K]
    radians."""
    if patches.dim() > 3:
        lanes = patches.reshape((-1,) + patches.shape[-3:])
        return torch.stack([ic_angle(p) for p in lanes]).reshape(
            patches.shape[:-2])
    wx, wy, _ = _tables_on(patches.device)
    flat = patches.reshape(patches.shape[0], PATCH * PATCH)
    m10 = flat @ wx
    m01 = flat @ wy
    return torch.atan2(m01, m10)


def angle_bins(angles: torch.Tensor) -> torch.Tensor:
    """[K] radians -> [K] int64 rotation bin in [0, 30), rounded to nearest."""
    two_pi = 2.0 * np.pi
    r = torch.fmod(angles, two_pi)
    r = torch.where(r < 0, r + two_pi, r)           # jnp.mod's sign rule
    bin_f = torch.round(r / two_pi * N_ANGLE_BINS)
    return torch.remainder(bin_f.to(torch.int64), N_ANGLE_BINS)


def brief_descriptors(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotation-steered BRIEF: [K,31,31] patches + [K] angles -> bits [K,256].
    Bit t is I(p1') < I(p2') for test pair t rotated by the angle's bin."""
    K = patches.shape[0]
    flat = patches.reshape(K, PATCH * PATCH)
    table = _tables_on(patches.device)[2]
    idx = table[angle_bins(angles)]                          # [K,256,2]
    i1 = torch.gather(flat, 1, idx[..., 0])
    i2 = torch.gather(flat, 1, idx[..., 1])
    return i1 < i2


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bool [K,256] -> int32 [K,8] words holding the uint32 bit patterns."""
    K = bits.shape[0]
    b = bits.reshape(K, 8, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)                   # [0, 2^32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 [..., 8] -> bool [..., 256]."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    b = (words[..., None] >> shifts) & 1
    return b.reshape(words.shape[:-1] + (N_BITS,)).to(torch.bool)


def describe_patches(patches: torch.Tensor, angles: torch.Tensor):
    """[K,31,31] patches and their [K] angles -> desc [K,8] int32."""
    return pack_bits(brief_descriptors(patches, angles))


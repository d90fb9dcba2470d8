"""Descriptor families: ORB (rBRIEF), BRIEF, FREAK-style and LATCH-style
(binary), and a SIFT-style float descriptor.

Port of `aslam_tpu/ops/desc.py`.  Every family samples the same 31x31
patches as `ops/orb.py`.  The binary families pack to the same int32 [K,8]
words (uint32 bit patterns), so they share the Hamming matcher and the
`hamming_top2` kernel; SIFT is float32 [K,128] and matches through the L2
path of `ops/hamming.py`.

The sampling patterns come from the reference's seeded numpy generators
(`_freak_pattern`, `_latch_pattern`, `_sift_grid`), copied here verbatim, so
they are the reference's bit for bit.  `jnp.round` and `torch.round` both
round half to even.  The few-term sums behind the bits (a FREAK field's mean
over 9 samples, a LATCH window's SSD over 9 pixels) are added in index
order, as XLA's loop adds them.

`describe(name, img_blurred [H,W], xy [K,2]) -> (desc, angle [K])` runs a
family's `*_from_patches(patches, angles)` on `extract_patches` and
`ic_angle`, the intensity-centroid angle that FREAK, LATCH and SIFT steer
by.  It also takes a batch (img [B,H,W], xy [B,K,2]): it gathers each
lane's patches from its own image, takes the angles per lane (`ops/orb.py`
says why) and folds the batch into the patch rows, so every family runs
batched through the same code as one image.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aslam_tpu_torch.ops import orb
from aslam_tpu_torch.ops.orb import (N_BITS, PATCH, PATCH_RADIUS,
                                     brief_descriptors, extract_patches,
                                     ic_angle, pack_bits)

SIFT_DIM = 128


def _rotated_index(ox, oy, ca, sa):
    """Flat patch index of offsets (ox, oy) rotated by each keypoint's
    angle, rounded half to even and clamped into the patch.
    ox, oy broadcast against ca, sa [K, 1, ...]."""
    rx = ox * ca - oy * sa
    ry = ox * sa + oy * ca
    ix = torch.clamp(torch.round(rx).to(torch.int64), -PATCH_RADIUS,
                     PATCH_RADIUS)
    iy = torch.clamp(torch.round(ry).to(torch.int64), -PATCH_RADIUS,
                     PATCH_RADIUS)
    return (iy + PATCH_RADIUS) * PATCH + (ix + PATCH_RADIUS)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


@functools.lru_cache(maxsize=8)
def _on(device: torch.device, which: str) -> tuple[torch.Tensor, ...]:
    """A family's pattern tables on `device`, copied there once: a copy from
    host memory waits for the device's stream."""
    if which == "freak":
        pts, pairs = _freak_pattern()
        return (torch.from_numpy(pts).to(device),
                torch.from_numpy(pairs.astype(np.int64)).to(device))
    if which == "latch":
        offs = np.stack(np.meshgrid(
            np.arange(-_LATCH_HALF, _LATCH_HALF + 1),
            np.arange(-_LATCH_HALF, _LATCH_HALF + 1), indexing="ij"),
            axis=-1).reshape(-1, 2)[:, ::-1].astype(np.float32)     # [9,2] (x,y)
        centers = _latch_pattern().reshape(-1, 2)                  # [768,2]
        return (torch.from_numpy(centers.copy()).to(device),
                torch.from_numpy(offs.copy()).to(device))
    offs, wmat = _sift_grid()
    return torch.from_numpy(offs).to(device), torch.from_numpy(wmat).to(device)


# --------------------------------------------------------------------------
# BRIEF: the non-steered original
# --------------------------------------------------------------------------

def brief_from_patches(patches: torch.Tensor, angles: torch.Tensor):
    """Unrotated BRIEF-256: rBRIEF's test pairs, no steering (the angle is
    reported, not applied)."""
    return pack_bits(brief_descriptors(patches, torch.zeros_like(angles)))


# --------------------------------------------------------------------------
# FREAK-style: retinal sampling pattern (coarse periphery, fine fovea)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _freak_pattern() -> tuple[np.ndarray, np.ndarray]:
    """Retina: 43 receptive fields = center + 7 rings x 6 points, radius and
    smoothing growing with eccentricity (the FREAK paper's layout).

    Returns (points [43, S, 2] float32 sample offsets per field — each field
    is averaged over S=9 samples within its smoothing disc — and
    pairs [256, 2] int32 field-index pairs).
    """
    rng = np.random.default_rng(0xF4EAC0DE)
    fields = [np.zeros((1, 2))]  # field centers; smoothing radii below
    radii = [0.8]
    n_rings = 7
    for r in range(n_rings):
        rho = 1.8 * (1.35 ** r)             # 1.8 .. ~11.1  (< PATCH_RADIUS-2)
        smooth = 0.5 + 0.35 * rho           # grows with eccentricity
        phase = (np.pi / 6.0) * (r % 2)     # stagger alternate rings
        for i in range(6):
            a = phase + i * np.pi / 3.0
            fields.append(np.array([[rho * np.cos(a), rho * np.sin(a)]]))
            radii.append(smooth)
    centers = np.concatenate(fields, axis=0)            # [43,2]
    # 9 fixed sub-samples per field: center + 8-point ring at the smoothing
    # radius — a box approximation of the per-field Gaussian window
    ring = np.stack(
        [np.zeros(2)]
        + [
            np.array([np.cos(a), np.sin(a)])
            for a in np.linspace(0, 2 * np.pi, 9)[:-1]
        ]
    )                                                     # [9,2]
    pts = centers[:, None, :] + ring[None, :, :] * np.asarray(radii)[:, None, None]
    # 256 comparison pairs out of the 903 possible, seeded + deduped,
    # biased to include every field at least once (coarse-to-fine mix)
    all_pairs = np.array([(i, j) for i in range(43) for j in range(i + 1, 43)])
    sel = rng.permutation(len(all_pairs))[:N_BITS]
    return pts.astype(np.float32), all_pairs[sel].astype(np.int32)


def _freak_index(angles: torch.Tensor) -> torch.Tensor:
    """[K, 43*9] flat patch indices of the retinal samples, steered."""
    pts, _ = _on(angles.device, "freak")                      # [43,9,2]
    ca = torch.cos(angles)[:, None, None]
    sa = torch.sin(angles)[:, None, None]
    return _rotated_index(pts[None, ..., 0], pts[None, ..., 1], ca,
                          sa).reshape(angles.shape[0], -1)


def freak_from_patches(patches: torch.Tensor,                 # [K,31,31]
                       angles: torch.Tensor):
    """FREAK-style binary descriptor: retinal field means compared in 256
    pairs, the sample points steered by the IC angle."""
    _, pairs = _on(patches.device, "freak")
    K = patches.shape[0]
    vals = torch.gather(patches.reshape(K, PATCH * PATCH), 1,
                        _freak_index(angles)).reshape(K, 43, 9)
    fields = _sum_last(vals) / 9.0                            # [K,43]
    bits = fields[:, pairs[:, 0]] < fields[:, pairs[:, 1]]
    return pack_bits(bits)


# --------------------------------------------------------------------------
# LATCH-style: triplet mini-patch comparisons
# --------------------------------------------------------------------------

_LATCH_HALF = 1  # 3x3 mini-patches


@functools.lru_cache(maxsize=1)
def _latch_pattern() -> np.ndarray:
    """[256, 3, 2] float32: (anchor, p1, p2) mini-patch centers per bit,
    inside radius 12 so rotated 3x3 windows stay in the 31x31 patch."""
    rng = np.random.default_rng(0x1A7C4)
    lim = PATCH_RADIUS - _LATCH_HALF - 2  # 12
    out = np.empty((N_BITS, 3, 2), np.float64)
    n = 0
    while n < N_BITS:
        cand = rng.normal(0.0, PATCH / 6.0, (3, 2))
        if np.all(np.linalg.norm(cand, axis=1) <= lim) and (
            np.linalg.norm(cand[1] - cand[2]) > 1.5
        ):
            out[n] = cand
            n += 1
    return out.astype(np.float32)


def _latch_index(angles: torch.Tensor) -> torch.Tensor:
    """[K, 768*9] flat patch indices of the triplets' 3x3 windows: centers
    steered, offsets added unrotated (rotating them would resample all three
    windows of a triplet alike)."""
    centers, offs = _on(angles.device, "latch")               # [768,2], [9,2]
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    rx = centers[None, :, 0] * ca - centers[None, :, 1] * sa  # [K,768]
    ry = centers[None, :, 0] * sa + centers[None, :, 1] * ca
    sx = rx[:, :, None] + offs[None, None, :, 0]              # [K,768,9]
    sy = ry[:, :, None] + offs[None, None, :, 1]
    ix = torch.clamp(torch.round(sx).to(torch.int64), -PATCH_RADIUS,
                     PATCH_RADIUS)
    iy = torch.clamp(torch.round(sy).to(torch.int64), -PATCH_RADIUS,
                     PATCH_RADIUS)
    idx = (iy + PATCH_RADIUS) * PATCH + (ix + PATCH_RADIUS)
    return idx.reshape(angles.shape[0], -1)


def latch_from_patches(patches: torch.Tensor,                 # [K,31,31]
                       angles: torch.Tensor):
    """LATCH-style binary descriptor: bit b is SSD(anchor_b, p1_b) <
    SSD(anchor_b, p2_b) over 3x3 windows around steered centers."""
    K = patches.shape[0]
    vals = torch.gather(patches.reshape(K, PATCH * PATCH), 1,
                        _latch_index(angles))
    windows = vals.reshape(K, N_BITS, 3, 9)                   # anchor, p1, p2
    ssd1 = _sum_last((windows[:, :, 0] - windows[:, :, 1]) ** 2)
    ssd2 = _sum_last((windows[:, :, 0] - windows[:, :, 2]) ** 2)
    return pack_bits(ssd1 < ssd2)


# --------------------------------------------------------------------------
# SIFT-style float descriptor (4x4 cells x 8 orientation bins)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _sift_grid() -> tuple[np.ndarray, np.ndarray]:
    """16x16 sample grid in the kp frame: (offsets [256,2] float32,
    spatial weights [256,16] float32 — bilinear share of each sample into
    the 4x4 descriptor cells, Gaussian-windowed)."""
    step = 24.0 / 16.0  # 24-px descriptor window inside the 31-px patch
    coords = (np.arange(16) - 7.5) * step
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    offs = np.stack([gx.ravel(), gy.ravel()], axis=-1)   # [256,2] (x,y)

    # continuous cell coordinates in [0,4): sample -> (cx, cy)
    cell = (offs / (4.0 * step)) + 2.0 - 0.5             # center-of-cell frame
    w = np.zeros((256, 16), np.float64)
    sigma = 8.0
    gauss = np.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2) / (2 * sigma * sigma))
    for s in range(256):
        cx, cy = cell[s]
        for iy in (int(np.floor(cy)), int(np.floor(cy)) + 1):
            for ix in (int(np.floor(cx)), int(np.floor(cx)) + 1):
                if 0 <= ix < 4 and 0 <= iy < 4:
                    wxy = (1 - abs(cx - ix)) * (1 - abs(cy - iy))
                    w[s, iy * 4 + ix] = wxy * gauss[s]
    return offs.astype(np.float32), w.astype(np.float32)


_SIFT_STEPS = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))


def _sift_index(angles: torch.Tensor) -> torch.Tensor:
    """[K, 4*256] flat patch indices of the 16x16 grid shifted one pixel
    right, left, down and up along the steered axes."""
    offs, _ = _on(angles.device, "sift")                      # [256,2]
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    return torch.cat([_rotated_index((offs[:, 0] + dx)[None],
                                     (offs[:, 1] + dy)[None], ca, sa)
                      for dx, dy in _SIFT_STEPS], 1)


def describe_sift(img_blurred: torch.Tensor, xy: torch.Tensor):
    """SIFT-style 128-d float descriptor, steered by the IC angle,
    L2-normalized with the 0.2 clip and renormalization of the original.
    Gradients are finite differences between rotated-grid gathers, so the
    orientations are relative to the keypoint's angle.
    -> ([K,128] float32, angle [K])."""
    patches = extract_patches(img_blurred, xy)
    angles = ic_angle(patches)
    return sift_from_patches(patches, angles), angles


def sift_from_patches(patches: torch.Tensor,                  # [K,31,31]
                      angles: torch.Tensor):
    _, wmat = _on(patches.device, "sift")                     # [256,16]
    K = patches.shape[0]
    right, left, down, up = torch.gather(
        patches.reshape(K, PATCH * PATCH), 1, _sift_index(angles)
    ).reshape(K, 4, 256).unbind(1)
    gx = 0.5 * (right - left)
    gy = 0.5 * (down - up)
    mag = torch.sqrt(gx * gx + gy * gy)                       # [K,256]
    ori = torch.atan2(gy, gx)                                 # kp frame

    # soft orientation binning into 8 bins (linear interpolation)
    bin_f = (ori + np.pi) * (8.0 / (2.0 * np.pi))             # [0,8)
    b0 = torch.floor(bin_f)
    frac = bin_f - b0
    b0i = torch.remainder(b0.to(torch.int64), 8)
    b1i = torch.remainder(b0i + 1, 8)
    bins = torch.arange(8, device=angles.device)
    obin = ((bins == b0i[..., None]) * (1.0 - frac[..., None])
            + (bins == b1i[..., None]) * frac[..., None])     # [K,256,8]

    # "ks,sc,ksb->kcb": a batched matmul, in full float32 (device.py)
    hist = torch.einsum("ks,sc,ksb->kcb", mag, wmat, obin)    # [K,16,8]
    d = hist.reshape(K, SIFT_DIM)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                        min=1e-8)
    d = torch.clamp(d, max=0.2)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                        min=1e-8)
    return d


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

DESCRIPTOR_ALIASES = {
    "ORB_SLAM2": "ORB",
    "RBRIEF": "ORB",
    "BRISK": "FREAK",   # both are retinal binary patterns; one impl serves
    "SURF": "SIFT",     # float gradient-histogram family
}

_FROM_PATCHES = {
    "ORB": orb.describe_patches,
    "BRIEF": brief_from_patches,
    "FREAK": freak_from_patches,
    "LATCH": latch_from_patches,
    "SIFT": sift_from_patches,
}


def canonical(name: str) -> str:
    n = name.upper()
    n = DESCRIPTOR_ALIASES.get(n, n)
    if n not in _FROM_PATCHES:
        raise ValueError(
            f"unknown descriptor {name!r}; have {sorted(_FROM_PATCHES)} "
            f"(+ aliases {sorted(DESCRIPTOR_ALIASES)})")
    return n


def steered_index(name: str, angles: torch.Tensor) -> torch.Tensor:
    """[K, n] int64: everything a family's descriptor takes from the IC angle
    (the rotation bin for ORB, the steered sample indices for FREAK, LATCH
    and SIFT, nothing for BRIEF).  Two angle vectors that give equal rows
    here give equal descriptors on equal patches, so a row that differs
    marks a rounding tie of the angle, not a fault of the descriptor."""
    fam = canonical(name)
    if fam == "ORB":
        return orb.angle_bins(angles)[:, None]
    if fam == "BRIEF":
        return torch.zeros(angles.shape[0], 1, dtype=torch.int64,
                           device=angles.device)
    return {"FREAK": _freak_index, "LATCH": _latch_index,
            "SIFT": _sift_index}[fam](angles)


def is_binary(name: str) -> bool:
    """True: packed 256-bit Hamming descriptors; False: float L2 ones."""
    return canonical(name) != "SIFT"


def describe(name: str, img_blurred: torch.Tensor, xy: torch.Tensor):
    """img_blurred [..., H, W], xy [..., K, 2] -> (desc [..., K, 8] int32
    words, or [..., K, 128] float32 for SIFT; angle [..., K])."""
    patches = extract_patches(img_blurred, xy)                # [...,K,31,31]
    angles = ic_angle(patches)                                # [...,K]
    desc = _FROM_PATCHES[canonical(name)](
        patches.reshape((-1, PATCH, PATCH)), angles.reshape(-1))
    return desc.reshape(xy.shape[:-1] + desc.shape[-1:]), angles

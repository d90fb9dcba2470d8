"""Image pyramid + Gaussian blur.

Port of `aslam_tpu/ops/pyramid.py`.  The pyramid is the reference's
`jax.image.resize(..., "linear")`, which antialiases when it downscales:
each axis is resampled by a [in, out] triangle-kernel weight matrix built
as `jax/_src/image/scale.py::compute_weight_mat` builds it, and applied as
two matmuls (full f32, see `device.py`).  The reference evaluates those
weights in float32 inside a jitted function, where XLA rounds the sample
position's multiply-add once (a fused multiply-add) and divides by the
constant kernel scale as a multiply by its float32 reciprocal.  The port
builds them in numpy with that same float32 arithmetic, and its levels sit
within ~4e-4 gray levels of the reference's on the CPU; exact (float64)
weights would put them ~4e-3 apart and move near-tied keypoints on every
level > 0.

Every function takes [..., H, W]: an image, or a batch of images with the
batch first (batched VO, `models/batch_vo.py`).  One image runs exactly the
operations it ran before the batch axis existed.  A batch resizes with one
pair of products per image: every batched or folded form of them measured
on an H100 (cuBLAS, full float32) rounds otherwise than the single image's
call, and a level image an ulp off moves near-tied keypoints and bits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def level_shape(height: int, width: int, scale_factor: float,
                level: int) -> tuple[int, int]:
    inv = 1.0 / (scale_factor ** level)
    return max(int(round(height * inv)), 32), max(int(round(width * inv)), 32)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 antialiased triangle-kernel weights, in the
    float32 arithmetic of the reference's jitted evaluation."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    # (i + 0.5) * inv_scale - 0.5, rounded once: the product of two float32
    # values is exact in float64, and so is the difference
    centre = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (centre.astype(np.float64) * float(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - x * (f32(1.0) / kernel_scale))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights_on(n_in: int, n_out: int,
                       device: torch.device) -> torch.Tensor:
    """`_resize_weights` on `device`, copied there once: a copy from host
    memory waits for the device's stream."""
    return torch.from_numpy(_resize_weights(n_in, n_out)).to(device)


def resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., H, W] float32 -> [..., h, w], antialiased linear resampling."""
    H, W = img.shape[-2:]
    wy = _resize_weights_on(H, h, img.device)
    wx = _resize_weights_on(W, w, img.device)
    if img.dim() == 2:
        return wy.T @ img @ wx
    return torch.stack([wy.T @ x @ wx for x in img.reshape(-1, H, W)]).reshape(
        img.shape[:-2] + (h, w))


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float) -> list[torch.Tensor]:
    """img [..., H, W] float32 -> n_levels images, level l scaled by
    scale_factor^-l, each resized from the previous level."""
    H, W = img.shape[-2:]
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize(levels[-1], *level_shape(H, W, scale_factor, l)))
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(ksize: int, sigma: float) -> tuple[float, ...]:
    half = ksize // 2
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-half, half + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with edge replication, [..., H, W] -> same.

    The reference's shifted-slice multiply-adds, in the same order, so the
    result matches it to float32 rounding (and no cuDNN convolution, with
    its TF32 default, is involved)."""
    k = _gaussian_kernel(ksize, sigma)
    half = ksize // 2
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    x = torch.cat([img[..., :1, :].expand(lead + (half, W)), img,
                   img[..., -1:, :].expand(lead + (half, W))], -2)
    y = torch.zeros_like(img)
    for i in range(ksize):
        y = y + float(k[i]) * x[..., i:i + H, :]
    x = torch.cat([y[..., :1].expand(lead + (H, half)), y,
                   y[..., -1:].expand(lead + (H, half))], -1)
    y = torch.zeros_like(img)
    for i in range(ksize):
        y = y + float(k[i]) * x[..., i:i + W]
    return y

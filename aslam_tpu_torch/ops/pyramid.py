"""Image pyramid + Gaussian blur.

Port of `aslam_tpu/ops/pyramid.py`.  The pyramid is the reference's
`jax.image.resize(..., "linear")`, which antialiases when it downscales:
each axis is resampled by a [in, out] triangle-kernel weight matrix built
as `jax/_src/image/scale.py::compute_weight_mat` builds it.  Here those
matrices are built in float64 numpy, cast to float32 and applied as two
matmuls (full f32, see `device.py`).  JAX's own float32 evaluation of them
sits about 4e-3 gray levels from the exact result, so the port and the
reference agree to that order, not bit for bit.
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
    """[n_in, n_out] float32 antialiased triangle-kernel weights."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H,W] float32 -> [h,w], antialiased linear resampling."""
    H, W = img.shape
    wy = torch.from_numpy(_resize_weights(H, h)).to(img.device)
    wx = torch.from_numpy(_resize_weights(W, w)).to(img.device)
    return wy.T @ img @ wx


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float) -> list[torch.Tensor]:
    """img [H,W] float32 -> n_levels images, level l scaled by
    scale_factor^-l, each resized from the previous level."""
    H, W = img.shape
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
    """Separable Gaussian blur with edge replication, [H,W] -> [H,W].

    The reference's shifted-slice multiply-adds, in the same order, so the
    result matches it to float32 rounding (and no cuDNN convolution, with
    its TF32 default, is involved)."""
    k = _gaussian_kernel(ksize, sigma)
    half = ksize // 2
    H, W = img.shape
    x = torch.cat([img[:1].expand(half, W), img, img[-1:].expand(half, W)], 0)
    y = torch.zeros_like(img)
    for i in range(ksize):
        y = y + float(k[i]) * x[i:i + H]
    x = torch.cat([y[:, :1].expand(H, half), y, y[:, -1:].expand(H, half)], 1)
    y = torch.zeros_like(img)
    for i in range(ksize):
        y = y + float(k[i]) * x[:, i:i + W]
    return y

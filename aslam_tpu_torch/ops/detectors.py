"""Dense corner / blob response maps for the detector families other than FAST.

Port of `aslam_tpu/ops/detectors.py`.  Every family is a whole-image
response map in intensity-like units (0..255-scale images), 0 where there is
no detection, that feeds the same NMS -> grid top-k -> adaptive threshold
pipeline as FAST (`ops/fast.py`), so the adaptive mode works for every
family.  Per-family threshold defaults and clamps are in `DETECTOR_DEFAULTS`.

Signature (as `fast.fast_response`): ``response(img, threshold)`` with
``img [..., H, W] float32`` (one image, or a batch with the batch first) and
a scalar or [..., H, W] ``threshold`` -> [..., H, W] float32.

`jnp.roll` wraps around the edge, as `torch.roll` does; the border strip it
spoils is cleared by `_gate`.  The reference's `lax.reduce_window` sum with
"SAME" zero padding is `avg_pool2d` with `divisor_override=1`, which sums
each window in row-major order from zero on the CPU and on the card alike
(no cumulative-sum box, whose float sums are not deterministic on CUDA).
DoG and Hessian blur with `ops/pyramid.py::gaussian_blur`, which keeps the
reference's order of multiply-adds and stays off cuDNN's TF32.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from aslam_tpu_torch.ops import fast, pyramid

# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


def _box_sum(img: torch.Tensor, n: int) -> torch.Tensor:
    """Sum over an n x n window, n odd, zero padding n // 2 (SAME)."""
    H, W = img.shape[-2:]
    return F.avg_pool2d(img.reshape(-1, 1, H, W), n, stride=1, padding=n // 2,
                        count_include_pad=True,
                        divisor_override=1).reshape(img.shape)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img[y + dy, x + dx] at (y, x), wrapping around the edge."""
    return torch.roll(img, (-dy, -dx), (-2, -1))


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel derivatives (Ix, Iy), normalized to intensity/pixel units."""
    def sh(dy, dx):
        return _shift(img, dy, dx)

    # smoothed central differences: [1,2,1]^T x [-1,0,1] / 8
    ix = ((sh(-1, 1) - sh(-1, -1))
          + 2.0 * (sh(0, 1) - sh(0, -1))
          + (sh(1, 1) - sh(1, -1))) * 0.125
    iy = ((sh(1, -1) - sh(-1, -1))
          + 2.0 * (sh(1, 0) - sh(-1, 0))
          + (sh(1, 1) - sh(-1, 1))) * 0.125
    return ix, iy


def structure_tensor(img: torch.Tensor, block: int = 3):
    """(Sxx, Sxy, Syy): gradient outer products averaged over block x block."""
    ix, iy = sobel_gradients(img)
    inv = 1.0 / (block * block)
    return (_box_sum(ix * ix, block) * inv,
            _box_sum(ix * iy, block) * inv,
            _box_sum(iy * iy, block) * inv)


def _border_mask(img: torch.Tensor, b: int) -> torch.Tensor:
    H, W = img.shape[-2:]
    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    return (row >= b) & (row < H - b) & (col >= b) & (col < W - b)


def _gate(raw: torch.Tensor, threshold, border: int) -> torch.Tensor:
    t = torch.as_tensor(threshold, dtype=raw.dtype, device=raw.device)
    zero = torch.zeros_like(raw)
    r = torch.where(raw > t, raw, zero)
    return torch.where(_border_mask(raw, border), r, zero)


# --------------------------------------------------------------------------
# detector families
# --------------------------------------------------------------------------


def gftt_response(img: torch.Tensor, threshold) -> torch.Tensor:
    """Shi-Tomasi: sqrt(min eigenvalue of the 3x3-averaged structure tensor)."""
    sxx, sxy, syy = structure_tensor(img)
    half_tr = 0.5 * (sxx + syy)
    disc = torch.sqrt(torch.clamp((0.5 * (sxx - syy)) ** 2 + sxy * sxy,
                                  min=0.0))
    min_eig = torch.clamp(half_tr - disc, min=0.0)
    return _gate(torch.sqrt(min_eig), threshold, border=3)


def harris_response(img: torch.Tensor, threshold, k: float = 0.04):
    """Harris corner score, 4th-rooted into intensity units."""
    sxx, sxy, syy = structure_tensor(img)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    r = torch.clamp(det - k * tr * tr, min=0.0)
    return _gate(torch.sqrt(torch.sqrt(r)), threshold, border=3)


def dog_response(img: torch.Tensor, threshold, sigma: float = 1.0,
                 k: float = 1.6) -> torch.Tensor:
    """|Difference of Gaussians| blob response (the SIFT detector per level)."""
    g1 = pyramid.gaussian_blur(img, ksize=7, sigma=sigma)
    g2 = pyramid.gaussian_blur(img, ksize=9, sigma=sigma * k)
    return _gate(torch.abs(g1 - g2), threshold, border=4)


def hessian_response(img: torch.Tensor, threshold,
                     sigma: float = 1.2) -> torch.Tensor:
    """sqrt(max(det Hessian, 0)) of the blurred image (the SURF detector's
    quantity, with exact second differences)."""
    g = pyramid.gaussian_blur(img, ksize=7, sigma=sigma)

    def sh(dy, dx):
        return _shift(g, dy, dx)

    dxx = sh(0, 1) - 2.0 * g + sh(0, -1)
    dyy = sh(1, 0) - 2.0 * g + sh(-1, 0)
    dxy = 0.25 * (sh(1, 1) - sh(1, -1) - sh(-1, 1) + sh(-1, -1))
    det = dxx * dyy - dxy * dxy
    return _gate(torch.sqrt(torch.clamp(det, min=0.0)), threshold, border=4)


def star_response(img: torch.Tensor, threshold,
                  scales: tuple[int, ...] = (2, 4, 6)) -> torch.Tensor:
    """Center-surround (CenSurE / STAR) difference of boxes, max over scales:
    per scale s, |mean(box 2s+1) - mean(box 4s+1)|."""
    resp = None
    for s in scales:
        inner_n, outer_n = 2 * s + 1, 4 * s + 1
        inner = _box_sum(img, inner_n) / float(inner_n * inner_n)
        outer = _box_sum(img, outer_n) / float(outer_n * outer_n)
        r = torch.abs(inner - outer)
        resp = r if resp is None else torch.maximum(resp, r)
    return _gate(resp, threshold, border=2 * max(scales))


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

ResponseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# thresholds in each response's intensity-like units (the reference's
# calibration; the x0.7 / x1.3 controller makes the initial value uncritical)
DETECTOR_DEFAULTS: dict[str, dict[str, float]] = {
    "FAST": dict(threshold=20.0, th_min=2.0, th_max=80.0),
    "GFTT": dict(threshold=15.0, th_min=1.5, th_max=120.0),
    "HARRIS": dict(threshold=10.0, th_min=1.0, th_max=90.0),
    "DOG": dict(threshold=2.0, th_min=0.2, th_max=30.0),
    "HESSIAN": dict(threshold=4.0, th_min=0.4, th_max=60.0),
    "STAR": dict(threshold=8.0, th_min=0.8, th_max=80.0),
}

# the reference's enum spellings -> the families here
DETECTOR_ALIASES = {
    "ORB": "FAST",        # ORB's detector is FAST + Harris ordering
    "ORB_SLAM2": "FAST",
    "BRISK": "FAST",      # BRISK's detector is AGAST, a FAST variant
    "AGAST": "FAST",
    "SIFT": "DOG",
    "SURF": "HESSIAN",
    "SHI_TOMASI": "GFTT",
    "CENSURE": "STAR",
}

_RESPONSE_FNS: dict[str, ResponseFn] = {
    "FAST": fast.fast_response,
    "GFTT": gftt_response,
    "HARRIS": harris_response,
    "DOG": dog_response,
    "HESSIAN": hessian_response,
    "STAR": star_response,
}


def canonical(name: str) -> str:
    n = name.upper()
    n = DETECTOR_ALIASES.get(n, n)
    if n not in _RESPONSE_FNS:
        raise ValueError(
            f"unknown detector {name!r}; have {sorted(_RESPONSE_FNS)} "
            f"(+ aliases {sorted(DETECTOR_ALIASES)})")
    return n


def response(name: str, img: torch.Tensor, threshold) -> torch.Tensor:
    """Dispatch a detector family by name (reference aliases accepted)."""
    return _RESPONSE_FNS[canonical(name)](img, threshold)


def defaults(name: str) -> dict[str, float]:
    return DETECTOR_DEFAULTS[canonical(name)]

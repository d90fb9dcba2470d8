"""Parallel-hypothesis Mahalanobis 3D-3D RANSAC.

Port of `aslam_tpu/ops/ransac.py`: all hypotheses are scored at once; one
batched sample -> weighted-Kabsch fit -> `refine_iters` rounds of
(Mahalanobis gate -> masked refit) -> argmax.  Hypothesis 0 is the identity
(the reference's identity rescue).  The per-point covariance is
diag(rx² z, ry² z, (c z²)²), the source covariance rotated as R Σ Rᵀ, and
fit weights are 1/(z1 z2).

The samples are the one place where the port cannot reproduce the
reference's numbers: JAX draws them with `jax.random.randint`.  So
`ransac_align` takes the raw draws as an optional `draws [H,S]` tensor of
integers in [0, n_good) (the values the reference draws before its
`searchsorted`); a test passes the reference's draws.  Without it the port
draws floor(U * n_good) on the device from `generator`, with no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from aslam_tpu_torch.config import CameraModel, RansacConfig
from aslam_tpu_torch.ops.linalg import chol_solve
from aslam_tpu_torch.utils.se3 import weighted_kabsch


class RansacResult(NamedTuple):
    T12: torch.Tensor          # [4,4] source-cam -> target-cam transform
    inliers: torch.Tensor      # [M] bool inlier mask over the match pool
    n_inliers: torch.Tensor    # scalar int32
    rmse: torch.Tensor         # scalar float32: sqrt(mean sq. mahalanobis)
    ok: torch.Tensor           # scalar bool: n_inliers >= min_inliers


def _point_cov_diag(p: torch.Tensor, cam: CameraModel, depth_std_c: float):
    """Per-point diagonal covariance entries [..., 3]."""
    rx = 3.0 * math.tan(math.radians(cam.fov_x_deg) / cam.width)
    ry = 3.0 * math.tan(math.radians(cam.fov_y_deg) / cam.height)
    z = p[..., 2]
    sz = depth_std_c * z * z
    return torch.stack([rx * rx * z, ry * ry * z, sz * sz], dim=-1)


def mahalanobis_sq(p1: torch.Tensor, p2: torch.Tensor, T12: torch.Tensor,
                   cam: CameraModel, depth_std_c: float) -> torch.Tensor:
    """Squared Mahalanobis distance of T12*p1 vs p2 under the summed
    anisotropic covariances.  p1, p2 [..., M, 3]; T12 [..., 4, 4]."""
    R = T12[..., :3, :3]
    t = T12[..., :3, 3]
    delta = p1 @ R.transpose(-1, -2) + t[..., None, :] - p2
    c1 = _point_cov_diag(p1, cam, depth_std_c)
    c2 = _point_cov_diag(p2, cam, depth_std_c)
    Rc = R[..., None, :, :]
    sigma = (Rc * c1[..., None, :]) @ Rc.transpose(-1, -2)
    sigma = sigma + torch.diag_embed(c2)
    sigma = sigma + torch.eye(3, dtype=sigma.dtype, device=sigma.device) * 1e-12
    sol = chol_solve(sigma, delta)
    return torch.sum(delta * sol, dim=-1)


def _score(n_inl: torch.Tensor, rmse: torch.Tensor) -> torch.Tensor:
    """Inlier count first, then low rmse."""
    return n_inl.to(torch.float32) * 16.0 - torch.clamp(rmse, max=15.9)


def sample_draws(n_good: torch.Tensor, shape: tuple[int, int],
                 generator: torch.Generator | None) -> torch.Tensor:
    """[H,S] uniform integers in [0, max(n_good,1)), drawn on n_good's device."""
    n = torch.clamp(n_good, min=1)
    u = torch.rand(shape, generator=generator, device=n_good.device)
    return torch.minimum((u * n.to(torch.float32)).to(torch.int64), n - 1)


def ransac_align(
    p1: torch.Tensor,          # [M,3] matched source points (cam-1 frame)
    p2: torch.Tensor,          # [M,3] matched target points (cam-2 frame)
    valid: torch.Tensor,       # [M] bool (padding / depth validity)
    generator: torch.Generator | None,
    cfg: RansacConfig,
    cam: CameraModel,
    draws: torch.Tensor | None = None,
) -> RansacResult:
    """Estimate T12 with p2 ~= T12 * p1 over the padded match pool."""
    M = p1.shape[0]
    dev = p1.device
    max_m2 = cfg.max_mahalanobis * cfg.max_mahalanobis

    good = valid & (p1[:, 2] > 0) & (p2[:, 2] > 0) \
        & torch.isfinite(p1[:, 2]) & torch.isfinite(p2[:, 2])
    n_good = torch.sum(good.to(torch.int32))
    w_base = torch.where(good, 1.0 / torch.clamp(p1[:, 2] * p2[:, 2], min=1e-6),
                         torch.zeros_like(p1[:, 2]))

    # uniform over the good subset via inverse CDF
    H, S = cfg.n_hypotheses, cfg.sample_size
    if draws is None:
        draws = sample_draws(n_good, (H, S), generator)
    csum = torch.cumsum(good.to(torch.int64), 0)
    sample_idx = torch.searchsorted(csum, draws.to(torch.int64).contiguous(),
                                    right=True)
    sample_idx = torch.clamp(sample_idx, 0, M - 1)

    eye4 = torch.eye(4, dtype=p1.dtype, device=dev)
    T = weighted_kabsch(p1[sample_idx], p2[sample_idx], w_base[sample_idx])
    T[0] = eye4                                      # identity hypothesis

    def eval_T(T):
        m2 = mahalanobis_sq(p1, p2, T, cam, cfg.depth_std_c)     # [H,M]
        inl = good[None, :] & (m2 <= max_m2) & (m2 >= 0.0)
        n = torch.sum(inl, dim=1)
        mean = torch.sum(torch.where(inl, m2, torch.zeros_like(m2)), dim=1) \
            / torch.clamp(n, min=1)
        rmse = torch.where(n >= 3, torch.sqrt(mean), torch.full_like(mean, 1e3))
        return inl, n.to(torch.int32), rmse

    for _ in range(cfg.refine_iters):
        inl, n, _ = eval_T(T)
        T_new = weighted_kabsch(p1, p2, w_base[None, :] * inl)
        # keep the previous T where the fit is degenerate
        T = torch.where((n < 3)[:, None, None], T, T_new)
        T[0] = eye4
    inl, n, rmse = eval_T(T)

    # first maximum; index_select keeps the pick on the device (no host sync)
    best = torch.argmax(_score(n, rmse)).reshape(1)
    n_best = n.index_select(0, best)[0]
    ok = n_best >= cfg.min_inliers
    return RansacResult(
        T12=torch.where(ok, T.index_select(0, best)[0], eye4),
        inliers=inl.index_select(0, best)[0] & ok,
        n_inliers=torch.where(ok, n_best, torch.zeros_like(n_best)),
        rmse=rmse.index_select(0, best)[0],
        ok=ok,
    )

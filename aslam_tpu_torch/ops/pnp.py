"""2D-3D PnP-RANSAC: a pose from landmark reprojections with outlier
rejection.

Port of `aslam_tpu/ops/pnp.py`.  Each of `n_hypotheses` hypotheses runs a
short Gauss-Newton pose refinement on a random correspondence subset,
starting from the prior pose; hypothesis 0 is the prior pose itself.  All
are scored by their pixel-residual inlier counts and the winner is refined
on its consensus set.  The hypotheses run as one batch ([H,...] tensors)
where the reference vmaps them.

`jax.random.randint` cannot be reproduced in torch, so `pnp_ransac` takes
the raw draws as an optional `draws [H,S]` tensor of integers in
[0, n_good) (what the reference draws before its `searchsorted`); without
it the port draws them from `generator` on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import CameraModel
from aslam_tpu_torch.ops.ba import project_residual_jac
from aslam_tpu_torch.ops.linalg import chol_solve
from aslam_tpu_torch.ops.ransac import sample_draws
from aslam_tpu_torch.utils.se3 import se3_exp


class PnPResult(NamedTuple):
    T_cw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _mono(T, pts_w, obs_uv, cam):
    """Mono reprojection residuals [...,N,2], Jacobians [...,N,2,6] and
    depth validity [...,N] of world points under poses T [...,4,4]."""
    ur = torch.full(obs_uv.shape[:-1], -1.0, dtype=obs_uv.dtype,
                    device=obs_uv.device)
    r, J, _, depth_ok = project_residual_jac(T, pts_w, obs_uv, ur, cam)
    return r[..., :2], J[..., :2, :], depth_ok


def _gn_refine(T0, pts_w, obs_uv, w, cam, iters):
    """Pose-only Gauss-Newton on weighted mono reprojection residuals;
    T0 [...,4,4], w [...,N]."""
    eye6 = torch.eye(6, dtype=pts_w.dtype, device=pts_w.device)
    T = T0
    for _ in range(iters):
        r, J, depth_ok = _mono(T, pts_w, obs_uv, cam)
        wv = w * depth_ok
        H = torch.einsum("...n,...nri,...nrj->...ij", wv, J, J) + 1e-6 * eye6
        b = torch.einsum("...n,...nri,...nr->...i", wv, J, r)
        xi = -chol_solve(H, b)
        xi = torch.where(torch.isfinite(xi).all(-1, keepdim=True), xi, 0.0)
        T = se3_exp(xi) @ T
    return T


def _score(T, pts_w, obs_uv, valid, cam, px_thresh):
    r, _, depth_ok = _mono(T, pts_w, obs_uv, cam)
    inl = valid & depth_ok & (torch.linalg.vector_norm(r, dim=-1) < px_thresh)
    return inl, torch.sum(inl.to(torch.int32), dim=-1)


def pnp_ransac(
    pts_w: torch.Tensor,    # [N,3] landmark world positions
    obs_uv: torch.Tensor,   # [N,2] observed pixels (undistorted)
    valid: torch.Tensor,    # [N] bool
    T_init: torch.Tensor,   # [4,4] prior pose
    generator: torch.Generator | None,
    cam: CameraModel,
    px_thresh: float = 3.0,
    min_inliers: int = 10,
    n_hypotheses: int = 64,
    sample_size: int = 8,
    iters: int = 8,
    draws: torch.Tensor | None = None,
) -> PnPResult:
    N = pts_w.shape[0]
    good = valid.to(torch.int64)
    if draws is None:
        draws = sample_draws(torch.sum(good), (n_hypotheses, sample_size),
                             generator)
    csum = torch.cumsum(good, 0)
    sample = torch.clamp(torch.searchsorted(
        csum, draws.to(torch.int64).contiguous(), right=True), 0, N - 1)

    w = torch.zeros(n_hypotheses, N, dtype=pts_w.dtype, device=pts_w.device)
    w = w.scatter_(1, sample, 1.0) * valid
    Ts = _gn_refine(T_init.expand(n_hypotheses, 4, 4), pts_w, obs_uv, w, cam,
                    iters)
    Ts = torch.cat([T_init[None], Ts[1:]])              # prior as rescue

    inls, counts = _score(Ts, pts_w, obs_uv, valid, cam, px_thresh)
    best = torch.argmax(counts).reshape(1)              # first maximum
    T = _gn_refine(Ts.index_select(0, best)[0], pts_w, obs_uv,
                   inls.index_select(0, best)[0].to(pts_w.dtype), cam, iters)
    inl, n = _score(T, pts_w, obs_uv, valid, cam, px_thresh)
    ok = n >= min_inliers
    return PnPResult(T_cw=torch.where(ok, T, T_init), inliers=inl & ok,
                     n_inliers=torch.where(ok, n, torch.zeros_like(n)), ok=ok)

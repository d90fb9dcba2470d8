"""Reprojection residuals, Jacobians, robust weights and motion-only BA.

Port of `aslam_tpu/ops/ba.py`: information 1/z² (or constant), Huber
deltas sqrt(5.991)/sqrt(7.815), `pose_rounds` x `pose_iters` (4 x 10)
Levenberg-Marquardt iterations with chi² reclassification between rounds
and the robust kernel dropped in the last round, plus the optional motion
prior edge anchored at the initial pose.  The pose is updated by
left-multiplicative se(3) increments, T <- exp(xi) T; the reference's
`fori_loop` is a Python loop here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import BAConfig, CameraModel
from aslam_tpu_torch.ops.linalg import chol_solve
from aslam_tpu_torch.utils.se3 import T_inv, se3_exp, se3_log


class PoseBAResult(NamedTuple):
    T_cw: torch.Tensor       # [4,4] refined pose
    inliers: torch.Tensor    # [N] bool final chi2 classification
    n_inliers: torch.Tensor  # scalar int32
    chi2: torch.Tensor       # [N] final per-edge chi2


def project_residual_jac(T_cw: torch.Tensor, pts_w: torch.Tensor,
                         obs_uv: torch.Tensor, obs_ur: torch.Tensor,
                         cam: CameraModel):
    """Residuals and Jacobians of (pseudo-)stereo reprojection edges.

    Returns (r [N,3], J_pose [N,3,6], J_point [N,3,3], depth_ok [N]); r rows
    are the (u, v, uR) errors, J_pose is w.r.t. the left-mult twist
    [rho, phi] and J_point w.r.t. the world point."""
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    p = pts_w @ R.T + t
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    z_safe = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    r = torch.stack([u - obs_uv[:, 0], v - obs_uv[:, 1], ur - obs_ur], dim=-1)

    zeros = torch.zeros_like(x)
    du = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], -1)
    dv = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    dur = du + torch.stack([zeros, zeros, cam.bf * inv_z2], -1)
    dproj = torch.stack([du, dv, dur], dim=1)                 # [N,3,3]

    # dp/dxi = [I | -p^] for the left-mult twist [rho, phi]
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    px = torch.stack([
        torch.stack([zeros, p[:, 2], -p[:, 1]], -1),
        torch.stack([-p[:, 2], zeros, p[:, 0]], -1),
        torch.stack([p[:, 1], -p[:, 0], zeros], -1),
    ], dim=1)
    dp_dxi = torch.cat([eye, px], dim=-1)                     # [N,3,6]
    return r, dproj @ dp_dxi, dproj @ R[None], z > 1e-3


def huber_weight(chi2: torch.Tensor, delta_sq) -> torch.Tensor:
    """Huber IRLS weight of a chi2 value: 1 inside the delta, delta/|e|
    outside."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = torch.sqrt(torch.as_tensor(delta_sq, dtype=chi2.dtype,
                                   device=chi2.device))
    return torch.where(chi2 <= delta_sq, torch.ones_like(chi2), d / e)


def pose_only_ba(
    T_cw_init: torch.Tensor,  # [4,4]
    pts_w: torch.Tensor,      # [N,3] landmark world positions
    obs_uv: torch.Tensor,     # [N,2] measured keypoint (undistorted)
    obs_ur: torch.Tensor,     # [N] measured right-u; <0 => mono edge
    obs_z: torch.Tensor,      # [N] measured depth (for information 1/z^2)
    valid: torch.Tensor,      # [N] bool
    cam: CameraModel,
    cfg: BAConfig,
    prior_weight: float = 0.0,
) -> PoseBAResult:
    """Motion-only BA: optimise T_cw holding the landmarks fixed.
    `prior_weight` > 0 adds a motion-prior edge anchored at T_cw_init with
    information prior_weight * diag(1,1,1, 4,4,4)."""
    N = pts_w.shape[0]
    dev, dt = pts_w.device, pts_w.dtype
    H_prior = float(prior_weight) * torch.diag(
        torch.tensor([1.0, 1.0, 1.0, 4.0, 4.0, 4.0], dtype=dt, device=dev))
    is_stereo = obs_ur >= 0
    if cfg.info_model == "constant":
        info = torch.ones_like(obs_z)
    else:
        info = torch.where(obs_z > 1e-3,
                           1.0 / torch.clamp(obs_z, min=1e-3) ** 2,
                           torch.zeros_like(obs_z))
    chi2_th = torch.where(is_stereo, torch.full_like(obs_z, cfg.chi2_stereo),
                          torch.full_like(obs_z, cfg.chi2_mono))
    row_mask = torch.stack([torch.ones_like(is_stereo),
                            torch.ones_like(is_stereo), is_stereo], -1)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    zero6 = torch.zeros(6, dtype=dt, device=dev)

    def edge_terms(T, inlier_mask, robust):
        r, J, _, depth_ok = project_residual_jac(T, pts_w, obs_uv, obs_ur, cam)
        r = torch.where(row_mask, r, torch.zeros_like(r))
        chi2 = torch.sum(r * r, -1) * info
        w_huber = huber_weight(chi2, chi2_th) if robust \
            else torch.ones_like(chi2)
        w = info * w_huber * (valid & inlier_mask & depth_ok)
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        b = torch.einsum("nri,nr->i", Jw, r)
        return H, b, chi2

    T_prior_inv = T_inv(T_cw_init)
    T = T_cw_init
    inlier_mask = torch.ones(N, dtype=torch.bool, device=dev)
    for rnd in range(cfg.pose_rounds):
        robust = rnd < cfg.pose_rounds - 1   # kernel dropped in the last round
        lam = 1e-4
        for _ in range(cfg.pose_iters):
            H, b, _ = edge_terms(T, inlier_mask, robust)
            # prior edge: r_p = log(T * T_init^-1), J = I to first order
            r_p = se3_log(T @ T_prior_inv)
            H = H + H_prior
            b = b + H_prior @ r_p
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
            xi = -chol_solve(Hd, b)
            xi = torch.where(torch.all(torch.isfinite(xi)), xi, zero6)
            T = se3_exp(xi) @ T
        _, _, chi2 = edge_terms(T, inlier_mask, robust)
        inlier_mask = chi2 <= chi2_th       # reclassification between rounds

    final_inliers = valid & inlier_mask
    return PoseBAResult(
        T_cw=T,
        inliers=final_inliers,
        n_inliers=torch.sum(final_inliers.to(torch.int32)),
        chi2=chi2,
    )

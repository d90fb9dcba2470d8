"""Reprojection residuals, Jacobians, robust weights and motion-only BA.

Port of `aslam_tpu/ops/ba.py`: information 1/z² (or constant), Huber
deltas sqrt(5.991)/sqrt(7.815), `pose_rounds` x `pose_iters` (4 x 10)
Levenberg-Marquardt iterations with chi² reclassification between rounds
and the robust kernel dropped in the last round, plus the optional motion
prior edge anchored at the initial pose.  The pose is updated by
left-multiplicative se(3) increments, T <- exp(xi) T; the reference's
`fori_loop` is a Python loop here.

`pose_only_ba` takes a leading batch axis (T_cw [B,4,4], edges [B,N]): one
6x6 system per lane, solved together (batched VO, `models/batch_vo.py`).
For CUDA tensors it launches the hand-written kernel `csrc/pose_ba.cu`
(`ops/pose_ba_kernel.py`): the whole call, every lane, in one launch.  For
CPU tensors it runs `pose_only_ba_plain`, the same computation as PyTorch
ops, which the tests hold to the reference and the kernel to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import BAConfig, CameraModel
from aslam_tpu_torch.ops.linalg import chol_solve
from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel
from aslam_tpu_torch.utils.se3 import T_inv, se3_exp, se3_log


class PoseBAResult(NamedTuple):
    T_cw: torch.Tensor       # [4,4] refined pose
    inliers: torch.Tensor    # [N] bool final chi2 classification
    n_inliers: torch.Tensor  # scalar int32
    chi2: torch.Tensor       # [N] final per-edge chi2


def project_residual_jac(T_cw: torch.Tensor, pts_w: torch.Tensor,
                         obs_uv: torch.Tensor, obs_ur: torch.Tensor,
                         cam: CameraModel):
    """Residuals and Jacobians of (pseudo-)stereo reprojection edges, for
    T_cw [...,4,4] and points [...,N,3] (the reference vmaps this over a
    leading camera axis; here it broadcasts).

    Returns (r [...,N,3], J_pose [...,N,3,6], J_point [...,N,3,3],
    depth_ok [...,N]); r rows are the (u, v, uR) errors, J_pose is w.r.t.
    the left-mult twist [rho, phi] and J_point w.r.t. the world point."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    p = pts_w @ R.transpose(-1, -2) + t[..., None, :]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    z_safe = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    r = torch.stack([u - obs_uv[..., 0], v - obs_uv[..., 1], ur - obs_ur],
                    dim=-1)

    zeros = torch.zeros_like(x)
    du = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], -1)
    dv = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    dur = du + torch.stack([zeros, zeros, cam.bf * inv_z2], -1)
    dproj = torch.stack([du, dv, dur], dim=-2)                # [...,N,3,3]

    # dp/dxi = [I | -p^] for the left-mult twist [rho, phi]
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        p.shape[:-1] + (3, 3))
    px = torch.stack([
        torch.stack([zeros, p[..., 2], -p[..., 1]], -1),
        torch.stack([-p[..., 2], zeros, p[..., 0]], -1),
        torch.stack([p[..., 1], -p[..., 0], zeros], -1),
    ], dim=-2)
    dp_dxi = torch.cat([eye, px], dim=-1)                     # [...,N,3,6]
    return r, dproj @ dp_dxi, dproj @ R[..., None, :, :], z > 1e-3


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
    prior_weight: float | torch.Tensor = 0.0,
) -> PoseBAResult:
    """Motion-only BA: optimise T_cw holding the landmarks fixed.
    `prior_weight` > 0 (a float, or a scalar tensor on the points' device,
    never read back) adds a motion-prior edge anchored at T_cw_init with
    information prior_weight * diag(1,1,1, 4,4,4).  With a batch (T_cw_init
    [...,4,4], edges [...,N]) every lane is its own problem.

    Points on the CPU take `pose_only_ba_plain`; points on a card take the
    kernel (`pose_only_ba_kernel`), which raises on what it does not take."""
    if pts_w.device.type == "cpu":
        return pose_only_ba_plain(T_cw_init, pts_w, obs_uv, obs_ur, obs_z,
                                  valid, cam, cfg, prior_weight)
    return PoseBAResult(*pose_only_ba_kernel(
        T_cw_init.contiguous(), pts_w.contiguous(), obs_uv.contiguous(),
        obs_ur.contiguous(), obs_z.contiguous(), valid.contiguous(), cam, cfg,
        prior_weight))


def pose_only_ba_plain(
    T_cw_init: torch.Tensor,
    pts_w: torch.Tensor,
    obs_uv: torch.Tensor,
    obs_ur: torch.Tensor,
    obs_z: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraModel,
    cfg: BAConfig,
    prior_weight: float | torch.Tensor = 0.0,
) -> PoseBAResult:
    """`pose_only_ba` as PyTorch ops, on any device: the CPU path, and the
    yardstick the kernel is held to on the card."""
    lead = pts_w.shape[:-2]
    N = pts_w.shape[-2]
    dev, dt = pts_w.device, pts_w.dtype
    # filled on the device: a tensor built from host data would be a
    # host-device copy that waits for the stream
    diag = torch.full((6,), 4.0, dtype=dt, device=dev)
    diag[:3].fill_(1.0)
    H_prior = prior_weight * torch.diag(diag)
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
        Jw = J * w[..., None, None]
        H = torch.einsum("...nri,...nrj->...ij", Jw, J)
        b = torch.einsum("...nri,...nr->...i", Jw, r)
        return H, b, chi2

    T_prior_inv = T_inv(T_cw_init)
    T = T_cw_init
    inlier_mask = torch.ones(lead + (N,), dtype=torch.bool, device=dev)
    for rnd in range(cfg.pose_rounds):
        robust = rnd < cfg.pose_rounds - 1   # kernel dropped in the last round
        lam = 1e-4
        for _ in range(cfg.pose_iters):
            H, b, _ = edge_terms(T, inlier_mask, robust)
            # prior edge: r_p = log(T * T_init^-1), J = I to first order
            r_p = se3_log(T @ T_prior_inv)
            H = H + H_prior
            # one frame keeps its matrix-vector product (and its kernel)
            b = b + (H_prior @ r_p[..., None])[..., 0] if lead \
                else b + H_prior @ r_p
            Hd = H + lam * torch.diag_embed(torch.diagonal(H, 0, -2, -1)) \
                + 1e-9 * eye6
            xi = -chol_solve(Hd, b)
            xi = torch.where(torch.all(torch.isfinite(xi), -1, keepdim=True),
                             xi, zero6)
            T = se3_exp(xi) @ T
        _, _, chi2 = edge_terms(T, inlier_mask, robust)
        inlier_mask = chi2 <= chi2_th       # reclassification between rounds

    final_inliers = valid & inlier_mask
    return PoseBAResult(
        T_cw=T,
        inliers=final_inliers,
        n_inliers=torch.sum(final_inliers.to(torch.int32), -1),
        chi2=chi2,
    )

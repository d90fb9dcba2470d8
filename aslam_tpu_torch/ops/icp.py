"""ICP refinement: projective data association + Gauss-Newton, as
point-to-plane ICP and as plane-to-plane (generalized) ICP.

Port of `aslam_tpu/ops/icp.py`.  Correspondences come from projective
association: transform the source points, project them into the target depth
image and gather the target point and normal at that pixel.  Normals are a
dense cross product over the backprojected depth image, with `torch.roll`
(the borders wrap, as in the reference).  `lax.scan` is a Python loop.

Differences from the reference that do not change the result:

  * projected pixel coordinates are clamped as floats before the integer
    cast (a point with tiny z projects beyond int32; XLA saturates the cast,
    x86 and CUDA do not).  Such points fail `z > 0.05` either way;
  * the per-point 3x3 weight matrix is inverted in closed form (adjugate,
    `utils/se3.py::_inv3`) where the reference calls an LU `inv`: the matrix
    is SPD with eigenvalues in [2 eps, 2], and `torch.linalg.inv` would check
    its status on the host once per iteration.  Poses agree with the
    reference to 1e-4 (tests/test_torch_icp.py).

Nothing here reads the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import CameraModel, ICPConfig
from aslam_tpu_torch.ops.linalg import chol_solve
from aslam_tpu_torch.utils.se3 import _inv3, se3_exp

_I32_MAX = 2**31 - 1


class ICPResult(NamedTuple):
    T12: torch.Tensor        # refined source-cam -> target-cam transform
    rmse: torch.Tensor       # scalar: sqrt(mean residual^2)
    n_corr: torch.Tensor     # scalar int32 correspondences in final iter
    converged: torch.Tensor  # scalar bool


def backproject_depth(depth: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """Depth image [H,W] -> camera-frame point image [H,W,3] (0 where
    invalid)."""
    H, W = depth.shape
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    x = (u - cam.cx) / cam.fx * depth
    y = (v - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def normal_map(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-pixel normals from central differences of the point image:
    n = normalize(dP/du x dP/dv), oriented toward the camera.  Zero where a
    neighbour is invalid (depth holes).  Borders wrap around."""
    du = torch.roll(points, -1, 1) - torch.roll(points, 1, 1)
    dv = torch.roll(points, -1, 0) - torch.roll(points, 1, 0)
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-9)
    # points have +z away from the camera: n.z should be negative
    flip = torch.sum(n * points, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    ok = (valid
          & torch.roll(valid, -1, 1) & torch.roll(valid, 1, 1)
          & torch.roll(valid, -1, 0) & torch.roll(valid, 1, 0)
          & (norm[..., 0] > 1e-9))
    return torch.where(ok[..., None], n, 0.0)


def _project_px(p: torch.Tensor, cam: CameraModel, H: int, W: int):
    """Nearest pixel (v, u) int64 of camera-frame points [N,3], clamped into
    the image as floats before the cast."""
    z = torch.clamp(p[:, 2], min=1e-6)
    u = torch.round(cam.fx * p[:, 0] / z + cam.cx)
    v = torch.round(cam.fy * p[:, 1] / z + cam.cy)
    u = torch.clamp(torch.nan_to_num(u, nan=0.0), 0, W - 1).to(torch.int64)
    v = torch.clamp(torch.nan_to_num(v, nan=0.0), 0, H - 1).to(torch.int64)
    return v, u


def _finish(T, T12_init, sq_res, ok) -> ICPResult:
    n_corr = torch.sum(ok, dtype=torch.int32)
    rmse = torch.sqrt(torch.sum(torch.where(ok, sq_res, 0.0))
                      / torch.clamp(n_corr, min=1))
    converged = (n_corr >= 10) & torch.all(torch.isfinite(T))
    return ICPResult(T12=torch.where(converged, T, T12_init), rmse=rmse,
                     n_corr=n_corr, converged=converged)


def _gn_update(T, Hm, b):
    """T <- exp(-Hm^-1 b) T, the step dropped when it is not finite."""
    xi = -chol_solve(Hm, b)
    xi = torch.where(torch.all(torch.isfinite(xi)), xi, torch.zeros_like(xi))
    return se3_exp(xi) @ T


def icp_refine(
    src_pts: torch.Tensor,       # [N,3] source camera-frame points
    src_valid: torch.Tensor,     # [N] bool
    target_depth: torch.Tensor,  # [H,W] target frame depth (m)
    T12_init: torch.Tensor,      # [4,4] initial source->target transform
    cam: CameraModel,
    cfg: ICPConfig,
) -> ICPResult:
    """Point-to-plane ICP of a source point set onto a target depth map."""
    H, W = target_depth.shape
    tgt_valid = target_depth > 0.05
    tgt_pts = backproject_depth(target_depth, cam)
    tgt_n = normal_map(tgt_pts, tgt_valid)
    eye6 = torch.eye(6, dtype=src_pts.dtype, device=src_pts.device)

    def corr_terms(T, max_d):
        p = src_pts @ T[:3, :3].T + T[:3, 3]          # [N,3] in target cam
        v, u = _project_px(p, cam, H, W)
        n = tgt_n[v, u]
        has_n = torch.sum(n * n, dim=-1) > 0.5
        d = p - tgt_pts[v, u]
        dist = torch.linalg.vector_norm(d, dim=-1)
        r = torch.sum(n * d, dim=-1)                  # point-to-plane
        ok = src_valid & (p[:, 2] > 0.05) & tgt_valid[v, u] & has_n \
            & (dist < max_d)
        return p, n, r, ok

    T = T12_init
    max_d = torch.full((), cfg.max_corr_dist, dtype=torch.float32,
                       device=src_pts.device)
    for _ in range(cfg.iterations):
        p, n, r, ok = corr_terms(T, max_d)
        w = ok.to(torch.float32)
        # J = [n, p x n] for the left-multiplicative twist [rho, phi]
        J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)  # [N,6]
        Hm = torch.einsum("n,ni,nj->ij", w, J, J) + 1e-6 * eye6
        b = torch.einsum("n,ni,n->i", w, J, r)
        T = _gn_update(T, Hm, b)
        # adaptive correspondence distance from the residual scale
        n_ok = torch.clamp(torch.sum(w), min=1.0)
        mean_abs = torch.sum(torch.abs(r) * w) / n_ok
        max_d = torch.clamp(3.0 * mean_abs, 0.01, 0.08)

    _, _, r, ok = corr_terms(T, max_d)
    return _finish(T, T12_init, r * r, ok)


# ------------------------------------------------------------------ GICP

def _plane_cov(n: torch.Tensor, has_n: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-point plane-to-plane covariance C = R diag(eps,1,1) R^T =
    I - (1-eps) n n^T for a unit normal n; the identity where there is no
    normal (degrades to point-to-point)."""
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    C = eye - (1.0 - eps) * (n[..., :, None] * n[..., None, :])
    return torch.where(has_n[..., None, None], C, eye)


def _point_jacobian(p: torch.Tensor) -> torch.Tensor:
    """J [N,3,6] = [I3, -skew(p)] for the left twist [rho, phi]."""
    zero, one = torch.zeros_like(p[:, 0]), torch.ones_like(p[:, 0])
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return torch.stack([
        torch.stack([one, zero, zero, zero, z, -y], -1),
        torch.stack([zero, one, zero, -z, zero, x], -1),
        torch.stack([zero, zero, one, y, -x, zero], -1),
    ], dim=-2)


def _mahalanobis_update(T, p, d, Wi, w):
    """One Gauss-Newton step on sum_n w_n d_n^T Wi_n d_n."""
    J = _point_jacobian(p)
    WJ = Wi @ J
    eye6 = torch.eye(6, dtype=p.dtype, device=p.device)
    Hm = torch.einsum("n,nri,nrj->ij", w, J, WJ) + 1e-6 * eye6
    b = torch.einsum("n,nri,nr->i", w, WJ, d)
    return _gn_update(T, Hm, b)


def gicp_refine(
    src_pts: torch.Tensor,       # [N,3] source camera-frame points
    src_normals: torch.Tensor,   # [N,3] source normals (0 where unknown)
    src_valid: torch.Tensor,     # [N] bool
    target_depth: torch.Tensor,  # [H,W] target frame depth (m)
    T12_init: torch.Tensor,      # [4,4] initial source->target transform
    cam: CameraModel,
    cfg: ICPConfig,
) -> ICPResult:
    """Plane-to-plane (generalized) ICP onto a target depth map: per-point
    covariances C = R diag(eps,1,1) R^T on both clouds, Gauss-Newton on the
    Mahalanobis 3D residual d^T (C_q + R C_p R^T)^-1 d.  Association stays
    projective."""
    H, W = target_depth.shape
    eps = cfg.gicp_epsilon
    tgt_valid = target_depth > 0.05
    tgt_pts = backproject_depth(target_depth, cam)
    tgt_n = normal_map(tgt_pts, tgt_valid)
    src_has_n = torch.sum(src_normals * src_normals, dim=-1) > 0.5
    eye3 = torch.eye(3, dtype=src_pts.dtype, device=src_pts.device)

    def corr_terms(T, max_d):
        R = T[:3, :3]
        p = src_pts @ R.T + T[:3, 3]                  # [N,3] in target cam
        np_rot = src_normals @ R.T                    # rotated src normals
        v, u = _project_px(p, cam, H, W)
        nq = tgt_n[v, u]
        has_nq = torch.sum(nq * nq, dim=-1) > 0.5
        d = p - tgt_pts[v, u]
        dist = torch.linalg.vector_norm(d, dim=-1)
        ok = src_valid & (p[:, 2] > 0.05) & tgt_valid[v, u] & has_nq \
            & (dist < max_d)
        # combined covariance M = C_q + R C_p R^T; weight W = M^-1
        M = _plane_cov(nq, has_nq, eps) + _plane_cov(np_rot, src_has_n, eps)
        return p, d, _inv3(M + 1e-6 * eye3), ok, dist

    T = T12_init
    max_d = torch.full((), cfg.max_corr_dist, dtype=torch.float32,
                       device=src_pts.device)
    for _ in range(cfg.iterations):
        p, d, Wi, ok, dist = corr_terms(T, max_d)
        w = ok.to(torch.float32)
        T = _mahalanobis_update(T, p, d, Wi, w)
        n_ok = torch.clamp(torch.sum(w), min=1.0)
        max_d = torch.clamp(3.0 * torch.sum(dist * w) / n_ok, 0.01, 0.08)

    _, d, _, ok, _ = corr_terms(T, max_d)
    return _finish(T, T12_init, torch.sum(d * d, dim=-1), ok)


def gicp_align_matched(
    p1: torch.Tensor,          # [N,3] source points (cam 1)
    n1: torch.Tensor,          # [N,3] source normals (0 = unknown)
    p2: torch.Tensor,          # [N,3] matched target points (cam 2)
    n2: torch.Tensor,          # [N,3] target normals
    pair_valid: torch.Tensor,  # [N] bool
    T12_init: torch.Tensor,
    cfg: ICPConfig,
    iters: int = 10,
) -> ICPResult:
    """GICP over fixed correspondences (source and target clouds built from
    matched keypoints, then the plane-to-plane refinement)."""
    eps = cfg.gicp_epsilon
    has1 = torch.sum(n1 * n1, dim=-1) > 0.5
    has2 = torch.sum(n2 * n2, dim=-1) > 0.5
    C2 = _plane_cov(n2, has2, eps)
    eye3 = torch.eye(3, dtype=p1.dtype, device=p1.device)
    w = pair_valid.to(torch.float32)

    T = T12_init
    for _ in range(iters):
        R = T[:3, :3]
        p = p1 @ R.T + T[:3, 3]
        Wi = _inv3(C2 + _plane_cov(n1 @ R.T, has1, eps) + 1e-6 * eye3)
        T = _mahalanobis_update(T, p, p - p2, Wi, w)
    d = (p1 @ T[:3, :3].T + T[:3, 3]) - p2
    return _finish(T, T12_init, torch.sum(d * d, dim=-1), pair_valid)


def subset_mask(generator: torch.Generator | None, valid: torch.Tensor,
                frac: float = 0.75) -> torch.Tensor:
    """Random point subset: keep about `frac` of the valid points, drawn on
    `valid`'s device from `generator`."""
    u = torch.rand(valid.shape, generator=generator, device=valid.device)
    return valid & (u < frac)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped into the int32 range, as an int32 product wraps."""
    return ((x + 2**31) % 2**32) - 2**31


def voxel_downsample(pts: torch.Tensor, valid: torch.Tensor,
                     cell: float = 0.03):
    """Voxel-grid thinning: keeps one representative point per occupied
    voxel by hash-dedup (the first point of each hash in a stable sort).
    -> (pts, keep_mask), same length."""
    q = torch.clamp(torch.floor(pts / cell), -2.0**31, 2.0**31 - 128) \
        .to(torch.int64)
    h = _wrap_i32(q[:, 0] * 73856093) ^ _wrap_i32(q[:, 1] * 19349663) \
        ^ _wrap_i32(q[:, 2] * 83492791)
    h = torch.where(valid, h, _I32_MAX)
    sorted_h, order = torch.sort(h, stable=True)
    first = torch.ones_like(valid)
    first[1:] = sorted_h[1:] != sorted_h[:-1]
    keep_sorted = first & (sorted_h != _I32_MAX)
    keep = torch.zeros_like(valid).scatter_(0, order, keep_sorted)
    return pts, keep & valid

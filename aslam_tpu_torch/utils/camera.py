"""Camera model ops: project / unproject / distort / undistort.

Port of `aslam_tpu/utils/camera.py`; all ops are batched over an (..., N)
keypoint axis.
"""

from __future__ import annotations

import torch

from aslam_tpu_torch.config import CameraModel


def khoshelham_gate(z: torch.Tensor, c: float = 0.01,
                    floor: float = 0.03) -> torch.Tensor:
    """3-sigma depth-agreement gate from the Khoshelham noise model
    sigma_z = c * z^2, plus a near-range floor."""
    return 3.0 * c * z * z + floor


def project(cam: CameraModel, pts_c: torch.Tensor):
    """Camera-frame points (...,N,3) -> pixel coords (...,N,2) and depth (...,N).
    Pinhole only: keypoints are undistorted once at extraction."""
    z = pts_c[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = cam.fx * pts_c[..., 0] * inv_z + cam.cx
    v = cam.fy * pts_c[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def unproject(cam: CameraModel, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixels (...,N,2) + depth (...,N) -> camera-frame points (...,N,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def u_right(cam: CameraModel, u: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pseudo-stereo right-image coordinate u - bf/z; -1 where depth invalid."""
    valid = z > 0
    zs = torch.where(valid, z, torch.ones_like(z))
    return torch.where(valid, u - cam.bf / zs, torch.full_like(u, -1.0))


def distort_normalized(cam: CameraModel, xy: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xt = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yt = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([x * radial + xt, y * radial + yt], dim=-1)


def undistort_points(cam: CameraModel, uv: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert the distortion model by fixed-point iteration (the scheme of
    cv::undistortPoints).  Distorted pixel coords (...,2) -> undistorted."""
    if not cam.has_distortion:
        return uv
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * xx * yy + cam.p2 * (r2 + 2.0 * xx * xx)
        dy = cam.p1 * (r2 + 2.0 * yy * yy) + 2.0 * cam.p2 * xx * yy
        x = (xd - torch.stack([dx, dy], dim=-1)) / radial[..., None]
    return torch.stack([x[..., 0] * cam.fx + cam.cx,
                        x[..., 1] * cam.fy + cam.cy], dim=-1)

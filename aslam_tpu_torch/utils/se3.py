"""SE(3) / SO(3) utilities as batched torch ops.

Port of `aslam_tpu/utils/se3.py`.  Poses are 4x4 homogeneous `T` matrices
(world-to-camera `Tcw` by convention); twist vectors are `[rho(3), phi(3)]`
(translation first, rotation second).  All functions broadcast over leading
batch dimensions and keep the reference's float32 operation order, so the
parity tests can hold them to 1e-5.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: v (...,3) -> skew-symmetric (...,3,3)."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector (...,3) -> rotation matrix (...,3,3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / (theta2 + _EPS),
                    0.5 - theta2 / 24.0)
    K = hat(phi)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> rotation vector (...,3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    small = torch.abs(sin_theta) < 1e-5
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_theta + _EPS))
    log_generic = scale[..., None] * w
    # near theta = pi |w| ~ 0: take the axis from the diagonal
    near_pi = cos_theta < -1.0 + 1e-4
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    one = torch.ones_like(trace)
    sx = torch.where(R[..., 2, 1] - R[..., 1, 2] < 0, -one, one)
    sy = torch.where(R[..., 0, 2] - R[..., 2, 0] < 0, -one, one)
    sz = torch.where(R[..., 1, 0] - R[..., 0, 1] < 0, -one, one)
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    log_pi = theta[..., None] * axis / (
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + _EPS)
    return torch.where(near_pi[..., None], log_pi, log_generic)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    a = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / (theta2 + _EPS),
                    0.5 - theta2 / 24.0)
    b = torch.where(theta2 > _EPS,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [rho, phi] (...,6) -> homogeneous transform (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return rt_to_T(so3_exp(phi), _matvec(_so3_left_jacobian(phi), rho))


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched 3x3 matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det,
                                torch.full_like(det, 1e-20))
    adj = torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c10, c11, c12], -1),
        torch.stack([c20, c21, c22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (...,4,4) -> twist [rho, phi] (...,6)."""
    R, t = T_to_rt(T)
    phi = so3_log(R)
    rho = _matvec(_inv3(_so3_left_jacobian(phi)), t)
    return torch.cat([rho, phi], dim=-1)


def rt_to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(...,3,3) + (...,3) -> (...,4,4).  Assembled by concatenation: writing
    a Python scalar into a device tensor is a host-to-device copy that waits
    for the stream."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]],
                    dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def T_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def T_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    R, t = T_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_T(Rt, -_matvec(Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,N,3)."""
    R, t = T_to_rt(T)
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation angle in radians (the keyframe trigger's)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def pose_distance(T_a: torch.Tensor, T_b: torch.Tensor):
    """(translation distance, rotation angle) between two poses."""
    R, t = T_to_rt(T_inv(T_a) @ T_b)
    return torch.linalg.vector_norm(t, dim=-1), rotation_angle(R)


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), the TUM trajectory order.
    The branch with the largest of (trace, m00, m11, m22) is taken, per
    element."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s = s_of(tr + 1.0)
    qw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                      s / 4.0], -1)
    s = s_of(1.0 + m00 - m11 - m22)
    qx = torch.stack([s / 4.0, (m01 + m10) / s, (m02 + m20) / s,
                      (m21 - m12) / s], -1)
    s = s_of(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m01 + m10) / s, s / 4.0, (m12 + m21) / s,
                      (m02 - m20) / s], -1)
    s = s_of(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, s / 4.0,
                      (m10 - m01) / s], -1)
    use_w = tr > 0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = torch.where(use_w[..., None], qw,
                    torch.where(use_x[..., None], qx,
                                torch.where(use_y[..., None], qy, qz)))
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                        2 * (x * z + y * w)], -1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                        2 * (y * z - x * w)], -1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def weighted_kabsch(src: torch.Tensor, dst: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment: T (4x4) minimizing sum_i w_i |T src_i - dst_i|^2.

    Horn's closed-form quaternion method, solved exactly as the reference
    does it (`aslam_tpu/utils/se3.py:223-295`): a Gershgorin-shifted 4x4
    matrix squared 12 times with Frobenius renormalisation, a fixed probe
    vector, then 3 shifted power steps against the unsquared matrix.
    Another eigen-solver picks other rotations on near-degenerate minimal
    samples, and so other RANSAC inlier sets.

    src, dst: (..., N, 3); w: (..., N).  Returns (..., 4, 4).
    """
    w = torch.clamp(w, min=0.0)
    wsum = torch.sum(w, dim=-1, keepdim=True) + _EPS
    wn = w / wsum
    mu_s = torch.sum(wn[..., None] * src, dim=-2)
    mu_d = torch.sum(wn[..., None] * dst, dim=-2)
    src_c = src - mu_s[..., None, :]
    dst_c = dst - mu_d[..., None, :]
    H = (wn[..., None] * src_c).transpose(-1, -2) @ dst_c          # [...,3,3]
    hxx, hxy, hxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    hyx, hyy, hyz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    hzx, hzy, hzz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = torch.stack([
        torch.stack([hxx + hyy + hzz, hyz - hzy, hzx - hxz, hxy - hyx], -1),
        torch.stack([hyz - hzy, hxx - hyy - hzz, hxy + hyx, hzx + hxz], -1),
        torch.stack([hzx - hxz, hxy + hyx, hyy - hxx - hzz, hyz + hzy], -1),
        torch.stack([hxy - hyx, hzx + hxz, hyz + hzy, hzz - hxx - hyy], -1),
    ], -2)                                                         # [...,4,4]
    s = torch.sum(torch.abs(N), dim=-1).amax(dim=-1)               # Gershgorin
    Ns = N + (s + _EPS)[..., None, None] * torch.eye(
        4, dtype=N.dtype, device=N.device)
    for _ in range(12):
        Ns = Ns @ Ns
        Ns = Ns / (torch.sqrt(torch.sum(Ns * Ns, dim=(-2, -1), keepdim=True))
                   + _EPS)
    # filled on the device (a tensor from host data waits for the stream)
    probe = torch.full((4,), 1.0, dtype=N.dtype, device=N.device)
    for i, v in ((1, 1e-3), (2, 2e-3), (3, 3e-3)):
        probe[i].fill_(v)
    q = _matvec(Ns, probe.expand(N.shape[:-1]))
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    for _ in range(3):
        q = _matvec(N, q) + (s + _EPS)[..., None] * q
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    # Horn's eigenvector is (w, x, y, z); quat_to_R takes (x, y, z, w)
    R = quat_to_R(torch.roll(q, -1, dims=-1))
    return rt_to_T(R, mu_d - _matvec(R, mu_s))

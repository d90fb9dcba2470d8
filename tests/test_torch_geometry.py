"""Parity of the port's geometry base (se3, camera, Cholesky solve, Kabsch)
with the JAX package, on batched random inputs from a seed.  Tolerance 1e-5
(float32 rounding of the same operation order), 1e-4 for Kabsch, whose 12
squarings amplify rounding."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as P
from aslam_tpu.config import TUM_FR1, CameraModel
from aslam_tpu.ops import linalg as jlinalg
from aslam_tpu.utils import camera as jcam
from aslam_tpu.utils import se3 as jse3
from aslam_tpu_torch import config as port_cfg
from aslam_tpu_torch.ops import linalg as tlinalg
from aslam_tpu_torch.utils import camera as tcam
from aslam_tpu_torch.utils import se3 as tse3

TOL = 1e-5


def _rng():
    return np.random.default_rng(1234)


def _rotations(rng, n, scale=1.0):
    phi = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    return np.asarray(jse3.so3_exp(jnp.asarray(phi)))


def _poses(rng, n):
    xi = np.concatenate([rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.8],
                        -1).astype(np.float32)
    return np.asarray(jse3.se3_exp(jnp.asarray(xi)))


def _case(name, rng):
    """-> (reference fn, port fn, args as numpy)."""
    v = rng.normal(size=(64, 3)).astype(np.float32)
    if name == "hat":
        return jse3.hat, tse3.hat, (v,)
    if name == "so3_exp":
        v[:4] *= 1e-5                         # Taylor branch
        return jse3.so3_exp, tse3.so3_exp, (v,)
    if name == "so3_log":
        return jse3.so3_log, tse3.so3_log, (_rotations(rng, 64),)
    if name == "se3_exp":
        xi = rng.normal(size=(64, 6)).astype(np.float32)
        return jse3.se3_exp, tse3.se3_exp, (xi,)
    if name == "se3_log":
        return jse3.se3_log, tse3.se3_log, (_poses(rng, 64),)
    if name == "T_inv":
        return jse3.T_inv, tse3.T_inv, (_poses(rng, 64),)
    if name == "transform_points":
        pts = rng.normal(size=(64, 20, 3)).astype(np.float32)
        return jse3.transform_points, tse3.transform_points, (_poses(rng, 64), pts)
    if name == "quat_to_R":
        q = rng.normal(size=(64, 4)).astype(np.float32)
        return jse3.quat_to_R, tse3.quat_to_R, (q,)
    if name == "inv3":
        A = rng.normal(size=(64, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
        return jse3._inv3, tse3._inv3, (A,)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["hat", "so3_exp", "so3_log", "se3_exp",
                                  "se3_log", "T_inv", "transform_points",
                                  "quat_to_R", "inv3"])
def test_se3_matches_reference(name):
    fj, ft, args = _case(name, _rng())
    ref = np.asarray(fj(*(jnp.asarray(a) for a in args)))
    out = P.n(ft(*(P.t(a) for a in args)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_so3_log_near_pi_matches_reference():
    rng = _rng()
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    phi = (axis * (np.pi - 1e-3)).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray(phi)))
    ref = np.asarray(jse3.so3_log(jnp.asarray(R)))
    out = P.n(tse3.so3_log(P.t(R)))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _cams():
    small = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320,
                        height=240)
    return {"small": small, "tum_fr1": TUM_FR1}


@pytest.mark.parametrize("cam_name", ["small", "tum_fr1"])
@pytest.mark.parametrize("fn", ["project", "unproject", "u_right",
                                "distort_normalized", "undistort_points",
                                "khoshelham_gate"])
def test_camera_matches_reference(fn, cam_name):
    rng = _rng()
    jc = _cams()[cam_name]
    tc = port_cfg.CameraModel(**dataclasses.asdict(jc))
    pts = np.concatenate([rng.uniform(-1, 1, (2, 256, 2)),
                          rng.uniform(0.3, 4.0, (2, 256, 1))], -1).astype(np.float32)
    uv = rng.uniform(0, [jc.width, jc.height], (2, 256, 2)).astype(np.float32)
    z = rng.uniform(-0.5, 4.0, (2, 256)).astype(np.float32)
    xy = rng.uniform(-0.5, 0.5, (2, 256, 2)).astype(np.float32)
    args = {"project": (pts,), "unproject": (uv, z), "u_right": (uv[..., 0], z),
            "distort_normalized": (xy,), "undistort_points": (uv,)}
    if fn == "khoshelham_gate":
        ref = np.asarray(jcam.khoshelham_gate(jnp.asarray(z)))
        out = P.n(tcam.khoshelham_gate(P.t(z)))
    else:
        ref = getattr(jcam, fn)(jc, *(jnp.asarray(a) for a in args[fn]))
        out = getattr(tcam, fn)(tc, *(P.t(a) for a in args[fn]))
        if fn == "project":
            ref, out = np.concatenate([np.asarray(ref[0]), np.asarray(ref[1])[..., None]], -1), \
                np.concatenate([P.n(out[0]), P.n(out[1])[..., None]], -1)
        ref, out = np.asarray(ref), P.n(out)
    # pixel-valued outputs: relative 1e-5 of their magnitude
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", [3, 6])
def test_chol_solve_matches_reference(n):
    rng = _rng()
    B = rng.normal(size=(128, n, n)).astype(np.float32)
    A = B @ np.swapaxes(B, -1, -2) + 0.1 * np.eye(n, dtype=np.float32)
    A[:4] = 0.0                    # degenerate rows: clamped, never NaN
    b = rng.normal(size=(128, n)).astype(np.float32)
    ref = np.asarray(jlinalg.chol_solve(jnp.asarray(A), jnp.asarray(b)))
    out = P.n(tlinalg.chol_solve(P.t(A), P.t(b)))
    ok = np.isfinite(ref)
    assert (np.isfinite(out) == ok).all()
    np.testing.assert_allclose(out[4:], ref[4:], atol=TOL, rtol=1e-4)


def test_weighted_kabsch_matches_reference():
    rng = _rng()
    T = _poses(rng, 32)
    src = rng.uniform(-2, 2, (32, 40, 3)).astype(np.float32)
    dst = (np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = rng.uniform(0, 1, (32, 40)).astype(np.float32)
    w[:, :5] = 0.0
    ref = np.asarray(jse3.weighted_kabsch(*(jnp.asarray(a) for a in (src, dst, w))))
    out = P.n(tse3.weighted_kabsch(P.t(src), P.t(dst), P.t(w)))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # minimal 4-point samples, as RANSAC draws them
    ones = np.ones((32, 4), np.float32)
    ref4 = np.asarray(jse3.weighted_kabsch(
        jnp.asarray(src[:, :4]), jnp.asarray(dst[:, :4]), jnp.asarray(ones)))
    out4 = P.n(tse3.weighted_kabsch(P.t(src[:, :4]), P.t(dst[:, :4]), P.t(ones)))
    np.testing.assert_allclose(out4, ref4, atol=1e-4)


def test_chol_inv_matches_reference():
    rng = _rng()
    B = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = B @ np.swapaxes(B, -1, -2) + 0.1 * np.eye(3, dtype=np.float32)
    ref = np.asarray(jlinalg.chol_inv(jnp.asarray(A)))
    out = P.n(tlinalg.chol_inv(P.t(A)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=1e-4)
    np.testing.assert_allclose(out @ A, np.broadcast_to(np.eye(3), A.shape),
                               atol=1e-3)


def test_rotation_angle_and_pose_distance_match_reference():
    rng = _rng()
    Ta, Tb = _poses(rng, 64), _poses(rng, 64).copy()
    Tb[:4] = Ta[:4]                               # zero distance
    for a, b in zip(tse3.pose_distance(P.t(Ta), P.t(Tb)),
                    jse3.pose_distance(jnp.asarray(Ta), jnp.asarray(Tb))):
        np.testing.assert_allclose(P.n(a), np.asarray(b), atol=1e-4)
    R = _rotations(rng, 64, scale=2.0)
    np.testing.assert_allclose(P.n(tse3.rotation_angle(P.t(R))),
                               np.asarray(jse3.rotation_angle(jnp.asarray(R))),
                               atol=1e-4)


@pytest.mark.parametrize("margin", [0.0, 8.0])
def test_in_frustum_matches_reference(margin):
    """Visibility is exact except for points within 1e-3 px (or 1e-6 m of
    depth) of a bound, where float32 rounding may decide either way."""
    rng = _rng()
    cam = _cams()["small"]
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _rotations(rng, 1, scale=0.2)[0]
    T[:3, 3] = rng.normal(0, 0.1, 3)
    pts = np.stack([rng.uniform(-4, 4, 4000), rng.uniform(-3, 3, 4000),
                    rng.uniform(-1, 5, 4000)], -1).astype(np.float32)
    ref = [np.asarray(x) for x in jcam.in_frustum(
        cam, jnp.asarray(T), jnp.asarray(pts), margin=margin)]
    out = [P.n(x) for x in tcam.in_frustum(
        port_cfg.CameraModel(**dataclasses.asdict(cam)), P.t(T), P.t(pts),
        margin=margin)]
    uv, z = ref[1], ref[2]
    edge = np.minimum.reduce([np.abs(uv[:, 0] + margin),
                              np.abs(uv[:, 0] - cam.width - margin),
                              np.abs(uv[:, 1] + margin),
                              np.abs(uv[:, 1] - cam.height - margin)])
    sure = (edge > 1e-3) & (np.abs(z - 0.05) > 1e-6)
    np.testing.assert_array_equal(out[0][sure], ref[0][sure])
    assert 100 < ref[0].sum() < 3900
    front = z > 0.05
    np.testing.assert_allclose(out[1][front], ref[1][front], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(out[2], ref[2], atol=1e-5)
    np.testing.assert_allclose(out[3][front], ref[3][front], rtol=1e-5,
                               atol=1e-3)


def test_R_to_quat_matches_reference():
    """Every branch (trace > 0 and each dominant diagonal entry): rotations
    by up to pi about random axes and about each coordinate axis."""
    rng = _rng()
    Rs = np.concatenate([
        _rotations(rng, 64), _rotations(rng, 64, scale=3.0),
        np.asarray(jse3.so3_exp(jnp.asarray(
            np.eye(3, dtype=np.float32) * 3.1))),
        np.eye(3, dtype=np.float32)[None]])
    q_j = np.asarray(jse3.R_to_quat(jnp.asarray(Rs)))
    q_t = P.n(tse3.R_to_quat(P.t(Rs)))
    np.testing.assert_allclose(q_t, q_j, atol=TOL)
    tr = np.trace(Rs, axis1=1, axis2=2)
    assert (tr <= 0).sum() >= 8 and (tr > 0).sum() >= 8
    np.testing.assert_allclose(np.linalg.norm(q_t, axis=1), 1.0, atol=1e-5)
    # and back
    np.testing.assert_allclose(P.n(tse3.quat_to_R(P.t(q_t))), Rs, atol=1e-4)


def test_trajectory_metrics_match_reference(tmp_path):
    from aslam_tpu.utils import trajectory as jtraj
    from aslam_tpu_torch.utils import trajectory as ttraj

    rng = _rng()
    gt = _poses(rng, 40)
    noise = np.concatenate([rng.normal(size=(40, 3)) * 0.01,
                            rng.normal(size=(40, 3)) * 0.005], -1)
    est = np.asarray(jse3.se3_exp(jnp.asarray(noise.astype(np.float32)))) @ gt
    for delta in (1, 5):
        np.testing.assert_allclose(ttraj.rpe_rmse(est, gt, delta),
                                   jtraj.rpe_rmse(est, gt, delta), rtol=1e-9)
    ate_j = float(jtraj.ate_rmse_device(jnp.asarray(est), jnp.asarray(gt)))
    ate_t = ttraj.ate_rmse_device(P.t(est), P.t(gt))
    assert ate_t.shape == () and 0.005 < float(ate_t) < 0.05
    np.testing.assert_allclose(float(ate_t), ate_j, rtol=1e-4)
    np.testing.assert_allclose(
        float(ate_t), ttraj.ate_rmse(ttraj.camera_centers(est),
                                     ttraj.camera_centers(gt)), rtol=1e-4)
    # the TUM file, as the reference writes it
    ts = np.arange(40) * 0.033 + 1305031102.175304
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jtraj.save_tum_trajectory(pj, ts, est)
    ttraj.save_tum_trajectory(pt, ts, est)
    a, b = np.loadtxt(pt), np.loadtxt(pj)
    np.testing.assert_allclose(a, b, atol=2e-6)
    t_l, xyz, quat = ttraj.load_tum_trajectory(pt)
    np.testing.assert_allclose(xyz, ttraj.camera_centers(est), atol=1e-5)
    assert quat.shape == (40, 4) and t_l[0] == pytest.approx(ts[0], abs=1e-6)

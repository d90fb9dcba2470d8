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

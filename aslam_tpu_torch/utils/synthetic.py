"""Synthetic RGB-D scene generator — the test "fake backend".

The reference has no fixtures at all (SURVEY.md §4); trajectories were only
ever evaluated against TUM ground truth offline.  For deterministic unit and
integration tests we render a random 3D point scene with known camera poses
into images + depth maps, giving ground-truth correspondences, poses, and
landmarks for every stage of the pipeline.

A numpy copy of `aslam_tpu/utils/synthetic.py`, so that the port renders the
same frames without importing jax.
"""

from __future__ import annotations

import numpy as np

from aslam_tpu_torch.config import CameraModel


def _np_se3_exp(xi: np.ndarray) -> np.ndarray:
    """Pure-numpy se(3) exponential (keeps the generator JAX-free so it
    never pays device-compile latency)."""
    rho, phi = xi[:3], xi[3:]
    theta = float(np.linalg.norm(phi))
    K = np.array([
        [0.0, -phi[2], phi[1]],
        [phi[2], 0.0, -phi[0]],
        [-phi[1], phi[0], 0.0],
    ])
    if theta < 1e-8:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        a, b = np.sin(theta) / theta, (1 - np.cos(theta)) / theta**2
        c = (theta - np.sin(theta)) / theta**3
        R = np.eye(3) + a * K + b * (K @ K)
        V = np.eye(3) + b * K + c * (K @ K)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def random_scene(
    rng: np.random.Generator,
    n_points: int = 800,
    extent: float = 3.0,
    depth_range: tuple[float, float] = (0.8, 3.5),
) -> np.ndarray:
    """World points in a box in front of the origin (+z forward)."""
    pts = np.empty((n_points, 3), np.float32)
    pts[:, 0] = rng.uniform(-extent, extent, n_points)
    pts[:, 1] = rng.uniform(-extent * 0.75, extent * 0.75, n_points)
    pts[:, 2] = rng.uniform(depth_range[0], depth_range[1], n_points)
    return pts


def camera_trajectory(n_frames: int, step_t: float = 0.02, step_r: float = 0.01,
                      rng: np.random.Generator | None = None) -> np.ndarray:
    """Smooth forward-ish trajectory of T_cw (world-to-camera) poses [F,4,4]."""
    rng = rng or np.random.default_rng(0)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n_frames - 1):
        xi = np.concatenate([
            rng.normal(0.0, step_t, 3),
            rng.normal(0.0, step_r, 3),
        ]).astype(np.float32)
        delta = _np_se3_exp(xi)
        poses.append((delta @ poses[-1]).astype(np.float32))
    return np.stack(poses)


def render_depth_image(
    cam: CameraModel,
    T_cw: np.ndarray,
    pts_w: np.ndarray,
    splat: int = 2,
    background_depth: float = 0.0,
) -> np.ndarray:
    """Render a dense float depth map by splatting scene points (z-buffered).

    Not photorealistic — just enough structure for the depth-backprojection,
    normal-estimation, and ICP paths to operate on.
    """
    H, W = cam.height, cam.width
    depth = np.full((H, W), np.inf, np.float32)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pc = pts_w @ R.T + t
    z = pc[:, 2]
    ok = z > 0.05
    u = np.round(cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx).astype(np.int64)
    v = np.round(cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy).astype(np.int64)
    for du in range(-splat, splat + 1):
        for dv in range(-splat, splat + 1):
            uu, vv = u + du, v + dv
            m = ok & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            np.minimum.at(depth, (vv[m], uu[m]), z[m])
    depth[~np.isfinite(depth)] = background_depth
    return depth


def point_textures(n_points: int, size: int = 7, seed: int = 7) -> np.ndarray:
    """A unique random texture stamp per scene point.  Each landmark gets a
    distinctive local appearance so descriptors are discriminative (flat
    blobs would all look identical to BRIEF)."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(45.0, 255.0, (n_points, size, size)).astype(np.float32)
    return tex


def render_intensity_image(
    cam: CameraModel,
    T_cw: np.ndarray,
    pts_w: np.ndarray,
    textures: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
    noise: float = 0.0,
) -> np.ndarray:
    """Render a grayscale image with a distinctive texture stamp per scene
    point so the corner detector finds repeatable, *matchable* features."""
    H, W = cam.height, cam.width
    img = np.full((H, W), 32.0, np.float32)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pc = pts_w @ R.T + t
    z = pc[:, 2]
    ok = z > 0.05
    u = np.round(cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx).astype(np.int64)
    v = np.round(cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy).astype(np.int64)
    if textures is None:
        textures = point_textures(len(pts_w))
    r = textures.shape[1] // 2
    order = np.argsort(-z)  # far first so near points overwrite
    for i in order:
        if not ok[i]:
            continue
        uu, vv = u[i], v[i]
        if r <= uu < W - r - 1 and r <= vv < H - r - 1:
            img[vv - r : vv + r + 1, uu - r : uu + r + 1] = textures[i]
    if noise > 0:
        rng = rng or np.random.default_rng(0)
        img = img + rng.normal(0.0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 255.0)


import functools


@functools.lru_cache(maxsize=8)
def _make_sequence_cached(n_frames: int, cam: CameraModel, n_points: int,
                          seed: int):
    rng = np.random.default_rng(seed)
    pts = random_scene(rng, n_points)
    poses = camera_trajectory(n_frames, rng=rng)
    tex = point_textures(n_points, seed=seed + 1)
    imgs = np.stack([render_intensity_image(cam, T, pts, tex) for T in poses])
    depths = np.stack([render_depth_image(cam, T, pts, splat=4) for T in poses])
    for a in (imgs, depths, poses, pts):
        a.setflags(write=False)
    return imgs, depths, poses, pts


def make_sequence(
    n_frames: int = 5,
    cam: CameraModel | None = None,
    n_points: int = 600,
    seed: int = 0,
):
    """Full synthetic RGB-D sequence: (images[F,H,W], depths[F,H,W],
    poses_cw[F,4,4], points_w[N,3]).  Deterministic per arguments and
    memoized (the splat renderer is pure-Python and slow); returned arrays
    are read-only views — copy before mutating."""
    cam = cam or CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                             width=320, height=240)
    return _make_sequence_cached(n_frames, cam, n_points, seed)

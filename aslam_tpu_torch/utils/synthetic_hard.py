"""Hard synthetic RGB-D suite: textured-surface raycast renders.

The point-splat generator (synthetic.py) gives every landmark a unique
texture stamp — matching is nearly trivial by construction and the images
carry no lens distortion.  This module renders *surfaces*:

  * a closed room (floor/ceiling/walls) plus interior panels, every surface
    carrying two-scale procedural texture (fine speckle for FAST corners +
    coarse contrast) — repeated, ambiguous local appearance like real scenes;
  * radial-tangential lens distortion applied at render time (the per-pixel
    rays come from *undistorting* the pixel grid, so the produced image is
    distorted exactly per the Brown model the pipeline later inverts);
  * Khoshelham depth noise sigma_z = c * z^2 (the reference's own error
    model, ransac.cpp:423-431), quantization to the TUM 1/5000 depth step,
    and salt dropout;
  * rolling illumination (per-frame gain/bias drift) + pixel noise;
  * 200+ frame loop trajectories that revisit their start.

Port of `aslam_tpu/utils/synthetic_hard.py`, kept as it is there: pure NumPy, so
the same seed gives the same frames.  Ground truth: exact T_cw per frame and
exact clean depth.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from aslam_tpu_torch.config import CameraModel


class Plane(NamedTuple):
    origin: np.ndarray   # [3] world corner
    u_axis: np.ndarray   # [3] unit
    v_axis: np.ndarray   # [3] unit
    u_len: float
    v_len: float
    tex_id: int


class Poster(NamedTuple):
    """A distinctive high-contrast patch on a plane (the visual-landmark
    role real rooms' objects/posters play for place recognition; without
    them a uniformly-textured box room is a pathological perceptual-
    aliasing case no appearance-based loop detector can solve)."""

    pid: int              # plane index
    a0: float             # plane-local origin (m)
    b0: float
    size: float           # square side (m)
    tex: np.ndarray       # [T, T] float in [0,1], unique pattern


class Scene(NamedTuple):
    planes: list          # list[Plane]
    fine_tex: np.ndarray  # [P, R, R] float in [0,1], nearest-sampled speckle
    coarse_tex: np.ndarray  # [P, C, C] float in [0,1], bilinear contrast
    fine_scale: float     # meters per fine texel
    coarse_scale: float   # meters per coarse texel
    posters: list = []    # list[Poster]


def room_scene(
    rng: np.random.Generator,
    half_x: float = 2.2,
    half_y: float = 1.4,
    half_z: float = 2.8,
    n_panels: int = 4,
    tex_res: int = 256,
    coarse_res: int = 64,
    fine_scale: float = 0.022,
    coarse_scale: float = 0.25,
    n_posters: int = 10,
    poster_res: int = 96,
) -> Scene:
    """A closed box room (+y is down; floor at y=+half_y) with interior
    panels for depth discontinuities and parallax."""
    def plane(origin, u, v, ul, vl, i):
        return Plane(np.asarray(origin, np.float64),
                     np.asarray(u, np.float64), np.asarray(v, np.float64),
                     float(ul), float(vl), i)

    planes = [
        # floor / ceiling
        plane([-half_x, half_y, -half_z], [1, 0, 0], [0, 0, 1],
              2 * half_x, 2 * half_z, 0),
        plane([-half_x, -half_y, -half_z], [1, 0, 0], [0, 0, 1],
              2 * half_x, 2 * half_z, 1),
        # walls z = +/-
        plane([-half_x, -half_y, half_z], [1, 0, 0], [0, 1, 0],
              2 * half_x, 2 * half_y, 2),
        plane([-half_x, -half_y, -half_z], [1, 0, 0], [0, 1, 0],
              2 * half_x, 2 * half_y, 3),
        # walls x = +/-
        plane([half_x, -half_y, -half_z], [0, 0, 1], [0, 1, 0],
              2 * half_z, 2 * half_y, 4),
        plane([-half_x, -half_y, -half_z], [0, 0, 1], [0, 1, 0],
              2 * half_z, 2 * half_y, 5),
    ]
    # interior panels: vertical rectangles at random positions/orientations
    for i in range(n_panels):
        cx = rng.uniform(-half_x * 0.7, half_x * 0.7)
        cz = rng.uniform(-half_z * 0.7, half_z * 0.7)
        yaw = rng.uniform(0, np.pi)
        w = rng.uniform(0.6, 1.4)
        h = rng.uniform(0.8, 2.0)
        u = np.array([np.cos(yaw), 0.0, np.sin(yaw)])
        origin = np.array([cx, half_y, cz]) - u * (w / 2)
        planes.append(plane(origin, u, [0, -1, 0], w, h, 6 + i))

    P = len(planes)
    fine = rng.uniform(0.0, 1.0, (P, tex_res, tex_res))
    coarse = rng.uniform(0.0, 1.0, (P, coarse_res, coarse_res))

    # distinctive posters on the walls (planes 2-5): unique binary-blocky
    # high-contrast patterns — the viewpoint-stable structure that makes a
    # place recognizable
    posters = []
    for i in range(n_posters):
        pid = 2 + (i % 4)
        pl = planes[pid]
        size = rng.uniform(0.45, 0.8)
        a0 = rng.uniform(0.05, max(pl.u_len - size - 0.05, 0.1))
        b0 = rng.uniform(0.05, max(pl.v_len - size - 0.05, 0.1))
        cells = rng.integers(5, 9)
        pat = rng.uniform(0, 1, (cells, cells)) > 0.5
        tex = np.kron(pat, np.ones((poster_res // cells + 1,) * 2))
        tex = tex[:poster_res, :poster_res].astype(np.float32)
        # soften edges slightly so FAST finds corners, not just saturation
        tex = 0.9 * tex + 0.05
        posters.append(Poster(pid, float(a0), float(b0), float(size), tex))

    return Scene(planes, fine.astype(np.float32),
                 coarse.astype(np.float32), fine_scale, coarse_scale,
                 posters)


# ------------------------------------------------------------------ rays

def _undistort_grid(cam: CameraModel, iters: int = 10) -> np.ndarray:
    """Undistorted normalized coords for every pixel center (the inverse
    Brown model, same fixed-point scheme as utils/camera.undistort_points).
    Rendering along these rays BAKES the distortion into the image."""
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                       np.arange(cam.height, dtype=np.float64))
    xd = (u - cam.cx) / cam.fx
    yd = (v - cam.cy) / cam.fy
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y], axis=-1)  # [H,W,2]


_GRID_CACHE: dict = {}


def _rays(cam: CameraModel) -> np.ndarray:
    key = (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
           cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
    if key not in _GRID_CACHE:
        g = _undistort_grid(cam)
        d = np.concatenate([g, np.ones_like(g[..., :1])], axis=-1)
        _GRID_CACHE[key] = d.reshape(-1, 3)  # [HW,3], z component == 1
    return _GRID_CACHE[key]


def _sample_tex(scene: Scene, pid: int, a: np.ndarray, b: np.ndarray):
    """Two-scale procedural intensity at plane-local coords (a, b)."""
    ft = scene.fine_tex[pid]
    ct = scene.coarse_tex[pid]
    R = ft.shape[0]
    C = ct.shape[0]
    ia = np.floor(a / scene.fine_scale).astype(np.int64) % R
    ib = np.floor(b / scene.fine_scale).astype(np.int64) % R
    fine = ft[ia, ib]
    # bilinear coarse
    fa = a / scene.coarse_scale
    fb = b / scene.coarse_scale
    i0 = np.floor(fa).astype(np.int64)
    j0 = np.floor(fb).astype(np.int64)
    wa = fa - i0
    wb = fb - j0
    i0 %= C
    j0 %= C
    i1 = (i0 + 1) % C
    j1 = (j0 + 1) % C
    coarse = (ct[i0, j0] * (1 - wa) * (1 - wb) + ct[i1, j0] * wa * (1 - wb)
              + ct[i0, j1] * (1 - wa) * wb + ct[i1, j1] * wa * wb)
    return 0.55 * fine + 0.45 * coarse


def render(
    cam: CameraModel,
    T_cw: np.ndarray,
    scene: Scene,
    rng: np.random.Generator | None = None,
    depth_noise_c: float = 0.01,
    depth_dropout: float = 0.02,
    illum_gain: float = 1.0,
    illum_bias: float = 0.0,
    px_noise: float = 2.0,
):
    """Raycast one RGB-D frame.  Returns (img [H,W] float32 0..255,
    depth [H,W] float32 meters with noise/quantization/dropout,
    depth_clean [H,W] float32 exact)."""
    H, W = cam.height, cam.width
    d_cam = _rays(cam)                                   # [HW,3]
    R_cw, t_cw = T_cw[:3, :3], T_cw[:3, 3]
    Cw = -R_cw.T @ t_cw
    d_w = d_cam @ R_cw                                   # R_cw^T @ d per row

    best_t = np.full(H * W, np.inf)
    best_pid = np.full(H * W, -1, np.int32)
    best_a = np.zeros(H * W)
    best_b = np.zeros(H * W)
    for pid, pl in enumerate(scene.planes):
        n = np.cross(pl.u_axis, pl.v_axis)
        denom = d_w @ n
        denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        t = ((pl.origin - Cw) @ n) / denom               # camera depth (d_cam z=1)
        P = Cw[None, :] + t[:, None] * d_w
        rel = P - pl.origin
        a = rel @ pl.u_axis
        b = rel @ pl.v_axis
        ok = (t > 0.05) & (a >= 0) & (a <= pl.u_len) & (b >= 0) & (b <= pl.v_len)
        win = ok & (t < best_t)
        best_t = np.where(win, t, best_t)
        best_pid = np.where(win, pid, best_pid)
        best_a = np.where(win, a, best_a)
        best_b = np.where(win, b, best_b)

    img = np.full(H * W, 0.15, np.float64)
    for pid in range(len(scene.planes)):
        sel = best_pid == pid
        if sel.any():
            img[sel] = _sample_tex(scene, pid, best_a[sel], best_b[sel])
    for po in scene.posters:
        sel = ((best_pid == po.pid)
               & (best_a >= po.a0) & (best_a < po.a0 + po.size)
               & (best_b >= po.b0) & (best_b < po.b0 + po.size))
        if sel.any():
            T = po.tex.shape[0]
            ia = np.clip(((best_a[sel] - po.a0) / po.size * T).astype(
                np.int64), 0, T - 1)
            ib = np.clip(((best_b[sel] - po.b0) / po.size * T).astype(
                np.int64), 0, T - 1)
            # blend a little base speckle back in so the poster interior
            # still carries fine texture for descriptors
            base = img[sel]
            img[sel] = 0.75 * po.tex[ia, ib] + 0.25 * base
    img = 20.0 + 215.0 * img
    img = img * illum_gain + illum_bias
    if rng is not None and px_noise > 0:
        img = img + rng.normal(0.0, px_noise, img.shape)
    img = np.clip(img, 0.0, 255.0).astype(np.float32).reshape(H, W)

    depth_clean = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    depth = depth_clean.copy()
    if rng is not None:
        if depth_noise_c > 0:
            depth = depth + rng.normal(0.0, 1.0, depth.shape).astype(
                np.float32) * depth_noise_c * depth * depth
        if depth_dropout > 0:
            drop = rng.uniform(size=depth.shape) < depth_dropout
            depth = np.where(drop, 0.0, depth)
    # TUM uint16 storage quantization (5000 counts per meter, max 65535)
    step = np.float32(cam.depth_factor)
    depth = np.round(depth / step) * step
    depth = np.where(depth * 5000.0 > 65535.0, 0.0, depth).astype(np.float32)
    return img, depth.reshape(H, W), depth_clean.reshape(H, W)


# ------------------------------------------------------------ trajectories

def _look_at_pose(C: np.ndarray, forward: np.ndarray) -> np.ndarray:
    """T_cw with camera center C, +z along `forward`, +y ~ world +y (down)."""
    z = forward / np.linalg.norm(forward)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], axis=1)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ C
    return T


def loop_trajectory(
    n_frames: int = 200,
    radius: float = 1.0,
    rng: np.random.Generator | None = None,
    bob: float = 0.08,
    jitter_t: float = 0.004,
) -> np.ndarray:
    """A full circle inside the room, tangent-looking, returning to the
    start pose: the canonical loop-closure sequence (>=200 frames)."""
    rng = rng or np.random.default_rng(0)
    Ts = []
    for i in range(n_frames):
        th = 2.0 * np.pi * i / (n_frames - 1)
        C = np.array([radius * np.sin(th),
                      bob * np.sin(3.0 * th),
                      -radius * np.cos(th)])
        C = C + rng.normal(0.0, jitter_t, 3)
        fwd = np.array([np.cos(th), 0.0, np.sin(th)])  # tangent
        Ts.append(_look_at_pose(C, fwd))
    return np.stack(Ts).astype(np.float64)


def sweep_trajectory(
    n_frames: int = 100,
    rng: np.random.Generator | None = None,
    step_t: float = 0.02,
    step_r: float = 0.01,
) -> np.ndarray:
    """Forward-ish random walk (config-1 style odometry clip) starting at
    the room center looking +z."""
    rng = rng or np.random.default_rng(0)
    from aslam_tpu_torch.utils.synthetic import _np_se3_exp

    T = np.eye(4)
    Ts = [T.copy()]
    for _ in range(n_frames - 1):
        xi = np.concatenate([
            rng.normal(0.0, step_t, 3), rng.normal(0.0, step_r, 3),
        ])
        T = _np_se3_exp(xi.astype(np.float32)).astype(np.float64) @ T
        Ts.append(T.copy())
    return np.stack(Ts)


def make_hard_sequence(
    cam: CameraModel,
    kind: str = "loop",
    n_frames: int = 200,
    seed: int = 0,
    depth_noise_c: float = 0.01,
    illum_period: float = 80.0,
    **traj_kw,
):
    """Render a full hard sequence.  Returns (imgs [F,H,W] float32,
    depths [F,H,W] float32, poses T_cw [F,4,4] float64)."""
    rng = np.random.default_rng(seed)
    scene = room_scene(rng)
    if kind == "loop":
        poses = loop_trajectory(n_frames, rng=rng, **traj_kw)
    elif kind == "sweep":
        poses = sweep_trajectory(n_frames, rng=rng, **traj_kw)
    else:
        raise ValueError(kind)
    imgs, depths = [], []
    for i, T in enumerate(poses):
        gain = 1.0 + 0.18 * np.sin(2.0 * np.pi * i / illum_period)
        bias = 6.0 * np.sin(2.0 * np.pi * i / illum_period + 1.3)
        img, dep, _ = render(cam, T, scene, rng=rng,
                             depth_noise_c=depth_noise_c,
                             illum_gain=gain, illum_bias=bias)
        imgs.append(img)
        depths.append(dep)
    return np.stack(imgs), np.stack(depths), poses

"""Offline map/trajectory snapshot + HUD counters.

Port of `aslam_tpu/utils/viewer.py`, the replacement for the reference's
Pangolin viewer thread (Drawer/viewer.cpp, mapdrawer.cpp): the map's
landmarks, keyframe positions, trajectory and strong covisibility edges
drawn top-down to a PNG, and the HUD's counters as a dict.  The reference
draws with matplotlib; the port rasterizes with numpy and writes the PNG
with `utils/dataset.py::write_png`, so it needs no plotting library (the
machines that run the port on a card have none).  The picture has no text:
a light grid marks every metre, and `hud_counters` gives the numbers.

Both take either engine: the host `SlamSystem` (its `tracking.map`) or the
device `DeviceSlam` (its `state.m`).  The map's tensors may lie on the card;
each is read back once through `device.to_host` (counted in
`read_host.count`), never with `.numpy()` on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np

from aslam_tpu_torch.device import read_host, to_host


def _host(x) -> np.ndarray:
    """A tensor on any device (one counted read) or an array -> numpy."""
    return to_host(x) if hasattr(x, "cpu") else np.asarray(x)


def engine_map(slam):
    """The engine's MapState: `SlamSystem.tracking.map` or
    `DeviceSlam.state.m`."""
    tracking = getattr(slam, "tracking", None)
    return tracking.map if tracking is not None else slam.state.m


def engine_trajectory(slam) -> np.ndarray:
    """[N,4,4] T_cw of every frame the engine has processed."""
    tracking = getattr(slam, "tracking", None)
    if tracking is not None:
        return (np.stack(tracking.poses) if tracking.poses
                else np.zeros((0, 4, 4), np.float32))
    import torch

    return to_host(torch.cat(slam.pose_buf))


def _centers(T_cw: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of [N,4,4] world-to-camera poses."""
    return -np.einsum("kij,ki->kj", T_cw[:, :3, :3], T_cw[:, :3, 3])


def hud_counters(slam) -> dict:
    """The Pangolin HUD variables (viewer.cpp:41-48) as a dict, from one
    read of the map's counts (and, for `DeviceSlam`, of its last stats row:
    tracked, matched, RANSAC inliers)."""
    import torch

    m = engine_map(slam)
    n_kf = torch.sum(m.kf_valid.to(torch.int32))
    n_lm = torch.sum(m.lm_valid.to(torch.int32))
    tracking = getattr(slam, "tracking", None)
    if tracking is not None:
        n_kf, n_lm = read_host(n_kf, n_lm)
        last = tracking.stats[-1] if tracking.stats else {}
        tracked = (last.get("n_tracked", 0), last.get("n_matches", 0),
                   last.get("ransac_inliers", 0))
        frames = len(tracking.poses)
    else:
        row = (slam.stats_buf[-1][0, :3] if slam.stats_buf
               else torch.zeros(3, device=n_kf.device))
        n_kf, n_lm, *tracked = read_host(n_kf, n_lm, row)
        frames = slam.n_processed
    return {
        "keyframes": n_kf,
        "landmarks": n_lm,
        "tracked_landmarks": tracked[0],
        "frame_matches": tracked[1],
        "ransac_inliers": tracked[2],
        "frames_processed": frames,
    }


# colours of the reference's plots (RGB)
_GREY = (136, 136, 136)
_BLUE = (43, 108, 176)
_RED = (229, 62, 62)
_GREEN = (56, 161, 105)
_GRID = (228, 228, 228)


def _dots(canvas: np.ndarray, px: np.ndarray, color, r: int = 0) -> None:
    """Squares of side 2r+1 at [N,2] (x, y) pixel positions, clipped."""
    if not len(px):
        return
    h, w = canvas.shape[:2]
    off = np.arange(-r, r + 1)
    xs = (np.round(px[:, 0])[:, None, None] + off[None, None, :]).astype(int)
    ys = (np.round(px[:, 1])[:, None, None] + off[None, :, None]).astype(int)
    xs, ys = np.broadcast_arrays(xs, ys)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def _lines(canvas: np.ndarray, a: np.ndarray, b: np.ndarray, color) -> None:
    """Segments from [N,2] (x, y) pixel positions a to b, one pixel wide."""
    for p, q in zip(a, b):
        n = int(np.ceil(np.abs(q - p).max())) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        _dots(canvas, p[None] * (1 - t) + q[None] * t, color)


def _gray_rgb(img: np.ndarray) -> np.ndarray:
    return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)


def draw_matches(img1, xy1, img2, xy2, match_idx, path: str,
                 valid=None, max_lines: int = 200) -> None:
    """Side-by-side correspondence visualization (the reference's
    Matcher::DrawMatches debug helper, matcher.cpp:315-353), written to a
    PNG instead of a cv::imshow window: a line per match (at most
    `max_lines`), frame-1 points red, frame-2 points blue.  Arrays or
    tensors."""
    from aslam_tpu_torch.utils.dataset import write_png

    img1, xy1, img2, xy2 = (_host(x) for x in (img1, xy1, img2, xy2))
    match_idx = _host(match_idx)
    ok = match_idx >= 0
    if valid is not None:
        ok = ok & _host(valid)

    h = max(img1.shape[0], img2.shape[0])
    w1 = img1.shape[1]
    canvas = np.zeros((h, w1 + img2.shape[1], 3), np.uint8)
    canvas[: img1.shape[0], :w1] = _gray_rgb(img1)
    canvas[: img2.shape[0], w1:] = _gray_rgb(img2)
    idx = np.nonzero(ok)[0][:max_lines]
    p1 = xy1[idx].astype(np.float64)
    p2 = xy2[match_idx[idx]].astype(np.float64) + [w1, 0.0]
    _lines(canvas, p1, p2, _GREEN)
    _dots(canvas, p1, _RED, 1)
    _dots(canvas, p2, _BLUE, 1)
    write_png(path, canvas)


def render_map(slam, path: str, show_covisibility: bool = True,
               min_covis_weight: int = 100, size: int = 800) -> None:
    """Top-down (x-z) map snapshot, `size` pixels square, x to the right and
    z up at one scale: landmarks grey, trajectory blue, keyframes red,
    strong covisibility edges green (mapdrawer.cpp:52-158)."""
    from aslam_tpu_torch.models import mapstate as ms
    from aslam_tpu_torch.utils.dataset import write_png

    m = engine_map(slam)
    lms = to_host(m.lm_pos)[to_host(m.lm_valid)][:, [0, 2]]
    traj = engine_trajectory(slam)
    centers = _centers(traj)[:, [0, 2]]
    kf_valid = to_host(m.kf_valid)
    kfc = _centers(to_host(m.kf_T_cw)[kf_valid])[:, [0, 2]]

    pts = np.concatenate([lms, centers, kfc]).astype(np.float64)
    lo = pts.min(0) if len(pts) else np.zeros(2)
    hi = pts.max(0) if len(pts) else np.ones(2)
    mid, span = (lo + hi) / 2, max(float((hi - lo).max()), 1e-3) * 1.1
    scale = (size - 1) / span

    def px(xz):                                   # (x, z) -> (col, row)
        u = (xz - mid) * scale + (size - 1) / 2
        return np.stack([u[:, 0], size - 1 - u[:, 1]], -1)

    canvas = np.full((size, size, 3), 255, np.uint8)
    for v in np.arange(np.ceil(mid - span / 2).min(),
                       np.floor(mid + span / 2).max() + 1):
        line = px(np.array([[v, v]], np.float64))[0]
        for k in (0, 1):
            c = int(round(line[k]))
            if 0 <= c < size:
                if k == 0:
                    canvas[:, c] = _GRID
                else:
                    canvas[c, :] = _GRID
    _dots(canvas, px(lms), _GREY)
    if len(centers) > 1:
        _lines(canvas, px(centers[:-1]), px(centers[1:]), _BLUE)
    if show_covisibility and kf_valid.sum() >= 2:
        W = to_host(ms.covisibility(m))
        idx = np.nonzero(kf_valid)[0]
        a, b = np.nonzero(np.triu(W[np.ix_(idx, idx)] >= min_covis_weight, 1))
        _lines(canvas, px(kfc[a]), px(kfc[b]), _GREEN)
    _dots(canvas, px(kfc), _RED, 3)
    write_png(path, canvas)

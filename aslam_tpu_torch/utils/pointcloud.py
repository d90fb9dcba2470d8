"""Dense point-cloud creation and export.

Port of `aslam_tpu/utils/pointcloud.py`: backproject a depth map, thin it
with the voxel hash, transform to the world and write a PLY any viewer
opens; a statistical outlier filter for export-sized clouds.
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch.ops.icp import backproject_depth, voxel_downsample


def create_cloud(depth: np.ndarray, cam, T_cw: np.ndarray | None = None,
                 intensity: np.ndarray | None = None, stride: int = 2,
                 voxel: float = 0.03, device: torch.device | str = "cpu"):
    """Depth image [H,W] (metres) -> world-frame points [N,3] float32 (and
    gray values [N] when an intensity image is given).  Backprojection and
    voxel thinning run on `device`."""
    d = torch.from_numpy(np.ascontiguousarray(
        depth[::stride, ::stride], dtype=np.float32)).to(device)
    pts = backproject_depth(d, cam).reshape(-1, 3)
    valid = d.reshape(-1) > 0.05
    if voxel > 0:
        _, valid = voxel_downsample(pts, valid, cell=voxel)
    valid = valid.cpu().numpy()
    pts = pts.cpu().numpy()[valid]
    gray = None
    if intensity is not None:
        gray = intensity[::stride, ::stride].reshape(-1)[valid]
    if T_cw is not None:
        T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
        pts = pts @ T_wc[:3, :3].T + T_wc[:3, 3]
    return pts.astype(np.float32), gray


def statistical_outlier_filter(pts: np.ndarray, k: int = 16,
                               std_ratio: float = 1.0) -> np.ndarray:
    """Mask of the points whose mean distance to their k nearest neighbours
    is at most mean + std_ratio * std over the cloud.  O(N^2) in chunks:
    for export-sized clouds, not the hot path."""
    n = len(pts)
    if n == 0:
        return np.zeros(0, bool)
    mean_d = np.empty(n, np.float32)
    chunk = 2048
    for s in range(0, n, chunk):
        d = np.linalg.norm(pts[s:s + chunk, None, :] - pts[None, :, :], axis=-1)
        part = np.partition(d, min(k, n - 1), axis=1)[:, 1:k + 1]
        mean_d[s:s + chunk] = part.mean(1)
    return mean_d <= mean_d.mean() + std_ratio * mean_d.std()


def save_ply(path: str, pts: np.ndarray, gray: np.ndarray | None = None) -> None:
    """ASCII PLY writer."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if gray is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if gray is not None:
            g = np.clip(gray, 0, 255).astype(np.uint8)
            for p, c in zip(pts, g):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c} {c} {c}\n")
        else:
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def export_dense_map(slam, seq, path: str, voxel: float = 0.03,
                     max_frames: int = 20) -> int:
    """Fuse frames of an indexable sequence of (timestamp, image, depth)
    with the host engine's tracked trajectory into one world cloud ->
    the number of points.  Frame i of `seq` belongs to pose i."""
    clouds, grays = [], []
    poses = slam.tracking.poses
    n = min(len(seq), len(poses))
    step = max(n // max_frames, 1)
    for i in range(0, n, step):
        _, img, depth = seq[i]
        pts, gray = create_cloud(depth, slam.cfg.camera, poses[i], img,
                                 voxel=voxel, device=slam.device)
        clouds.append(pts)
        grays.append(gray)
    pts = np.concatenate(clouds) if clouds else np.zeros((0, 3), np.float32)
    save_ply(path, pts, np.concatenate(grays) if clouds else None)
    return len(pts)

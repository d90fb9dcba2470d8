"""ATE evaluation in numpy.

A copy of the numpy part of `aslam_tpu/utils/trajectory.py` (rigid Umeyama
alignment and the TUM ATE RMSE), so that the port scores a trajectory
without importing jax.
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray):
    """Rigid (no-scale) alignment of estimated positions onto ground truth,
    the standard TUM ATE alignment."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    H = (est - mu_e).T @ (gt - mu_g) / len(est)
    U, _, Vt = np.linalg.svd(H)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE after rigid alignment (TUM metric)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if align:
        R, t = align_umeyama(est, gt)
        est = est @ R.T + t
    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def camera_centers(poses_cw: np.ndarray) -> np.ndarray:
    """World positions of the camera centres of T_cw poses [F,4,4] -> [F,3]."""
    poses = np.asarray(poses_cw, np.float64)
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    return -np.einsum("fji,fj->fi", R, t)

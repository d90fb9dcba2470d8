"""Trajectory export and ATE / RPE evaluation.

Port of `aslam_tpu/utils/trajectory.py`: the TUM trajectory format
(`t x y z qx qy qz qw`, camera-to-world), rigid Umeyama alignment, the TUM
ATE RMSE in numpy and on tensors (`ate_rmse_device`: only the scalar leaves
the device), the relative pose error, and the trajectory rebuilt from the
final keyframe poses.
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch.utils import se3


def save_tum_trajectory(path: str, timestamps: np.ndarray,
                        poses_cw: np.ndarray) -> None:
    """Write a camera trajectory in TUM format.  Poses are world-to-camera
    `T_cw` [F,4,4]; TUM wants camera-to-world."""
    T_wc = se3.T_inv(torch.from_numpy(
        np.asarray(poses_cw, np.float32).reshape(-1, 4, 4)))
    q = se3.R_to_quat(T_wc[:, :3, :3]).numpy()
    xyz = T_wc[:, :3, 3].numpy()
    with open(path, "w") as f:
        for t, p, qi in zip(timestamps, xyz, q):
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{qi[0]:.6f} {qi[1]:.6f} {qi[2]:.6f} {qi[3]:.6f}\n")


def load_tum_trajectory(path: str):
    """Read a TUM trajectory -> (timestamps [F], positions [F,3], quats [F,4])."""
    data = np.loadtxt(path, comments="#").reshape(-1, 8)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


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


def rebuild_trajectory(kf_valid, kf_ids, kf_T, culled: dict, ref_ids, rels,
                       frozen) -> np.ndarray:
    """The camera trajectory rebuilt from the final keyframe poses (numpy):
    T_cw(t) = T_cr(t) T_rw(final), walking the culled-keyframe parent chain
    `culled` (kf_id -> (parent_kf_id, T_cp)) to a surviving ancestor; a
    frame with none keeps its tracked pose `frozen[t]`.  So local BA,
    keyframe culling and loop corrections reach the exported trajectory."""
    id2slot = {int(i): s for s, i in enumerate(kf_ids) if kf_valid[s]}
    out = []
    for i, r in enumerate(ref_ids):
        r = int(r)
        T_acc = rels[i]
        hops = 0
        while r not in id2slot and r in culled and hops < len(culled) + 1:
            parent, T_rp = culled[r]
            T_acc = T_acc @ T_rp
            r = parent
            hops += 1
        out.append(T_acc @ kf_T[id2slot[r]] if r in id2slot else frozen[i])
    return np.stack(out)


def ate_rmse_device(est_cw: torch.Tensor, gt_cw: torch.Tensor) -> torch.Tensor:
    """ATE RMSE on the tensors' device: rigid Umeyama alignment of the camera
    centres of T_cw poses [F,4,4], then the RMSE, as one 0-d tensor."""
    est = se3.T_inv(est_cw)[..., :3, 3]
    gt = se3.T_inv(gt_cw)[..., :3, 3]
    mu_e, mu_g = est.mean(0), gt.mean(0)
    H = (est - mu_e).T @ (gt - mu_g) / est.shape[0]
    U, _, Vt = torch.linalg.svd(H)
    sign = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(sign), torch.ones_like(sign),
                                sign]))
    R = Vt.T @ D @ U.T
    err = est @ R.T + (mu_g - R @ mu_e) - gt
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=1)))


def rpe_rmse(est_cw: np.ndarray, gt_cw: np.ndarray, delta: int = 1):
    """Relative pose error RMSE (translation, rotation) over pose pairs
    `delta` frames apart."""
    est = np.asarray(est_cw, np.float64)
    gt = np.asarray(gt_cw, np.float64)
    de = np.linalg.inv(est[:-delta]) @ est[delta:]
    dg = np.linalg.inv(gt[:-delta]) @ gt[delta:]
    e = np.linalg.inv(dg) @ de
    t_err = np.linalg.norm(e[:, :3, 3], axis=1)
    tr = np.clip((np.trace(e[:, :3, :3], axis1=1, axis2=2) - 1.0) / 2.0,
                 -1.0, 1.0)
    return (float(np.sqrt(np.mean(np.square(t_err)))),
            float(np.sqrt(np.mean(np.square(np.arccos(tr))))))

"""Detector / descriptor evaluation: homography tools, match filtering,
recall-precision curves.

Port of `aslam_tpu/utils/evaluation.py`, the repeatability and
recall / precision tooling of the feature families.  `homography_dlt` is
the Hartley-normalized weighted DLT solved by SVD; the null vector's sign
is arbitrary, and the final division by H[2,2] removes it.
`find_homography_ransac` takes the raw draws as an optional `draws [H,4]`
tensor of integers in [0, n_good) (what the reference draws with
`jax.random.randint` before its `searchsorted`); without it the port draws
them from `generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from aslam_tpu_torch.ops import hamming
from aslam_tpu_torch.ops.ransac import sample_draws


def homography_dlt(src: torch.Tensor, dst: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT homography fit: src/dst [...,N,2], w [...,N] -> H
    [...,3,3] (batched over the leading dims), normalized to H[2,2] = 1."""
    wn = w / (torch.sum(w, -1, keepdim=True) + 1e-9)
    mu_s = torch.einsum("...n,...ni->...i", wn, src)
    mu_d = torch.einsum("...n,...ni->...i", wn, dst)
    s_s = torch.einsum("...n,...n->...", wn, torch.linalg.vector_norm(
        src - mu_s[..., None, :], dim=-1)) + 1e-9
    s_d = torch.einsum("...n,...n->...", wn, torch.linalg.vector_norm(
        dst - mu_d[..., None, :], dim=-1)) + 1e-9
    sn = (src - mu_s[..., None, :]) / s_s[..., None, None]
    dn = (dst - mu_d[..., None, :]) / s_d[..., None, None]

    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    sw = torch.sqrt(w)[..., None]
    A = torch.cat([r1 * sw, r2 * sw], -2)                 # [...,2N,9]
    h = torch.linalg.svd(A, full_matrices=False).Vh[..., -1, :]
    Hn = h.reshape(h.shape[:-1] + (3, 3))

    def trans(mu, s):
        """[[1/s, 0, -mu_x/s], [0, 1/s, -mu_y/s], [0, 0, 1]]."""
        z, o = torch.zeros_like(s), torch.ones_like(s)
        return torch.stack([
            torch.stack([1.0 / s, z, -mu[..., 0] / s], -1),
            torch.stack([z, 1.0 / s, -mu[..., 1] / s], -1),
            torch.stack([z, z, o], -1)], -2)

    H = torch.linalg.inv(trans(mu_d, s_d)) @ Hn @ trans(mu_s, s_s)
    return H / (H[..., 2:3, 2:3] + 1e-12)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    ph = torch.cat([pts, torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype,
                                    device=pts.device)], -1)
    q = torch.einsum("...ij,...nj->...ni", H, ph)
    return q[..., :2] / (q[..., 2:3] + 1e-12)


def find_homography_ransac(
    src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
    generator: torch.Generator | None = None, thresh_px: float = 3.0,
    n_hyp: int = 128, refine: int = 2, draws: torch.Tensor | None = None,
):
    """RANSAC homography: parallel 4-point hypotheses -> DLT -> inlier count
    -> `refine` masked refits -> (H [3,3], inliers [N], n_inliers)."""
    N = src.shape[0]
    good = valid.to(torch.int64)
    if draws is None:
        draws = sample_draws(torch.sum(good), (n_hyp, 4), generator)
    csum = torch.cumsum(good, 0)
    sample = torch.clamp(torch.searchsorted(
        csum, draws.to(torch.int64).contiguous(), right=True), 0, N - 1)

    H = homography_dlt(src[sample], dst[sample],
                       torch.ones(n_hyp, 4, dtype=src.dtype, device=src.device))
    src_b = src.expand(n_hyp, N, 2)
    dst_b = dst.expand(n_hyp, N, 2)

    def inliers_of(H):
        err = torch.linalg.vector_norm(apply_homography(H, src_b) - dst[None],
                                       dim=-1)
        return valid[None, :] & (err < thresh_px)

    for _ in range(refine):
        H = homography_dlt(src_b, dst_b, inliers_of(H).to(src.dtype))
    inl = inliers_of(H)
    n = torch.sum(inl, dim=1)
    best = torch.argmax(n)
    return H[best], inl[best], n[best]


def distance_filter(src_xy: np.ndarray, dst_xy: np.ndarray, H: np.ndarray,
                    max_px: float = 3.0) -> np.ndarray:
    """Reprojection gate for putative matches under a known homography."""
    proj = apply_homography(torch.as_tensor(H, dtype=torch.float32),
                            torch.as_tensor(src_xy, dtype=torch.float32))
    return np.linalg.norm(proj.numpy() - dst_xy, axis=-1) <= max_px


def _descriptors(d: np.ndarray) -> torch.Tensor:
    """numpy descriptors -> a tensor, packed uint32 words as int32."""
    d = np.asarray(d)
    return torch.from_numpy(d.view(np.int32) if d.dtype == np.uint32 else d)


def recall_precision_curve(
    desc1: np.ndarray, desc2: np.ndarray,
    xy1: np.ndarray, xy2: np.ndarray,
    H_12: np.ndarray, eps_px: float = 3.0, n_thresholds: int = 300,
):
    """Recall / precision over descriptor-distance thresholds: a ground-truth
    correspondence is a reprojection within eps under the known homography;
    a match at threshold t is the nearest neighbour with distance <= t."""
    d = hamming.distance_matrix(_descriptors(desc1), _descriptors(desc2)).numpy()
    nn2 = d.argmin(axis=1)
    nn_dist = d.min(axis=1)
    proj = apply_homography(torch.as_tensor(H_12, dtype=torch.float32),
                            torch.as_tensor(xy1, dtype=torch.float32)).numpy()
    gt_ok = np.linalg.norm(proj - xy2[nn2], axis=-1) <= eps_px
    # ground-truth correspondences: kp1 whose projection has a kp2 within eps
    dist_all = np.linalg.norm(proj[:, None, :] - xy2[None, :, :], axis=-1)
    n_gt = max(int((dist_all <= eps_px).any(axis=1).sum()), 1)

    ts = np.linspace(0, 256, n_thresholds)
    recall, precision = [], []
    for t in ts:
        matched = nn_dist <= t
        tp = int((matched & gt_ok).sum())
        fp = int((matched & ~gt_ok).sum())
        recall.append(tp / n_gt)
        precision.append(tp / max(tp + fp, 1))
    return ts, np.asarray(recall), np.asarray(precision)

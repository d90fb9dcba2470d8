"""Faithful CPU re-execution of the reference odometry policy.

Port of `aslam_tpu/baselines/refcpu.py`: a numpy copy, its one import
(`CameraModel`) taken from the port's `config.py`.  Nothing here runs on the
card or uses torch: it is the sequential baseline that the engine's
accuracy is held against.

Without TUM/ICL data and without the reference's OpenCV/PCL/g2o stack,
the accuracy contract (BASELINE: ATE <= reference) is made falsifiable by
re-implementing the reference's HOT PATH **sequentially and exactly**, in
NumPy, and racing the device engine against it on identical inputs (the JAX
package's scripts/accuracy_compare.py).

What is reproduced, quirks included (each cited):

Ransac::Iterate (ransac.cpp:155-267)
  * depth-validity prefilter (ransac.cpp:175-189)
  * matches sorted by descriptor distance (ransac.cpp:199; cv::DMatch <)
  * SampleMatches: index = min(rand()%N, rand()%N) — biased toward the
    best-distance matches (ransac.cpp:269-293)
  * inner refinement <= 20 rounds: weighted Umeyama w = 1/(z1*z2)
    (ransac.cpp:295-313, pcl::TransformationFromCorrespondences), inlier
    re-gating, keep while inliers grow and error shrinks (ransac.cpp:95-118)
  * early exit: n += 10 at >50% inliers, += 10 at >75%, break at >80%
    (ransac.cpp:128-133)
  * identity fallback when no valid iteration (ransac.cpp:138-150)
  * Mahalanobis gate (ErrorFunction2, ransac.cpp:350-431): raster
    covariance 3*tan(fov/res) scaled by z (LINEAR in z — as written),
    rotated into frame 2, LLT solve; the `static` locals in
    DepthCovariance (ransac.cpp:415-421) freeze the depth variance at the
    FIRST depth ever seen — reproduced behind `static_depth_cov=True`
  * ComputeInliersAndError skips matches with origin.z==0 or target.x==0
    (sic — .x, ransac.cpp:325-326)

PnPSolver::Compute (pnpsolver.cpp:17-213)
  * one SE3 vertex, mono (u,v) + pseudo-stereo (u,v,uR) unary edges
  * information = I / Xw.z^2 (the landmark's WORLD z, pnpsolver.cpp:74-75)
  * Huber delta = sqrt(5.991) mono / sqrt(7.815) stereo
  * 4 rounds x 10 LM iterations; chi2 reclassification between rounds;
    robust kernel dropped after round 3 (pnpsolver.cpp:144-205); pose
    RESET to the pre-BA estimate at the start of every round
    (pnpsolver.cpp:150: setEstimate(pFrame->GetPose()))

Odometry ADAPTIVE_RBA (odometry.cpp:105-116): T_cw2 = T12 @ T_cw1, then BA
against the VO landmarks carried from frame 1 (tracking.cpp:136-190).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from aslam_tpu_torch.config import CameraModel


# ------------------------------------------------------------------ RANSAC

@dataclass
class RefRansacParams:
    iterations: int = 200          # odometry.cpp:14
    min_inliers: int = 20
    max_mahalanobis: float = 3.0
    sample_size: int = 4
    static_depth_cov: bool = True  # reproduce ransac.cpp:415-421 statics


class _DepthCov:
    """DepthCovariance with C++ `static` initialization semantics: the
    stddev is computed once from the first depth passed in and reused for
    every later call (ransac.cpp:415-421)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.frozen: float | None = None

    def __call__(self, z: float) -> float:
        if self.enabled:
            if self.frozen is None:
                std = 0.01 * z * z
                self.frozen = std * std
            return self.frozen
        std = 0.01 * z * z
        return std * std


def weighted_umeyama(p_from: np.ndarray, p_to: np.ndarray,
                     w: np.ndarray) -> np.ndarray:
    """pcl::TransformationFromCorrespondences.getTransformation: weighted
    rigid fit (no scale) via SVD of the weighted cross-covariance."""
    wsum = w.sum()
    if wsum <= 0 or len(p_from) < 3:
        return np.eye(4)
    wn = w / wsum
    mu_f = (wn[:, None] * p_from).sum(0)
    mu_t = (wn[:, None] * p_to).sum(0)
    S = (wn[:, None, None]
         * (p_to - mu_t)[:, :, None] * (p_from - mu_f)[:, None, :]).sum(0)
    U, _, Vt = np.linalg.svd(S)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_t - R @ mu_f
    return T


class RefRansac:
    """Sequential reference RANSAC over matched camera-frame 3D pairs."""

    def __init__(self, cam: CameraModel, params: RefRansacParams | None = None,
                 seed: int = 0):
        self.cam = cam
        self.p = params or RefRansacParams()
        self.rng = np.random.default_rng(seed)
        self.depth_cov = _DepthCov(self.p.static_depth_cov)
        # raster covariance from FOV/resolution (ransac.cpp:352-357) —
        # constants match the reference's hardcoded 58/45 deg @ 640x480
        ax = np.deg2rad(cam.fov_x_deg)
        ay = np.deg2rad(cam.fov_y_deg)
        sx = 3.0 * np.tan(ax / 640.0)
        sy = 3.0 * np.tan(ay / 480.0)
        self.raster_cov_x = sx * sx
        self.raster_cov_y = sy * sy

    # -- ErrorFunction2 (ransac.cpp:350-431), vectorized over pairs ----
    def _mahal_sq_batch(self, p1: np.ndarray, p2: np.ndarray,
                        T12: np.ndarray) -> np.ndarray:
        """Per-pair squared Mahalanobis distance [N] (inf where rejected).
        Identical semantics to the scalar ErrorFunction2: the per-pair
        computations are independent, so batching changes nothing."""
        R = T12[:3, :3]
        mu1in2 = p1 @ R.T + T12[:3, 3]
        delta = mu1in2 - p2
        z1, z2 = p1[:, 2], p2[:, 2]
        # C++ `static` initialization: the depth variance freezes on the
        # first depth evaluated (ransac.cpp:415-421)
        dc1 = np.asarray([self.depth_cov(z) for z in z1]) \
            if not self.p.static_depth_cov else self.depth_cov(
                z1[0] if len(z1) else 1.0) * np.ones_like(z1)
        dc2 = self.depth_cov(z2[0] if len(z2) else 1.0) * np.ones_like(z2) \
            if self.p.static_depth_cov else np.asarray(
                [self.depth_cov(z) for z in z2])
        # error shortcut (ransac.cpp:374-381)
        s1 = np.maximum(self.raster_cov_x, dc1)
        s2 = np.maximum(self.raster_cov_x, dc2)
        dn = np.sum(delta * delta, axis=1)
        shortcut = dn > 2.0 * (s1 + s2)
        # cov1 rotated into frame 2 (sic: R^T cov1 R), plus cov2
        N = len(p1)
        cov1 = np.zeros((N, 3, 3))
        cov1[:, 0, 0] = self.raster_cov_x * z1
        cov1[:, 1, 1] = self.raster_cov_y * z1
        cov1[:, 2, 2] = dc1
        cov2 = np.zeros((N, 3, 3))
        cov2[:, 0, 0] = self.raster_cov_x * z2
        cov2[:, 1, 1] = self.raster_cov_y * z2
        cov2[:, 2, 2] = dc2
        cov_sum = np.einsum("ji,njk,kl->nil", R, cov1, R) + cov2
        try:
            sol = np.linalg.solve(cov_sum, delta[..., None])[..., 0]
        except np.linalg.LinAlgError:
            return np.full(N, np.inf)
        d2 = np.sum(delta * sol, axis=1)
        d2 = np.where(shortcut | ~(d2 >= 0.0) | ~np.isfinite(d2), np.inf, d2)
        return d2

    def _inliers_and_error(self, p1, p2, T12):
        """ComputeInliersAndError (ransac.cpp:315-347).  Returns
        (inlier index array, rmse)."""
        th2 = self.p.max_mahalanobis ** 2
        considered = ~((p1[:, 2] == 0.0) | (p2[:, 0] == 0.0))  # sic: target.x
        d2 = self._mahal_sq_batch(p1, p2, T12)
        inl = considered & np.isfinite(d2) & (d2 <= th2)
        idx = np.nonzero(inl)[0]
        if len(idx) < 3:
            return idx, 1e9
        return idx, float(np.sqrt(d2[idx].mean()))

    def _sample(self, n: int) -> np.ndarray:
        """SampleMatches (ransac.cpp:269-293): set of min(two uniforms)."""
        ids: set[int] = set()
        guard = 0
        while len(ids) < self.p.sample_size and n >= self.p.sample_size:
            i1 = int(self.rng.integers(0, n))
            i2 = int(self.rng.integers(0, n))
            ids.add(min(i1, i2))
            guard += 1
            if guard > 10000:
                break
        return np.asarray(sorted(ids), np.int64)

    def iterate(self, p1: np.ndarray, p2: np.ndarray,
                match_dist: np.ndarray):
        """Full Ransac::Iterate.  p1/p2 [N,3] matched camera points of
        frames 1/2 (source/target), match_dist [N] descriptor distances
        (for the reference's sort).  Returns (T12 [4,4], inlier index
        array into the SORTED order, rmse, ok)."""
        p = self.p
        order = np.argsort(match_dist, kind="stable")
        p1 = np.asarray(p1, np.float64)[order]
        p2 = np.asarray(p2, np.float64)[order]

        good = (p1[:, 2] > 0) & (p2[:, 2] > 0) \
            & np.isfinite(p1[:, 2]) & np.isfinite(p2[:, 2])
        p1, p2 = p1[good], p2[good]
        N = len(p1)
        if N < p.min_inliers:
            return np.eye(4), np.zeros(0, np.int64), 1e6, False

        best_T = np.eye(4)
        best_inl = np.zeros(0, np.int64)
        best_rmse = 1e6
        valid_iters = 0
        n = 0
        while n < p.iterations and N >= p.sample_size:
            inl = self._sample(N)
            refined_T = np.eye(4)
            refined_inl = np.zeros(0, np.int64)
            refined_err = 1e6
            for _ in range(1, 20):
                w = 1.0 / (p1[inl, 2] * p2[inl, 2])
                T = weighted_umeyama(p1[inl], p2[inl], w)
                inl2, err = self._inliers_and_error(p1, p2, T)
                if len(inl2) < p.min_inliers or err > p.max_mahalanobis:
                    break
                if len(inl2) >= len(refined_inl) and err <= refined_err:
                    prev = len(refined_inl)
                    refined_T, refined_inl, refined_err = T, inl2, err
                    inl = inl2
                    if len(inl2) == prev:
                        break
                else:
                    break
            if len(refined_inl) > 0:
                valid_iters += 1
                if (refined_err <= best_rmse
                        and len(refined_inl) >= len(best_inl)
                        and len(refined_inl) >= p.min_inliers):
                    best_rmse = refined_err
                    best_T = refined_T
                    best_inl = refined_inl
                    if len(refined_inl) > N * 0.5:
                        n += 10
                    if len(refined_inl) > N * 0.75:
                        n += 10
                    if len(refined_inl) > N * 0.8:
                        break
            n += 1

        if valid_iters == 0:  # identity rescue (ransac.cpp:138-150)
            inl2, err = self._inliers_and_error(p1, p2, np.eye(4))
            if len(inl2) > p.min_inliers and err < p.max_mahalanobis:
                best_T = np.eye(4)
                best_inl = inl2
                best_rmse = 1e6 + err
        ok = len(best_inl) >= p.min_inliers
        return best_T, order[np.nonzero(good)[0][best_inl]] if len(best_inl) else best_inl, best_rmse, ok


# ------------------------------------------------------- motion-only BA

def _se3_exp_g2o(xi: np.ndarray) -> np.ndarray:
    """g2o SE3Quat::exp with update = [omega, upsilon] (rotation first)."""
    phi, rho = xi[:3], xi[3:]
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0.0]])
    if th < 1e-10:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        a = np.sin(th) / th
        b = (1 - np.cos(th)) / th**2
        c = (th - np.sin(th)) / th**3
        R = np.eye(3) + a * K + b * K @ K
        V = np.eye(3) + b * K + c * K @ K
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def pose_only_ba(
    T_cw: np.ndarray,
    pts_w: np.ndarray,      # [N,3] landmark world positions
    obs_uv: np.ndarray,     # [N,2] undistorted pixel measurements
    obs_ur: np.ndarray,     # [N] right-u (<0 => mono edge)
    cam: CameraModel,
    rounds: int = 4,
    iters: int = 10,
):
    """PnPSolver::Compute (pnpsolver.cpp:17-213): LM on the unary
    reprojection edges with the g2o schedule.  Returns (T_cw, inlier mask,
    n_inliers)."""
    N = len(pts_w)
    if N < 3:
        return T_cw.copy(), np.zeros(N, bool), 0
    chi2_mono, chi2_stereo = 5.991, 7.815
    delta_m, delta_s = np.sqrt(chi2_mono), np.sqrt(chi2_stereo)
    is_stereo = obs_ur >= 0
    # information = 1 / Xw.z^2 — the WORLD z (pnpsolver.cpp:74-75, sic)
    info = 1.0 / np.maximum(pts_w[:, 2] ** 2, 1e-12)
    inlier = np.ones(N, bool)
    T0 = T_cw.copy()
    T = T_cw.copy()

    def residual_jac(T, sel):
        Pc = pts_w[sel] @ T[:3, :3].T + T[:3, 3]
        x, y, z = Pc[:, 0], Pc[:, 1], Pc[:, 2]
        z = np.maximum(z, 1e-6)
        u = cam.fx * x / z + cam.cx
        v = cam.fy * y / z + cam.cy
        ur = u - cam.bf / z
        r = np.stack([obs_uv[sel, 0] - u, obs_uv[sel, 1] - v,
                      np.where(is_stereo[sel], obs_ur[sel] - ur, 0.0)], -1)
        # d(u,v,ur)/d(Pc)
        iz = 1.0 / z
        iz2 = iz * iz
        Ju = np.stack([cam.fx * iz, np.zeros_like(z), -cam.fx * x * iz2], -1)
        Jv = np.stack([np.zeros_like(z), cam.fy * iz, -cam.fy * y * iz2], -1)
        Jur = Ju + np.stack([np.zeros_like(z), np.zeros_like(z),
                             cam.bf * iz2], -1)
        Jp = np.stack([Ju, Jv, np.where(is_stereo[sel, None], Jur, 0.0)], 1)
        # d(Pc)/d(xi) with xi = [omega, upsilon]: dPc = -[Pc]x w + v
        Jx = np.zeros((len(z), 3, 6))
        Jx[:, 0, 1] = Pc[:, 2]
        Jx[:, 0, 2] = -Pc[:, 1]
        Jx[:, 1, 0] = -Pc[:, 2]
        Jx[:, 1, 2] = Pc[:, 0]
        Jx[:, 2, 0] = Pc[:, 1]
        Jx[:, 2, 1] = -Pc[:, 0]
        Jx[:, :, 3:] = np.broadcast_to(np.eye(3), (len(z), 3, 3))
        J = -np.einsum("nij,njk->nik", Jp, Jx)   # residual = obs - proj
        return r, J, z

    for rnd in range(rounds):
        # g2o re-seeds from the frame's pose each round (pnpsolver.cpp:150)
        # and the frame pose is only written AFTER all rounds — so every
        # round restarts from the ORIGINAL pose, only the inlier
        # classification carries over
        T = T0.copy()
        robust = rnd < 3
        lam = None
        sel = np.nonzero(inlier)[0]
        if len(sel) < 3:
            break
        for _ in range(iters):
            r, J, z = residual_jac(T, sel)
            chi2 = (r * r).sum(-1) * info[sel]
            d = np.where(is_stereo[sel], delta_s, delta_m)
            if robust:
                s = np.sqrt(np.maximum(chi2, 1e-12))
                w_h = np.where(s <= d, 1.0, d / s)
            else:
                w_h = np.ones_like(chi2)
            w = info[sel] * w_h
            H = np.einsum("nri,n,nrj->ij", J, w, J)
            b = np.einsum("nri,n,nr->i", J, w, r)
            if lam is None:
                lam = 1e-5 * np.max(np.diag(H))
            try:
                dx = np.linalg.solve(H + lam * np.eye(6), -b)
            except np.linalg.LinAlgError:
                break
            T_new = _se3_exp_g2o(dx) @ T
            r2, _, _ = residual_jac(T_new, sel)
            chi2_new = (r2 * r2).sum(-1) * info[sel]
            if robust:
                s2 = np.sqrt(np.maximum(chi2_new, 1e-12))
                c_new = np.where(s2 <= d, chi2_new, 2 * d * s2 - d * d).sum()
                s1 = np.sqrt(np.maximum(chi2, 1e-12))
                c_old = np.where(s1 <= d, chi2, 2 * d * s1 - d * d).sum()
            else:
                c_new, c_old = chi2_new.sum(), chi2.sum()
            if c_new < c_old:
                T = T_new
                lam = max(lam / 3.0, 1e-12)
            else:
                lam *= 3.0
        # chi2 reclassification over ALL edges (pnpsolver.cpp:157-199)
        r_all, _, _ = residual_jac(T, np.arange(N))
        chi2_all = (r_all * r_all).sum(-1) * info
        th = np.where(is_stereo, chi2_stereo, chi2_mono)
        inlier = chi2_all <= th
    return T, inlier, int(inlier.sum())

"""Global bundle adjustment over the whole map.

Port of `aslam_tpu/ops/global_ba.py`.  Two methods:

  "sweep"  alternating resection / intersection: a per-keyframe 6x6
           Gauss-Newton with the landmarks fixed, then a per-landmark 3x3
           Gauss-Newton with the poses fixed (an ordered scatter-add of the
           edge blocks onto their landmarks, `ops/index.py`);
  "gn_cg"  one joint Gauss-Newton step over all poses and points per call,
           solved matrix-free by block-Jacobi-preconditioned CG with
           trace-scaled (relative) damping, optionally regularized by an
           odometry chain (`ops/lba.py::ChainSpec`).

The edge list is the [K, M] observation grid itself.  Where the reference
recomputes the Jacobian blocks in every CG product (to bound memory at 10k
keyframes), `gn_cg_step` computes them once per step and keeps them (28 MB
at 256 x 1024): the values are the same.  `ba_sweep_chunked` is the sweep
for maps of 10k keyframes, streamed over keyframe chunks.  Nothing here reads
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import BAConfig, CameraModel
from aslam_tpu_torch.models.mapstate import MapState
from aslam_tpu_torch.ops.ba import huber_weight, project_residual_jac
from aslam_tpu_torch.ops.index import index_add_ordered
from aslam_tpu_torch.ops.lba import ChainSpec
from aslam_tpu_torch.ops.linalg import chol_inv, chol_solve
from aslam_tpu_torch.ops.pose_graph import _edge_jacobians, edge_residual
from aslam_tpu_torch.utils.se3 import se3_exp


class GlobalBAStats(NamedTuple):
    chi2: torch.Tensor
    n_edges: torch.Tensor


def _edge_terms(m: MapState, cam: CameraModel, cfg: BAConfig, robust: bool):
    """Residual / Jacobian tensors over the [K, M] observation grid
    -> (r, Jc, Jp, w, chi2, active, lm)."""
    lm = torch.clamp(m.kf_lm, min=0).to(torch.int64)
    r, Jc, Jp, depth_ok = project_residual_jac(
        m.kf_T_cw, m.lm_pos[lm], m.kf_xy, m.kf_ur, cam)       # [K,M,...]
    is_stereo = m.kf_ur >= 0
    row_mask = torch.stack([torch.ones_like(is_stereo),
                            torch.ones_like(is_stereo), is_stereo], -1)
    r = torch.where(row_mask, r, 0.0)
    Jc = torch.where(row_mask[..., None], Jc, 0.0)
    Jp = torch.where(row_mask[..., None], Jp, 0.0)

    info = torch.where(m.kf_z > 1e-3,
                       1.0 / torch.clamp(m.kf_z, min=1e-3) ** 2, 0.0)
    chi2 = torch.sum(r * r, -1) * info
    chi2_th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    w_huber = huber_weight(chi2, chi2_th) if robust else torch.ones_like(chi2)
    active = (m.kf_lm >= 0) & m.kf_kp_valid & m.kf_valid[:, None] \
        & m.lm_valid[lm] & depth_ok
    return r, Jc, Jp, info * w_huber * active, chi2, active, lm


def _stats(chi2, active) -> GlobalBAStats:
    return GlobalBAStats(chi2=torch.sum(torch.where(active, chi2, 0.0)),
                         n_edges=torch.sum(active.to(torch.int32)))


def map_chi2(m: MapState, cam: CameraModel, cfg: BAConfig) -> torch.Tensor:
    """Total active reprojection chi2 of the whole map (diagnostic)."""
    _, _, _, _, chi2, active, _ = _edge_terms(m, cam, cfg, robust=False)
    return _stats(chi2, active).chi2


def _oldest(m: MapState) -> torch.Tensor:
    """Slot of the oldest valid keyframe (the gauge anchor), 0-d int64."""
    return torch.argmax(torch.where(m.kf_valid, -m.kf_id, -(2**30)))


def _trace(A: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


def ba_sweep(m: MapState, cam: CameraModel, cfg: BAConfig,
             robust: bool = True, lam: float = 1e-4):
    """One alternating sweep: pose update, then point update."""
    K = m.kf_lm.shape[0]
    L = m.lm_pos.shape[0]
    z = dict(dtype=m.lm_pos.dtype, device=m.lm_pos.device)
    eye6, eye3 = torch.eye(6, **z), torch.eye(3, **z)

    # ---- pose sweep (landmarks fixed) ----
    r, Jc, _, w, _, _, _ = _edge_terms(m, cam, cfg, robust)
    H = torch.einsum("km,kmri,kmrj->kij", w, Jc, Jc)          # [K,6,6]
    b = torch.einsum("km,kmri,kmr->ki", w, Jc, r)
    H = H + lam * eye6 * torch.clamp(_trace(H)[:, None, None] / 6.0,
                                     min=1e-6) + 1e-8 * eye6
    dx = -chol_solve(H, b)
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    # gauge: hold the oldest valid KF fixed
    freeze = (torch.arange(K, device=dx.device) == _oldest(m)) | ~m.kf_valid
    dx = torch.where(freeze[:, None], 0.0, dx)
    m = m._replace(kf_T_cw=se3_exp(dx) @ m.kf_T_cw)

    # ---- point sweep (poses fixed) ----
    r, _, Jp, w, chi2, active, lm = _edge_terms(m, cam, cfg, robust)
    wJp = w[..., None, None] * Jp                             # [K,M,3,3]
    flat, act = lm.reshape(-1), active.reshape(-1)
    Hll = index_add_ordered(torch.zeros(L, 9, **z), flat, torch.einsum(
        "kmri,kmrj->kmij", wJp, Jp).reshape(-1, 9), act)
    bl = index_add_ordered(torch.zeros(L, 3, **z), flat, torch.einsum(
        "kmri,kmr->kmi", wJp, r).reshape(-1, 3), act)
    Hll = Hll.reshape(L, 3, 3)
    Hll = Hll + lam * eye3 * torch.clamp(_trace(Hll)[:, None, None] / 3.0,
                                         min=1e-6) + 1e-8 * eye3
    dxl = -chol_solve(Hll, bl)
    dxl = torch.where(m.lm_valid[:, None] & torch.isfinite(dxl), dxl, 0.0)
    return m._replace(lm_pos=m.lm_pos + dxl), _stats(chi2, active)


def global_ba(m: MapState, cam: CameraModel, cfg: BAConfig,
              iters: int = 20, robust_iters: int = 10,
              method: str = "sweep", chain: ChainSpec | None = None):
    """Full-map refinement by `method` ("sweep" or "gn_cg"), the first
    `robust_iters` iterations with the Huber kernel.  `chain` (gn_cg only)
    anchors the relative poses of consecutive keyframes."""
    if chain is not None and method != "gn_cg":
        raise ValueError("chain regularizer requires method='gn_cg'")
    if method not in ("sweep", "gn_cg"):
        raise ValueError(f"unknown global BA method {method!r}")
    stats = None
    for i in range(iters):
        robust = i < robust_iters
        if method == "gn_cg":
            m, stats = gn_cg_step(m, cam, cfg, robust=robust, chain=chain)
        else:
            m, stats = ba_sweep(m, cam, cfg, robust=robust)
    return m, stats


# ---------------------------------------------------------------- joint GN-CG

def gn_cg_step(m: MapState, cam: CameraModel, cfg: BAConfig,
               robust: bool = True, cg_iters: int = 32, lam: float = 1e-3,
               chain: ChainSpec | None = None):
    """One joint Gauss-Newton step over all poses and points, solved
    matrix-free with block-Jacobi-preconditioned CG: it solves the coupled
    normal equations (H + diag(lam_c, lam_l)) x = -b without a dense system.

    The damping is relative: lam times the mean diagonal of each block
    (floored at 1).  Normal-equation blocks reach ~1e11 where info = 1/z^2
    meets near-camera depths, where an absolute lam means nothing and the
    float32 Cholesky of the preconditioner breaks down."""
    K = m.kf_lm.shape[0]
    L = m.lm_pos.shape[0]
    z = dict(dtype=m.lm_pos.dtype, device=m.lm_pos.device)
    cam_free = (m.kf_valid
                & (torch.arange(K, device=m.kf_valid.device) != _oldest(m)))
    pt_free = m.lm_valid

    # ---- gradient b and block-diagonal preconditioner ----
    r, Jc, Jp, w, _, active, lm = _edge_terms(m, cam, cfg, robust)
    # inactive edges weigh 0: left out of every scatter-add
    flat, act = lm.reshape(-1), active.reshape(-1)
    wJc = w[..., None, None] * Jc
    wJp = w[..., None, None] * Jp
    bc = torch.einsum("kmri,kmr->ki", wJc, r)
    Dc = torch.einsum("kmri,kmrj->kij", wJc, Jc)
    bl = index_add_ordered(torch.zeros(L, 3, **z), flat, torch.einsum(
        "kmri,kmr->kmi", wJp, r).reshape(-1, 3), act)
    Dl = index_add_ordered(torch.zeros(L, 9, **z), flat, torch.einsum(
        "kmri,kmrj->kmij", wJp, Jp).reshape(-1, 9), act).reshape(L, 3, 3)

    # odometry-chain regularizer: relative-pose edges between consecutive
    # KFs anchored at the incoming chain; without it a whole-map
    # reprojection-only re-solve shears the chain to fit landmark depth noise
    if chain is not None:
        c_i, c_j = chain.c_i.to(torch.int64), chain.c_j.to(torch.int64)
        T_i, T_j = m.kf_T_cw[c_i], m.kf_T_cw[c_j]
        r_ch = edge_residual(T_i, T_j, chain.c_meas)             # [P,6]
        Ji, Jj = _edge_jacobians(T_i, T_j, chain.c_meas)
        wJi = chain.c_w[:, None, None] * Ji
        wJj = chain.c_w[:, None, None] * Jj
        index_add_ordered(bc, c_i, torch.einsum("eri,er->ei", wJi, r_ch))
        index_add_ordered(bc, c_j, torch.einsum("eri,er->ei", wJj, r_ch))
        index_add_ordered(Dc, c_i, torch.einsum("eri,erj->eij", wJi, Ji))
        index_add_ordered(Dc, c_j, torch.einsum("eri,erj->eij", wJj, Jj))

    bc = torch.where(cam_free[:, None], bc, 0.0)
    bl = torch.where(pt_free[:, None], bl, 0.0)
    lam_c = lam * torch.clamp(_trace(Dc) / 6.0, min=1.0) + 1e-8    # [K]
    lam_l = lam * torch.clamp(_trace(Dl) / 3.0, min=1.0) + 1e-8    # [L]
    Dc_inv = chol_inv(Dc + lam_c[:, None, None] * torch.eye(6, **z))
    Dl_inv = chol_inv(Dl + lam_l[:, None, None] * torch.eye(3, **z))

    def Hv(vc, vl):
        q = (torch.einsum("kmri,ki->kmr", Jc, vc)
             + torch.einsum("kmri,kmi->kmr", Jp, vl[lm]))
        wq = w[..., None] * q
        oc = torch.einsum("kmri,kmr->ki", Jc, wq)
        ol = index_add_ordered(torch.zeros(L, 3, **z), flat, torch.einsum(
            "kmri,kmr->kmi", Jp, wq).reshape(-1, 3), act)
        if chain is not None:
            qc = (torch.einsum("eij,ej->ei", Ji, vc[c_i])
                  + torch.einsum("eij,ej->ei", Jj, vc[c_j]))
            index_add_ordered(oc, c_i, torch.einsum("eri,er->ei", wJi, qc))
            index_add_ordered(oc, c_j, torch.einsum("eri,er->ei", wJj, qc))
        oc = torch.where(cam_free[:, None], oc + lam_c[:, None] * vc, 0.0)
        ol = torch.where(pt_free[:, None], ol + lam_l[:, None] * vl, 0.0)
        return oc, ol

    def precond(vc, vl):
        pc = torch.where(cam_free[:, None],
                         torch.einsum("kij,kj->ki", Dc_inv, vc), 0.0)
        pl = torch.where(pt_free[:, None],
                         torch.einsum("kij,kj->ki", Dl_inv, vl), 0.0)
        return pc, pl

    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    # PCG for H x = -b
    x = (torch.zeros(K, 6, **z), torch.zeros(L, 3, **z))
    rres = (-bc, -bl)
    p = precond(*rres)
    rz = dot(rres, p)
    for _ in range(cg_iters):
        Hp = Hv(*p)
        denom = dot(p, Hp)
        alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, 0.0)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        rres = (rres[0] - alpha * Hp[0], rres[1] - alpha * Hp[1])
        zc, zl = precond(*rres)
        rz_new = dot(rres, (zc, zl))
        beta = torch.where(torch.abs(rz) > 1e-12, rz_new / rz, 0.0)
        p = (zc + beta * p[0], zl + beta * p[1])
        rz = rz_new
    dxc = torch.where(torch.isfinite(x[0]) & cam_free[:, None], x[0], 0.0)
    dxl = torch.where(torch.isfinite(x[1]) & pt_free[:, None], x[1], 0.0)

    m = m._replace(kf_T_cw=se3_exp(dxc) @ m.kf_T_cw, lm_pos=m.lm_pos + dxl)
    _, _, _, _, chi2, active, _ = _edge_terms(m, cam, cfg, robust=False)
    return m, _stats(chi2, active)


# ------------------------------------------------------------------ chunked

_KF_FIELDS = ("kf_T_cw", "kf_valid", "kf_id", "kf_xy", "kf_ur", "kf_z",
              "kf_desc", "kf_octave", "kf_kp_valid", "kf_lm")


def ba_sweep_chunked(m: MapState, cam: CameraModel, cfg: BAConfig,
                     robust: bool = True, lam: float = 1e-4,
                     kf_chunk: int = 256):
    """`ba_sweep` with bounded memory, for maps of 10k+ keyframes: the pose
    sweep and the landmark normal equations are streamed over keyframe rows
    in chunks of `kf_chunk`, so the extra memory is O(kf_chunk * M * 18)
    instead of the [K, M, 3, 6] Jacobian blocks.  The same math as
    `ba_sweep`."""
    K = m.kf_lm.shape[0]
    L = m.lm_pos.shape[0]
    if K % kf_chunk:
        raise ValueError(f"K={K} must divide by kf_chunk={kf_chunk}")
    z = dict(dtype=m.lm_pos.dtype, device=m.lm_pos.device)
    eye6, eye3 = torch.eye(6, **z), torch.eye(3, **z)
    oldest = _oldest(m)

    def chunk_view(mm, c):
        sl = slice(c * kf_chunk, (c + 1) * kf_chunk)
        return mm._replace(**{f: getattr(mm, f)[sl] for f in _KF_FIELDS})

    # ---- pose sweep, chunked ----
    new_T = []
    for c in range(K // kf_chunk):
        mc = chunk_view(m, c)
        r, Jc, _, w, _, _, _ = _edge_terms(mc, cam, cfg, robust)
        H = torch.einsum("km,kmri,kmrj->kij", w, Jc, Jc)
        b = torch.einsum("km,kmri,kmr->ki", w, Jc, r)
        H = H + lam * eye6 * torch.clamp(_trace(H)[:, None, None] / 6.0,
                                         min=1e-6) + 1e-8 * eye6
        dx = -chol_solve(H, b)
        rows = c * kf_chunk + torch.arange(kf_chunk, device=dx.device)
        freeze = (rows == oldest) | ~mc.kf_valid
        dx = torch.where(torch.isfinite(dx) & ~freeze[:, None], dx, 0.0)
        new_T.append(se3_exp(dx) @ mc.kf_T_cw)
    m = m._replace(kf_T_cw=torch.cat(new_T))

    # ---- point sweep, the normal equations accumulated over chunks ----
    Hll = torch.zeros(L, 9, **z)
    bl = torch.zeros(L, 3, **z)
    chi2_sum = torch.zeros((), **z)
    n_act = torch.zeros((), dtype=torch.int32, device=m.lm_pos.device)
    for c in range(K // kf_chunk):
        r, _, Jp, w, chi2, active, lm = _edge_terms(chunk_view(m, c), cam,
                                                    cfg, robust)
        wJp = w[..., None, None] * Jp
        flat, act = lm.reshape(-1), active.reshape(-1)
        index_add_ordered(Hll, flat, torch.einsum(
            "kmri,kmrj->kmij", wJp, Jp).reshape(-1, 9), act)
        index_add_ordered(bl, flat, torch.einsum(
            "kmri,kmr->kmi", wJp, r).reshape(-1, 3), act)
        stats = _stats(chi2, active)
        chi2_sum = chi2_sum + stats.chi2
        n_act = n_act + stats.n_edges
    Hll = Hll.reshape(L, 3, 3)
    Hll = Hll + lam * eye3 * torch.clamp(_trace(Hll)[:, None, None] / 3.0,
                                         min=1e-6) + 1e-8 * eye3
    dxl = -chol_solve(Hll, bl)
    dxl = torch.where(m.lm_valid[:, None] & torch.isfinite(dxl), dxl, 0.0)
    return (m._replace(lm_pos=m.lm_pos + dxl),
            GlobalBAStats(chi2=chi2_sum, n_edges=n_act))

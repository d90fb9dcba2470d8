"""Local bundle adjustment: Levenberg-Marquardt with Schur-complement
landmark elimination over a fixed-capacity window.

Port of `aslam_tpu/ops/lba.py`.  Per-edge 3x6 / 3x3 Jacobian blocks are
computed batched and reduced into per-camera 6x6, per-landmark 3x3 and
camera-landmark 6x3 blocks by an ordered scatter-add (`ops/index.py::
index_add_ordered`: the same sum on every run, where `index_add_` on the card
adds with atomics; the reference's grouped path used one-hot matmuls, a
stand-in for a scatter-add on the TPU); landmarks
are eliminated through S = Hcc - W Hll^-1 W^T and the reduced camera system
is solved dense (`torch.linalg.solve_ex`, which does not read the device).
Fixed cameras keep identity rows in S, so their update is exactly zero.
The schedule is the reference's: robust iterations, outlier pruning,
non-robust iterations, each a monotone LM step on carried normal equations.
`fori_loop` is a Python loop here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import BAConfig, CameraModel
from aslam_tpu_torch.ops.ba import huber_weight, project_residual_jac
from aslam_tpu_torch.ops.index import index_add_ordered
from aslam_tpu_torch.ops.linalg import chol_inv
from aslam_tpu_torch.ops.pose_graph import _edge_jacobians, edge_residual
from aslam_tpu_torch.utils.se3 import T_inv, se3_exp


class BAProblem(NamedTuple):
    """Fixed-capacity BA window."""

    cam_T: torch.Tensor       # [C,4,4] world-to-camera poses
    cam_fixed: torch.Tensor   # [C] bool: pose held constant
    cam_valid: torch.Tensor   # [C] bool: slot in use
    points: torch.Tensor      # [L,3] world landmark positions
    point_valid: torch.Tensor # [L] bool
    e_cam: torch.Tensor       # [E] camera slot per edge
    e_lm: torch.Tensor        # [E] landmark slot per edge
    e_uv: torch.Tensor        # [E,2] measured undistorted pixel
    e_ur: torch.Tensor        # [E] measured right-u (<0 = mono edge)
    e_z: torch.Tensor         # [E] measured keypoint depth (info = 1/z^2)
    e_valid: torch.Tensor     # [E] bool


class BAStats(NamedTuple):
    chi2: torch.Tensor        # scalar: total squared error of active edges
    n_edges: torch.Tensor     # scalar int32 active edges


class ChainSpec(NamedTuple):
    """Odometry-chain regularizer: relative-pose edges between temporally
    consecutive window cameras, anchored at their relative transforms when
    the window was built."""

    c_i: torch.Tensor     # [P] window-cam index
    c_j: torch.Tensor     # [P]
    c_meas: torch.Tensor  # [P,4,4] anchored T_i T_j^-1
    c_w: torch.Tensor     # [P] float32 information (0 = inactive)


def map_chain(kf_T_cw: torch.Tensor, kf_valid: torch.Tensor,
              kf_id: torch.Tensor, weight: float) -> ChainSpec:
    """ChainSpec over temporally consecutive valid KFs of a whole map,
    anchored at the given poses."""
    ids = torch.where(kf_valid, kf_id, 2**30)
    order = torch.argsort(ids, stable=True)
    c_i, c_j = order[:-1], order[1:]
    both = (ids[c_i] < 2**30) & (ids[c_j] < 2**30)
    meas = kf_T_cw[c_i] @ T_inv(kf_T_cw[c_j])
    return ChainSpec(c_i=c_i, c_j=c_j, c_meas=meas,
                     c_w=torch.where(both, weight, 0.0))


def chain_terms(cam_T: torch.Tensor, chain: ChainSpec):
    """Residuals and Jacobians of the chain regularizer -> (H [C,C,6,6],
    b [C,6], chi2 scalar)."""
    C = cam_T.shape[0]
    c_i, c_j = chain.c_i.to(torch.int64), chain.c_j.to(torch.int64)
    T_i, T_j = cam_T[c_i], cam_T[c_j]
    r = edge_residual(T_i, T_j, chain.c_meas)                   # [P,6]
    Ji, Jj = _edge_jacobians(T_i, T_j, chain.c_meas)            # [P,6,6]
    w = chain.c_w
    wJi = w[:, None, None] * Ji
    wJj = w[:, None, None] * Jj
    H = torch.zeros(C * C, 6, 6, dtype=cam_T.dtype, device=cam_T.device)
    for a, wJ, b, J in ((c_i, wJi, c_i, Ji), (c_j, wJj, c_j, Jj),
                        (c_i, wJi, c_j, Jj), (c_j, wJj, c_i, Ji)):
        index_add_ordered(H, a * C + b, torch.einsum("eri,erj->eij", wJ, J))
    bvec = torch.zeros(C, 6, dtype=cam_T.dtype, device=cam_T.device)
    index_add_ordered(bvec, c_i, torch.einsum("eri,er->ei", wJi, r))
    index_add_ordered(bvec, c_j, torch.einsum("eri,er->ei", wJj, r))
    chi2 = torch.sum(w * torch.sum(r * r, dim=-1))
    return H.reshape(C, C, 6, 6), bvec, chi2


def _edge_weights(r, Jc, Jp, is_stereo, e_z, cfg: BAConfig, robust: bool):
    """Mono rows masked, information and Huber weights -> (r, Jc, Jp, info,
    w_huber, chi2)."""
    row_mask = torch.stack([torch.ones_like(is_stereo),
                            torch.ones_like(is_stereo), is_stereo], -1)
    r = torch.where(row_mask, r, 0.0)
    Jc = torch.where(row_mask[..., None], Jc, 0.0)
    Jp = torch.where(row_mask[..., None], Jp, 0.0)
    if cfg.info_model == "constant":
        info = torch.ones_like(e_z)
    else:  # "inv_z2": z <= 0 edges get weight 0
        info = torch.where(e_z > 1e-3, 1.0 / torch.clamp(e_z, min=1e-3) ** 2,
                           0.0)
    chi2 = torch.sum(r * r, -1) * info
    chi2_th = torch.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    w_huber = huber_weight(chi2, chi2_th) if robust else torch.ones_like(chi2)
    return r, Jc, Jp, info, w_huber, chi2


def edge_terms(prob: BAProblem, cam: CameraModel, cfg: BAConfig, robust: bool):
    """Per-edge residuals, Jacobians, weights, chi2 and activity [E,...]."""
    e_cam = prob.e_cam.to(torch.int64)
    e_lm = prob.e_lm.to(torch.int64)
    r, Jc, Jp, depth_ok = project_residual_jac(
        prob.cam_T[e_cam], prob.points[e_lm][:, None, :],
        prob.e_uv[:, None, :], prob.e_ur[:, None], cam)
    r, Jc, Jp, depth_ok = r[:, 0], Jc[:, 0], Jp[:, 0], depth_ok[:, 0]
    r, Jc, Jp, info, w_huber, chi2 = _edge_weights(
        r, Jc, Jp, prob.e_ur >= 0, prob.e_z, cfg, robust)
    active = prob.e_valid & depth_ok & prob.cam_valid[e_cam] \
        & prob.point_valid[e_lm]
    return r, Jc, Jp, info * w_huber * active, chi2, active


def edge_terms_grouped(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                       robust: bool, group: int):
    """`edge_terms` for camera-grouped problems, where edge e belongs to
    camera e // group (the layout of localmapping.build_problem): the pose
    broadcasts over the camera's edges.  Returns [C,M,...] tensors."""
    C, M = prob.cam_T.shape[0], group
    lm = prob.e_lm.reshape(C, M).to(torch.int64)
    ur = prob.e_ur.reshape(C, M)
    r, Jc, Jp, depth_ok = project_residual_jac(
        prob.cam_T, prob.points[lm], prob.e_uv.reshape(C, M, 2), ur, cam)
    r, Jc, Jp, info, w_huber, chi2 = _edge_weights(
        r, Jc, Jp, ur >= 0, prob.e_z.reshape(C, M), cfg, robust)
    active = prob.e_valid.reshape(C, M) & depth_ok \
        & prob.cam_valid[:, None] & prob.point_valid[lm]
    return r, Jc, Jp, info * w_huber * active, chi2, active


def assemble_grouped(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                     robust: bool, group: int):
    """Normal equations of a camera-grouped problem: Hcc/bc are per-camera
    sums, and W, Hll, bl are ordered scatter-adds of the edge blocks
    onto their landmarks.  -> (Hcc [C,6,6], bc [C,6], Hll [Lw,3,3],
    bl [Lw,3], W [C,Lw,6,3], chi2_total)."""
    C, M = prob.cam_T.shape[0], group
    Lw = prob.points.shape[0]
    r, Jc, Jp, w, chi2, active = edge_terms_grouped(prob, cam, cfg, robust,
                                                    group)
    wJc = w[..., None, None] * Jc                       # [C,M,3,6]
    wJp = w[..., None, None] * Jp                       # [C,M,3,3]
    Hcc = torch.einsum("cmri,cmrj->cij", wJc, Jc)
    bc = torch.einsum("cmri,cmr->ci", wJc, r)
    lm = prob.e_lm.reshape(C, M).to(torch.int64)
    cam_lm = (torch.arange(C, device=lm.device)[:, None] * Lw + lm).reshape(-1)
    z = dict(dtype=w.dtype, device=w.device)
    act = active.reshape(-1)        # inactive edges weigh 0: left out
    W = index_add_ordered(
        torch.zeros(C * Lw, 18, **z), cam_lm,
        torch.einsum("cmri,cmrj->cmij", wJc, Jp).reshape(-1, 18), act)
    Hll = index_add_ordered(
        torch.zeros(Lw, 9, **z), lm.reshape(-1),
        torch.einsum("cmri,cmrj->cmij", wJp, Jp).reshape(-1, 9), act)
    bl = index_add_ordered(
        torch.zeros(Lw, 3, **z), lm.reshape(-1),
        torch.einsum("cmri,cmr->cmi", wJp, r).reshape(-1, 3), act)
    chi2_total = torch.sum(torch.where(active, chi2, 0.0))
    return Hcc, bc, Hll.reshape(Lw, 3, 3), bl, W.reshape(C, Lw, 6, 3), \
        chi2_total


def assemble(prob: BAProblem, cam: CameraModel, cfg: BAConfig, robust: bool):
    """Normal equations from the edge list by scatter-adds (any layout).
    -> (Hcc [C,6,6], bc [C,6], Hll [L,3,3], bl [L,3], W [C,L,6,3],
    chi2_total)."""
    C = prob.cam_T.shape[0]
    L = prob.points.shape[0]
    r, Jc, Jp, w, chi2, active = edge_terms(prob, cam, cfg, robust)
    e_cam = prob.e_cam.to(torch.int64)
    e_lm = prob.e_lm.to(torch.int64)
    wJc = w[:, None, None] * Jc
    wJp = w[:, None, None] * Jp
    z = dict(dtype=w.dtype, device=w.device)
    Hcc = index_add_ordered(torch.zeros(C, 6, 6, **z), e_cam,
                            torch.einsum("eri,erj->eij", wJc, Jc), active)
    bc = index_add_ordered(torch.zeros(C, 6, **z), e_cam,
                           torch.einsum("eri,er->ei", wJc, r), active)
    Hll = index_add_ordered(torch.zeros(L, 3, 3, **z), e_lm,
                            torch.einsum("eri,erj->eij", wJp, Jp), active)
    bl = index_add_ordered(torch.zeros(L, 3, **z), e_lm,
                           torch.einsum("eri,er->ei", wJp, r), active)
    W = index_add_ordered(torch.zeros(C * L, 6, 3, **z), e_cam * L + e_lm,
                          torch.einsum("eri,erj->eij", wJc, Jp), active)
    chi2_total = torch.sum(torch.where(active, chi2, 0.0))
    return Hcc, bc, Hll, bl, W.reshape(C, L, 6, 3), chi2_total


def schur_solve(Hcc, bc, Hll, bl, W, cam_fixed: torch.Tensor,
                point_valid: torch.Tensor, lam: torch.Tensor,
                H_chain=None, b_chain=None):
    """Eliminate landmarks, solve cameras, back-substitute landmarks.
    -> (dxc [C,6], dxl [L,3]).  H_chain/b_chain are camera-camera blocks of
    the chain regularizer, added to the reduced system."""
    C = W.shape[0]
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    tr = Hll[:, 0, 0] + Hll[:, 1, 1] + Hll[:, 2, 2]
    Hll_d = Hll + lam * eye3 * torch.clamp(tr / 3.0, min=1e-6)[:, None, None] \
        + 1e-8 * eye3
    Hll_inv = chol_inv(Hll_d)

    Y = torch.einsum("clij,ljk->clik", W, Hll_inv)             # [C,L,6,3]
    S = -torch.einsum("clik,dljk->cidj", Y, W)                 # [C,6,C,6]
    diag_blk = torch.eye(C, dtype=torch.bool, device=S.device)[:, None, :, None]
    S = S + torch.where(diag_blk, Hcc[:, :, None, :], 0.0)     # S[c,:,c,:] += Hcc[c]
    if H_chain is not None:
        S = S + H_chain.permute(0, 2, 1, 3)
    S = S.reshape(C * 6, C * 6)
    rhs = bc - torch.einsum("clij,lj->ci", Y, bl)
    if b_chain is not None:
        rhs = rhs + b_chain
    rhs = rhs.reshape(C * 6)

    # damping, then fixed-camera rows and columns -> identity
    diag_scale = torch.clamp(torch.abs(torch.diagonal(S)), min=1e-6)
    S = S + torch.diag(lam * diag_scale)
    fixed6 = cam_fixed[:, None].expand(C, 6).reshape(-1)
    S = torch.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
    S = S + torch.diag(fixed6.to(S.dtype))
    rhs = torch.where(fixed6, 0.0, rhs)

    dxc = -torch.linalg.solve_ex(S, rhs)[0].reshape(C, 6)
    dxc = torch.where(torch.isfinite(dxc), dxc, 0.0)
    Wt_dxc = torch.einsum("clij,ci->lj", W, dxc)
    dxl = -torch.einsum("lij,lj->li", Hll_inv, bl + Wt_dxc)
    dxl = torch.where(point_valid[:, None] & torch.isfinite(dxl), dxl, 0.0)
    return dxc, dxl


def apply_update(prob: BAProblem, dxc: torch.Tensor,
                 dxl: torch.Tensor) -> BAProblem:
    new_T = se3_exp(dxc) @ prob.cam_T
    new_T = torch.where(prob.cam_fixed[:, None, None], prob.cam_T, new_T)
    return prob._replace(cam_T=new_T, points=prob.points + dxl)


def _select(ok: torch.Tensor, a, b):
    """Elementwise torch.where(ok, a, b) over matching tuples (None kept)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        vals = [_select(ok, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return torch.where(ok, a, b)


def ba_iterate(prob: BAProblem, cam: CameraModel, cfg: BAConfig, iters: int,
               robust: bool, lam: float = 1e-4,
               chain: ChainSpec | None = None,
               group: int | None = None) -> BAProblem:
    """Monotone Levenberg-Marquardt: a step that raises chi2 is rejected and
    the damping raised; the normal equations of the accepted iterate are
    carried, so each iteration assembles once."""

    def full_assemble(p):
        if group is not None:
            Hcc, bc, Hll, bl, W, chi2 = assemble_grouped(p, cam, cfg, robust,
                                                         group)
        else:
            Hcc, bc, Hll, bl, W, chi2 = assemble(p, cam, cfg, robust)
        if chain is None:
            return (Hcc, bc, Hll, bl, W, None, None), chi2
        H_ch, b_ch, chi2_ch = chain_terms(p.cam_T, chain)
        return (Hcc, bc, Hll, bl, W, H_ch, b_ch), chi2 + chi2_ch

    p = prob
    H_p, chi2_p = full_assemble(p)
    lam = torch.full((), lam, dtype=torch.float32, device=p.cam_T.device)
    for _ in range(iters):
        Hcc, bc, Hll, bl, W, H_ch, b_ch = H_p
        dxc, dxl = schur_solve(Hcc, bc, Hll, bl, W, p.cam_fixed,
                               p.point_valid, lam, H_chain=H_ch, b_chain=b_ch)
        p_new = apply_update(p, dxc, dxl)
        H_new, chi2_new = full_assemble(p_new)
        ok = chi2_new < chi2_p
        p = _select(ok, p_new, p)
        H_p = _select(ok, H_new, H_p)
        chi2_p = torch.where(ok, chi2_new, chi2_p)
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 8.0, max=1e2))
    return p


def prune_outlier_edges(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                        group: int | None = None) -> BAProblem:
    """Drop edges with chi2 over threshold or nonpositive projected depth."""
    if group is not None:
        _, _, _, _, chi2, active = edge_terms_grouped(prob, cam, cfg, False,
                                                      group)
        chi2, active = chi2.reshape(-1), active.reshape(-1)
    else:
        _, _, _, _, chi2, active = edge_terms(prob, cam, cfg, False)
    chi2_th = torch.where(prob.e_ur >= 0, cfg.chi2_stereo, cfg.chi2_mono)
    return prob._replace(e_valid=active & (chi2 <= chi2_th))


def local_ba(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
             chain: ChainSpec | None = None, group: int | None = None):
    """Full local-BA schedule: `local_iters_1` robust iterations, outlier
    pruning, `local_iters_2` non-robust iterations -> (problem, BAStats).
    `group` (edges per camera) selects the camera-grouped assembly.  Each
    call adds one to `local_ba.runs`."""
    prob = ba_iterate(prob, cam, cfg, cfg.local_iters_1, robust=True,
                      chain=chain, group=group)
    prob = prune_outlier_edges(prob, cam, cfg, group=group)
    prob = ba_iterate(prob, cam, cfg, cfg.local_iters_2, robust=False,
                      chain=chain, group=group)
    if group is not None:
        _, _, _, _, chi2, active = edge_terms_grouped(prob, cam, cfg, False,
                                                      group)
    else:
        _, _, _, _, chi2, active = edge_terms(prob, cam, cfg, False)
    local_ba.runs += 1
    return prob, BAStats(chi2=torch.sum(torch.where(active, chi2, 0.0)),
                         n_edges=torch.sum(active.to(torch.int32)))


local_ba.runs = 0

"""Distributed bundle adjustment: the windowed Schur-complement local BA
reduced across the ranks of a mesh.

Port of `aslam_tpu/parallel/sharded_ba.py`.  Each rank runs the body of the
reference's `shard_map` on its edge shard, with cameras and points
replicated.  Decomposition:

  * edges (residual blocks) shard over all ranks: each assembles the
    normal-equation contributions of its shard (`ops/lba.py::assemble`,
    ordered scatter-adds);
  * per-camera blocks (Hcc, bc) and chi2 are small: summed over the world,
    and the reduced camera system is solved on every rank (dense,
    `torch.linalg.solve_ex`, which does not read the device);
  * per-landmark blocks (Hll, bl) and the camera-landmark coupling W are
    summed over 'dp' and reduce-scattered over 'lm', so each lm shard owns
    L / n_lm landmarks: it inverts its 3x3 blocks, sums its Schur
    contribution over 'lm', and back-substitutes its landmark updates,
    all-gathered over 'lm' into the replicated point array.

As in the reference, every LM step is taken at a fixed lam = 1e-4 (no
monotone acceptance, unlike `ops/lba.py::ba_iterate`).
"""

from __future__ import annotations

import torch

from aslam_tpu_torch.config import BAConfig, CameraModel
from aslam_tpu_torch.ops.lba import (BAProblem, apply_update, assemble,
                                     edge_terms, prune_outlier_edges)
from aslam_tpu_torch.ops.linalg import chol_inv
from aslam_tpu_torch.parallel.launch import shard_problem
from aslam_tpu_torch.parallel.mesh import Mesh

EDGE_AXES = ("dp", "lm")


def _pad(x: torch.Tensor, n: int, value) -> torch.Tensor:
    return torch.cat([x, x.new_full((n,) + x.shape[1:], value)])


def pad_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """Pad the edge count to a multiple of the mesh size and the landmark
    count to a multiple of the 'lm' axis (the shards must be even).  Padded
    edges are invalid mono edges (e_ur -1), padded points invalid."""
    E = prob.e_cam.shape[0]
    L = prob.points.shape[0]
    pe = (-E) % mesh.size
    pl = (-L) % mesh.shape["lm"]
    if pe:
        prob = prob._replace(
            e_cam=_pad(prob.e_cam, pe, 0), e_lm=_pad(prob.e_lm, pe, 0),
            e_uv=_pad(prob.e_uv, pe, 0.0), e_ur=_pad(prob.e_ur, pe, -1.0),
            e_z=_pad(prob.e_z, pe, 0.0), e_valid=_pad(prob.e_valid, pe, False))
    if pl:
        prob = prob._replace(points=_pad(prob.points, pl, 0.0),
                             point_valid=_pad(prob.point_valid, pl, False))
    return prob


def _one_iteration(local_prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                   robust: bool, lam: float, mesh: Mesh):
    """One distributed LM iteration on this rank's edge shard (cameras and
    points replicated) -> (dxc [C,6], dxl [L,3], chi2), all replicated."""
    C = local_prob.cam_T.shape[0]
    Hcc, bc, Hll, bl, W, chi2 = assemble(local_prob, cam, cfg, robust)

    # camera blocks: full reduction (small)
    Hcc = mesh.psum(Hcc, EDGE_AXES)
    bc = mesh.psum(bc, EDGE_AXES)
    chi2 = mesh.psum(chi2, EDGE_AXES)

    # landmark blocks: reduce over 'dp', scatter blocks over 'lm'
    Hll_s = mesh.psum_scatter(mesh.psum(Hll, "dp"), "lm", 0)   # [L/nl,3,3]
    bl_s = mesh.psum_scatter(mesh.psum(bl, "dp"), "lm", 0)     # [L/nl,3]
    W_s = mesh.psum_scatter(mesh.psum(W, "dp"), "lm", 1)       # [C,L/nl,6,3]

    Ls = bl_s.shape[0]
    pv_s = local_prob.point_valid.narrow(0, mesh.axis_index("lm") * Ls, Ls)

    eye3 = torch.eye(3, dtype=Hll_s.dtype, device=Hll_s.device)
    tr = Hll_s[:, 0, 0] + Hll_s[:, 1, 1] + Hll_s[:, 2, 2]
    Hll_d = Hll_s + lam * eye3 * torch.clamp(
        tr / 3.0, min=1e-6)[:, None, None] + 1e-8 * eye3
    Hll_inv_s = chol_inv(Hll_d)

    # Schur contribution of this landmark shard
    Y_s = torch.einsum("clij,ljk->clik", W_s, Hll_inv_s)
    S_contrib = mesh.psum(torch.einsum("clik,dljk->cidj", Y_s, W_s), "lm")
    rhs_contrib = mesh.psum(torch.einsum("clik,lk->ci", Y_s, bl_s), "lm")

    diag_blk = torch.eye(C, dtype=torch.bool,
                         device=Hcc.device)[:, None, :, None]
    S = torch.where(diag_blk, Hcc[:, :, None, :], 0.0) - S_contrib
    S = S.reshape(C * 6, C * 6)
    rhs = (bc - rhs_contrib).reshape(C * 6)

    diag_scale = torch.clamp(torch.abs(torch.diagonal(S)), min=1e-6)
    S = S + torch.diag(lam * diag_scale)
    fixed6 = local_prob.cam_fixed[:, None].expand(C, 6).reshape(-1)
    S = torch.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
    S = S + torch.diag(fixed6.to(S.dtype))
    rhs = torch.where(fixed6, 0.0, rhs)

    dxc = -torch.linalg.solve_ex(S, rhs)[0].reshape(C, 6)      # replicated
    dxc = torch.where(torch.isfinite(dxc), dxc, 0.0)

    # landmark back-substitution on this shard, then regather
    Wt_dxc = torch.einsum("clij,ci->lj", W_s, dxc)
    dxl_s = -torch.einsum("lij,lj->li", Hll_inv_s, bl_s + Wt_dxc)
    dxl_s = torch.where(pv_s[:, None] & torch.isfinite(dxl_s), dxl_s, 0.0)
    dxl = mesh.all_gather(dxl_s, "lm", 0)                      # [L,3]
    return dxc, dxl, chi2


def _sharded_schedule(local_prob: BAProblem, cam: CameraModel,
                      cfg: BAConfig, mesh: Mesh):
    """The full local-BA schedule on this rank's shard: `local_iters_1`
    robust iterations, outlier pruning (elementwise on the shard),
    `local_iters_2` non-robust ones -> (shard problem, chi2, n_edges), the
    last two summed over the world."""

    def iterate(p, n_iters, robust):
        for _ in range(n_iters):
            dxc, dxl, _ = _one_iteration(p, cam, cfg, robust, 1e-4, mesh)
            p = apply_update(p, dxc, dxl)
        return p

    p = iterate(local_prob, cfg.local_iters_1, True)
    p = prune_outlier_edges(p, cam, cfg)
    p = iterate(p, cfg.local_iters_2, False)
    _, _, _, _, chi2_e, active = edge_terms(p, cam, cfg, robust=False)
    chi2 = mesh.psum(torch.sum(torch.where(active, chi2_e, 0.0)), EDGE_AXES)
    n_edges = mesh.psum(torch.sum(active.to(torch.int32)), EDGE_AXES)
    return p, chi2, n_edges


def sharded_local_ba(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                     mesh: Mesh):
    """Distributed local-BA schedule.  Call on every rank of the mesh with
    the same whole problem, already padded to the mesh (`pad_problem`);
    each rank solves on its edge shard (`launch.shard_problem`).  Returns
    (problem, chi2, n_edges) on the mesh's device, all replicated: the
    refined `cam_T` and `points`, and `e_valid` all-gathered back to the
    full [E] edge mask after pruning."""
    prob = BAProblem(*(x.to(mesh.device) for x in prob))
    p, chi2, n_edges = _sharded_schedule(shard_problem(prob, mesh), cam, cfg,
                                         mesh)
    e_valid = mesh.all_gather(p.e_valid.to(torch.uint8), EDGE_AXES).bool()
    return prob._replace(cam_T=p.cam_T, points=p.points,
                         e_valid=e_valid), chi2, n_edges

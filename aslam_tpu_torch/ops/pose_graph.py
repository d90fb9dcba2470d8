"""Pose-graph optimization over SE(3), the backbone of loop correction.

Port of `aslam_tpu/ops/pose_graph.py`.  Variables are world-to-camera poses
T_i; constraints are relative measurements M_ij ~= T_i T_j^-1 with scalar
weights.  The residual is r_e = log(M_e^-1 T_i T_j^-1) with analytic
first-order Jacobians (`_edge_jacobians`, also used by the local BA's
odometry-chain regularizer, `ops/lba.py::chain_terms`).  `optimize`
assembles the damped normal equations with an ordered scatter-add
(`ops/index.py::index_add_ordered`; duplicate indices accumulate) and solves them dense with `torch.linalg.solve_ex`, which does
not read the device; `optimize_cg` is the matrix-free Gauss-Newton with a
block-Jacobi-preconditioned CG that loop closing takes above 256 keyframes.
Every function broadcasts over leading batch dimensions, where the
reference vmaps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.ops.index import index_add_ordered
from aslam_tpu_torch.ops.linalg import chol_inv
from aslam_tpu_torch.utils.se3 import T_inv, hat, se3_exp, se3_log


class PoseGraph(NamedTuple):
    T: torch.Tensor           # [K,4,4] poses (T_cw)
    node_valid: torch.Tensor  # [K] bool
    node_fixed: torch.Tensor  # [K] bool (gauge anchors)
    e_i: torch.Tensor         # [E] int32
    e_j: torch.Tensor         # [E] int32
    e_meas: torch.Tensor      # [E,4,4] measured T_i T_j^-1
    e_w: torch.Tensor         # [E] float32 weight (0 = inactive)


def edge_residual(T_i: torch.Tensor, T_j: torch.Tensor,
                  M: torch.Tensor) -> torch.Tensor:
    """r = log(M^-1 T_i T_j^-1) [...,6]."""
    return se3_log(T_inv(M) @ T_i @ T_inv(T_j))


def _ad_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) adjoint for twist ordering [rho, phi]: [[phi^, rho^],[0, phi^]]."""
    ph = hat(xi[..., 3:])
    rh = hat(xi[..., :3])
    top = torch.cat([ph, rh], dim=-1)
    bot = torch.cat([torch.zeros_like(ph), ph], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _Ad(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for twist ordering [rho, phi]: [[R, t^ R],[0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _edge_jacobians(T_i: torch.Tensor, T_j: torch.Tensor, M: torch.Tensor):
    """[...,6,6] Jacobians of the residual w.r.t. left-perturbations of i
    and j, first order: Ji = (I - ad(r)/2) Ad(M^-1), Jj = -(I + ad(r)/2)."""
    r = edge_residual(T_i, T_j, M)
    eye = torch.eye(6, dtype=r.dtype, device=r.device)
    ad_r = _ad_se3(r)
    Ji = (eye - 0.5 * ad_r) @ _Ad(T_inv(M))
    Jj = -(eye + 0.5 * ad_r)
    return Ji, Jj


def _edge_weights(pg: PoseGraph) -> torch.Tensor:
    e_i, e_j = pg.e_i.to(torch.int64), pg.e_j.to(torch.int64)
    return pg.e_w * pg.node_valid[e_i] * pg.node_valid[e_j]


def optimize(pg: PoseGraph, iters: int = 20, lam: float = 1e-6) -> PoseGraph:
    """Gauss-Newton on the dense [6K,6K] system; fixed and invalid nodes
    keep identity rows, so their update is exactly zero."""
    K = pg.T.shape[0]
    e_i, e_j = pg.e_i.to(torch.int64), pg.e_j.to(torch.int64)
    w = _edge_weights(pg)
    live = w > 0                    # padded and invalid edges: left out
    free = pg.node_valid & ~pg.node_fixed
    free6 = free[:, None].expand(K, 6).reshape(-1)
    both = free6[:, None] & free6[None, :]
    z = dict(dtype=pg.T.dtype, device=pg.T.device)

    T = pg.T
    for _ in range(iters):
        T_i, T_j = T[e_i], T[e_j]
        r = edge_residual(T_i, T_j, pg.e_meas)                   # [E,6]
        Ji, Jj = _edge_jacobians(T_i, T_j, pg.e_meas)            # [E,6,6]
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj

        H = torch.zeros(K * K, 6, 6, **z)
        for a, wJ, b, J in ((e_i, wJi, e_i, Ji), (e_j, wJj, e_j, Jj),
                            (e_i, wJi, e_j, Jj), (e_j, wJj, e_i, Ji)):
            index_add_ordered(H, a * K + b,
                              torch.einsum("eri,erj->eij", wJ, J), live)
        b = torch.zeros(K, 6, **z)
        index_add_ordered(b, e_i, torch.einsum("eri,er->ei", wJi, r), live)
        index_add_ordered(b, e_j, torch.einsum("eri,er->ei", wJj, r), live)

        Hm = H.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        Hm = torch.where(both, Hm, 0.0)
        Hm = Hm + torch.diag(torch.where(free6, lam, 1.0))
        Hm = Hm + torch.diag(torch.where(
            free6, 1e-8 + lam * torch.abs(torch.diagonal(Hm)), 0.0))
        rhs = torch.where(free6, b.reshape(K * 6), 0.0)

        dx = -torch.linalg.solve_ex(Hm, rhs)[0].reshape(K, 6)
        dx = torch.where(torch.isfinite(dx) & free[:, None], dx, 0.0)
        T = se3_exp(dx) @ T
    return pg._replace(T=T)


def optimize_cg(pg: PoseGraph, iters: int = 15, cg_iters: int = 64,
                lam: float = 1e-6) -> PoseGraph:
    """Matrix-free Gauss-Newton, each step solved by `cg_iters` iterations
    of block-Jacobi-preconditioned CG: only per-edge [6,6] blocks and [K,6]
    vectors exist, never the [6K,6K] system.  The iteration counts are
    fixed, so nothing is read from the device."""
    K = pg.T.shape[0]
    e_i, e_j = pg.e_i.to(torch.int64), pg.e_j.to(torch.int64)
    w = _edge_weights(pg)
    live = w > 0                    # padded and invalid edges: left out
    free = (pg.node_valid & ~pg.node_fixed)[:, None]             # [K,1]
    z = dict(dtype=pg.T.dtype, device=pg.T.device)

    def scatter(vi, vj):
        out = index_add_ordered(torch.zeros(K, *vi.shape[1:], **z), e_i, vi,
                                live)
        return index_add_ordered(out, e_j, vj, live)

    T = pg.T
    for _ in range(iters):
        T_i, T_j = T[e_i], T[e_j]
        r = edge_residual(T_i, T_j, pg.e_meas)                   # [E,6]
        Ji, Jj = _edge_jacobians(T_i, T_j, pg.e_meas)            # [E,6,6]
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj
        b = torch.where(free, scatter(torch.einsum("eri,er->ei", wJi, r),
                                      torch.einsum("eri,er->ei", wJj, r)), 0.0)
        # block diagonal of H, for the Jacobi preconditioner
        D = scatter(torch.einsum("eri,erj->eij", wJi, Ji),
                    torch.einsum("eri,erj->eij", wJj, Jj))
        D_inv = chol_inv(D + (lam + 1e-8) * torch.eye(6, **z))

        def Hv(v):
            q = torch.einsum("eij,ej->ei", Ji, v[e_i]) \
                + torch.einsum("eij,ej->ei", Jj, v[e_j])
            out = scatter(torch.einsum("eri,er->ei", wJi, q),
                          torch.einsum("eri,er->ei", wJj, q)) + lam * v
            return torch.where(free, out, 0.0)

        def precond(v):
            return torch.where(free, torch.einsum("kij,kj->ki", D_inv, v), 0.0)

        # PCG for H dx = -b
        x = torch.zeros(K, 6, **z)
        res = -b
        p = zv = precond(res)
        rz = torch.sum(res * zv)
        for _ in range(cg_iters):
            Hp = Hv(p)
            denom = torch.sum(p * Hp)
            alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, 0.0)
            x = x + alpha * p
            res = res - alpha * Hp
            zv = precond(res)
            rz_new = torch.sum(res * zv)
            beta = torch.where(torch.abs(rz) > 1e-12, rz_new / rz, 0.0)
            p = zv + beta * p
            rz = rz_new
        dx = torch.where(torch.isfinite(x) & free, x, 0.0)
        T = se3_exp(dx) @ T
    return pg._replace(T=T)


def total_error(pg: PoseGraph) -> torch.Tensor:
    r = edge_residual(pg.T[pg.e_i.to(torch.int64)],
                      pg.T[pg.e_j.to(torch.int64)], pg.e_meas)
    return torch.sum(_edge_weights(pg) * torch.sum(r * r, dim=-1))

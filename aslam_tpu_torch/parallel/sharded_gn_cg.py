"""Distributed joint GN-CG bundle adjustment.

Port of `aslam_tpu/parallel/sharded_gn_cg.py`: the matrix-free PCG of
`ops/global_ba.py::gn_cg_step` across the ranks of a mesh.  Keyframe rows
(and their edge grids) shard over all ranks; landmark-side quantities are
summed over the world.  Per CG iteration the only collectives are one
all-reduce of a [L,3] partial (the landmark half of Hv) and two scalar
all-reduces (the camera halves of the dot products); camera-side state
never leaves its rank.

The damping is the relative (trace-scaled) one of `gn_cg_step`.  As in the
reference, the sharded step has no odometry-chain regularizer.
"""

from __future__ import annotations

import torch

from aslam_tpu_torch.config import BAConfig, CameraModel
from aslam_tpu_torch.models.mapstate import MapState
from aslam_tpu_torch.ops.global_ba import GlobalBAStats, _oldest, _trace
from aslam_tpu_torch.ops.index import index_add_ordered
from aslam_tpu_torch.ops.linalg import chol_inv
from aslam_tpu_torch.parallel.mesh import Mesh
from aslam_tpu_torch.parallel.sharded_global_ba import (_kf_shard,
                                                        _shard_edge_terms)
from aslam_tpu_torch.utils.se3 import se3_exp

AXES = ("dp", "lm")


def sharded_gn_cg_step(m: MapState, cam: CameraModel, cfg: BAConfig,
                       mesh: Mesh, robust: bool = True, cg_iters: int = 32,
                       lam: float = 1e-3):
    """One distributed joint GN step.  Call on every rank with the same
    whole map, K divisible by the mesh size
    (`sharded_global_ba.pad_map_for_mesh`).  Returns (MapState, stats),
    replicated, on the mesh's device."""
    m = MapState(*(x.to(mesh.device) for x in m))
    L = m.lm_pos.shape[0]
    z = dict(dtype=m.lm_pos.dtype, device=m.lm_pos.device)
    sh = _kf_shard(m, mesh)
    Ks = sh.kf_T_cw.shape[0]
    my_rows = mesh.axis_index(AXES) * Ks + torch.arange(
        Ks, device=z["device"])
    cam_free = sh.kf_valid & (my_rows != _oldest(m))
    pt_free = m.lm_valid

    r, Jc, Jp, w, _, active, lm = _shard_edge_terms(
        sh, sh.kf_T_cw, m.lm_pos, cam, cfg, robust)
    # inactive edges weigh 0: left out of every scatter-add
    flat, act = lm.reshape(-1), active.reshape(-1)
    wJc = w[..., None, None] * Jc
    wJp = w[..., None, None] * Jp

    bc = torch.einsum("kmri,kmr->ki", wJc, r)                  # [Ks,6] local
    bc = torch.where(cam_free[:, None], bc, 0.0)
    bl = mesh.psum(index_add_ordered(
        torch.zeros(L, 3, **z), flat,
        torch.einsum("kmri,kmr->kmi", wJp, r).reshape(-1, 3), act), AXES)
    bl = torch.where(pt_free[:, None], bl, 0.0)

    Dc = torch.einsum("kmri,kmrj->kij", wJc, Jc)
    Dl = mesh.psum(index_add_ordered(
        torch.zeros(L, 9, **z), flat,
        torch.einsum("kmri,kmrj->kmij", wJp, Jp).reshape(-1, 9), act),
        AXES).reshape(L, 3, 3)
    # relative (trace-scaled) damping, as in ops/global_ba.py::gn_cg_step
    lam_c = lam * torch.clamp(_trace(Dc) / 6.0, min=1.0) + 1e-8    # [Ks]
    lam_l = lam * torch.clamp(_trace(Dl) / 3.0, min=1.0) + 1e-8    # [L]
    Dc_inv = chol_inv(Dc + lam_c[:, None, None] * torch.eye(6, **z))
    Dl_inv = chol_inv(Dl + lam_l[:, None, None] * torch.eye(3, **z))

    def Hv(vc, vl):
        # vc: [Ks,6] this rank's shard; vl: [L,3] replicated
        q = (torch.einsum("kmri,ki->kmr", Jc, vc)
             + torch.einsum("kmri,kmi->kmr", Jp, vl[lm]))
        wq = w[..., None] * q
        oc = torch.einsum("kmri,kmr->ki", Jc, wq)
        ol = mesh.psum(index_add_ordered(torch.zeros(L, 3, **z), flat,
                                         torch.einsum("kmri,kmr->kmi", Jp, wq)
                                         .reshape(-1, 3), act), AXES)
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
        # camera halves are disjoint shards -> summed over the world;
        # landmark halves are replicated -> counted once
        return (mesh.psum(torch.sum(a[0] * b[0]), AXES)
                + torch.sum(a[1] * b[1]))

    # PCG for H x = -b
    x = (torch.zeros(Ks, 6, **z), torch.zeros(L, 3, **z))
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

    new_T = se3_exp(dxc) @ sh.kf_T_cw
    new_pts = m.lm_pos + dxl

    # stats on the updated state
    _, _, _, _, chi2, active, _ = _shard_edge_terms(sh, new_T, new_pts, cam,
                                                    cfg, robust=False)
    chi2_total = mesh.psum(torch.sum(torch.where(active, chi2, 0.0)), AXES)
    n_edges = mesh.psum(torch.sum(active.to(torch.int32)), AXES)
    return m._replace(kf_T_cw=mesh.all_gather(new_T, AXES, 0),
                      lm_pos=new_pts), GlobalBAStats(chi2=chi2_total,
                                                     n_edges=n_edges)

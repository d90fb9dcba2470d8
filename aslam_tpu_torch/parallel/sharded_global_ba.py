"""Distributed global BA: alternating sweeps sharded across the ranks of a
mesh.

Port of `aslam_tpu/parallel/sharded_global_ba.py`, the map-scale
counterpart of parallel/sharded_ba.py.  Keyframe rows shard over all ranks
(rank r holds rows [r K / n, (r + 1) K / n)); landmarks are replicated.
Per sweep:

  pose sweep:   each rank solves the 6x6 systems of its keyframe shard with
                no communication (landmarks read-only);
  point sweep:  each rank scatter-adds the landmark normal equations of its
                shard's edges (ordered, `ops/index.py`); the blocks are
                summed over 'dp' and reduce-scattered over 'lm', each lm
                shard solves its own 3x3 systems, and the updates are
                all-gathered over 'lm'.

The poses are all-gathered over the world once, at the end.
"""

from __future__ import annotations

import torch

from aslam_tpu_torch.config import BAConfig, CameraModel
from aslam_tpu_torch.models.mapstate import MapState
from aslam_tpu_torch.ops.global_ba import (_KF_FIELDS, _edge_terms, _oldest,
                                           _trace)
from aslam_tpu_torch.ops.index import index_add_ordered
from aslam_tpu_torch.ops.linalg import chol_solve
from aslam_tpu_torch.parallel.mesh import Mesh
from aslam_tpu_torch.parallel.sharded_ba import _pad
from aslam_tpu_torch.utils.se3 import se3_exp

KF_AXES = ("dp", "lm")


def _kf_shard(m: MapState, mesh: Mesh) -> MapState:
    """The map with only this rank's keyframe rows (views, no copy);
    landmark fields whole."""
    K = m.kf_T_cw.shape[0]
    if K % mesh.size:
        raise ValueError(f"K={K} keyframe rows do not divide over "
                         f"{mesh.size} ranks: pad the map first "
                         "(pad_map_for_mesh)")
    return m._replace(**{f: mesh.shard(getattr(m, f)) for f in _KF_FIELDS})


def _shard_edge_terms(shard: MapState, kf_T: torch.Tensor,
                      lm_pos: torch.Tensor, cam: CameraModel, cfg: BAConfig,
                      robust: bool):
    """Edge terms of a keyframe shard ([Ks, M] rows) at poses `kf_T` against
    the replicated landmarks `lm_pos` -> `ops/global_ba.py::_edge_terms`'s
    (r, Jc, Jp, w, chi2, active, lm)."""
    return _edge_terms(shard._replace(kf_T_cw=kf_T, lm_pos=lm_pos), cam, cfg,
                       robust)


def sharded_global_ba(m: MapState, cam: CameraModel, cfg: BAConfig,
                      mesh: Mesh, iters: int = 10, robust_iters: int = 5,
                      lam: float = 1e-4):
    """Distributed alternating-sweep global BA.  Call on every rank with the
    same whole map, K divisible by the mesh size and L by the 'lm' axis
    (`pad_map_for_mesh`).  Returns (MapState with refined poses and points,
    final chi2), replicated, on the mesh's device."""
    m = MapState(*(x.to(mesh.device) for x in m))
    L = m.lm_pos.shape[0]
    z = dict(dtype=m.lm_pos.dtype, device=m.lm_pos.device)
    eye6, eye3 = torch.eye(6, **z), torch.eye(3, **z)
    sh = _kf_shard(m, mesh)
    Ks = sh.kf_T_cw.shape[0]
    my_rows = mesh.axis_index(KF_AXES) * Ks + torch.arange(
        Ks, device=z["device"])
    freeze = (my_rows == _oldest(m)) | ~sh.kf_valid
    lm0 = mesh.axis_index("lm") * (L // mesh.shape["lm"])

    kf_T, lm_pos = sh.kf_T_cw, m.lm_pos
    chi2 = torch.zeros((), **z)
    for i in range(iters):
        robust = i < robust_iters
        # ---- pose sweep: local to the shard ----
        r, Jc, _, w, _, _, _ = _shard_edge_terms(sh, kf_T, lm_pos, cam, cfg,
                                                 robust)
        H = torch.einsum("km,kmri,kmrj->kij", w, Jc, Jc)
        b = torch.einsum("km,kmri,kmr->ki", w, Jc, r)
        H = H + lam * eye6 * torch.clamp(_trace(H)[:, None, None] / 6.0,
                                         min=1e-6) + 1e-8 * eye6
        dx = -chol_solve(H, b)
        dx = torch.where(torch.isfinite(dx) & ~freeze[:, None], dx, 0.0)
        kf_T = se3_exp(dx) @ kf_T

        # ---- point sweep: reduce over the mesh, solve the lm shard ----
        r, _, Jp, w, chi2_e, active, lm = _shard_edge_terms(
            sh, kf_T, lm_pos, cam, cfg, robust)
        wJp = w[..., None, None] * Jp
        flat, act = lm.reshape(-1), active.reshape(-1)
        Hll = index_add_ordered(torch.zeros(L, 9, **z), flat, torch.einsum(
            "kmri,kmrj->kmij", wJp, Jp).reshape(-1, 9), act).reshape(L, 3, 3)
        bl = index_add_ordered(torch.zeros(L, 3, **z), flat, torch.einsum(
            "kmri,kmr->kmi", wJp, r).reshape(-1, 3), act)
        Hll_s = mesh.psum_scatter(mesh.psum(Hll, "dp"), "lm", 0)
        bl_s = mesh.psum_scatter(mesh.psum(bl, "dp"), "lm", 0)
        Ls = bl_s.shape[0]
        lv_s = m.lm_valid.narrow(0, lm0, Ls)
        Hll_s = Hll_s + lam * eye3 * torch.clamp(
            _trace(Hll_s)[:, None, None] / 3.0, min=1e-6) + 1e-8 * eye3
        dxl_s = -chol_solve(Hll_s, bl_s)
        dxl_s = torch.where(lv_s[:, None] & torch.isfinite(dxl_s), dxl_s, 0.0)
        lm_pos = lm_pos + mesh.all_gather(dxl_s, "lm", 0)
        chi2 = mesh.psum(torch.sum(torch.where(active, chi2_e, 0.0)), KF_AXES)

    kf_T = mesh.all_gather(kf_T, KF_AXES, 0)
    return m._replace(kf_T_cw=kf_T, lm_pos=lm_pos), chi2


def pad_map_for_mesh(m: MapState, mesh: Mesh) -> MapState:
    """Pad K to a multiple of the mesh size and L to a multiple of the 'lm'
    axis, with empty slots: identity poses, invalid keyframes (id -1, no
    keypoints, kf_lm -1) and invalid landmarks.  The observer index
    (`lm_obs_*`, which the reference's map leaves at L rows) pads too, with
    empty entries, so every landmark field keeps one row per landmark."""
    K = m.kf_T_cw.shape[0]
    L = m.lm_pos.shape[0]
    pk = (-K) % mesh.size
    pl = (-L) % mesh.shape["lm"]
    if pk:
        eye = torch.eye(4, dtype=m.kf_T_cw.dtype, device=m.kf_T_cw.device)
        m = m._replace(
            kf_T_cw=torch.cat([m.kf_T_cw, eye.expand(pk, 4, 4)]),
            kf_valid=_pad(m.kf_valid, pk, False),
            kf_id=_pad(m.kf_id, pk, -1),
            kf_xy=_pad(m.kf_xy, pk, 0.0),
            kf_ur=_pad(m.kf_ur, pk, -1.0),
            kf_z=_pad(m.kf_z, pk, 0.0),
            kf_desc=_pad(m.kf_desc, pk, 0),
            kf_octave=_pad(m.kf_octave, pk, 0),
            kf_kp_valid=_pad(m.kf_kp_valid, pk, False),
            kf_lm=_pad(m.kf_lm, pk, -1),
        )
    if pl:
        m = m._replace(
            lm_pos=_pad(m.lm_pos, pl, 0.0),
            lm_desc=_pad(m.lm_desc, pl, 0),
            lm_valid=_pad(m.lm_valid, pl, False),
            lm_first_kf=_pad(m.lm_first_kf, pl, -1),
            lm_visible=_pad(m.lm_visible, pl, 0),
            lm_found=_pad(m.lm_found, pl, 0),
            lm_obs_kf=_pad(m.lm_obs_kf, pl, -1),
            lm_obs_feat=_pad(m.lm_obs_feat, pl, 0),
            lm_obs_ptr=_pad(m.lm_obs_ptr, pl, 0),
        )
    return m

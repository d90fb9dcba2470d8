"""Multi-rank dry run of the two distributed solvers, with parity against a
single device.

The port's counterpart of `__graft_entry__.py::dryrun_multichip`: it builds
the same two noisy problems from `np.random.default_rng(0)` (a windowed
Schur problem of 4 cameras x 64 points, and a joint GN-CG map of 8
keyframes x 64 features), solves each sharded over the mesh and on one
device, and prints the reference's two lines: chi2 before -> after, the
single-device chi2, the edges, and the largest parameter difference between
the two solves, so that the tail tells "collectives correct" from "all zero
by accident".  The reference's virtual-mesh scaling proxy is not ported.

Run it on every rank of an initialized process group, e.g.

    torchrun --nproc-per-node 2 -m aslam_tpu_torch.parallel.dryrun --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aslam_tpu_torch.config import (BAConfig, CameraModel, ExtractorConfig,
                                    MapConfig, SystemConfig)
from aslam_tpu_torch.models import mapstate as ms
from aslam_tpu_torch.ops import lba
from aslam_tpu_torch.ops.global_ba import _edge_terms, gn_cg_step
from aslam_tpu_torch.parallel.mesh import make_mesh
from aslam_tpu_torch.parallel.sharded_ba import pad_problem, sharded_local_ba
from aslam_tpu_torch.parallel.sharded_global_ba import pad_map_for_mesh
from aslam_tpu_torch.parallel.sharded_gn_cg import sharded_gn_cg_step
from aslam_tpu_torch.utils import camera, se3

CAM = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320,
                  height=240)
CFG = BAConfig(local_iters_1=2, local_iters_2=2)


def _exp(xi: np.ndarray) -> np.ndarray:
    return se3.se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy()


def _project(pc: np.ndarray):
    uv, z = camera.project(CAM, torch.from_numpy(pc))
    return uv.numpy(), z.numpy()


def dryrun_problems(device):
    """The reference's two problems, drawn in its order from
    `np.random.default_rng(0)` -> (BAProblem, MapState) on `device`."""
    rng = np.random.default_rng(0)
    C, L = 4, 64
    pts = np.stack([rng.uniform(-1, 1, L), rng.uniform(-1, 1, L),
                    rng.uniform(2, 4, L)], -1).astype(np.float32)
    cam_T = np.stack([_exp(np.concatenate([[0.1 * i, 0, 0],
                                           rng.normal(0, 0.01, 3)]))
                      for i in range(C)])

    uv, ur, z = [], [], []
    for c in range(C):
        u, zz = _project(pts @ cam_T[c][:3, :3].T + cam_T[c][:3, 3])
        uv.append(u)
        z.append(zz)
        ur.append(camera.u_right(CAM, torch.from_numpy(u[:, 0]),
                                 torch.from_numpy(zz)).numpy())

    # perturb the initial estimate: points sigma 1 cm, poses ~0.5 cm/0.3 deg
    cam_T_noisy = cam_T.copy()
    for i in range(1, C):
        xi = np.concatenate([rng.normal(0, 0.005, 3), rng.normal(0, 0.005, 3)])
        cam_T_noisy[i] = _exp(xi) @ cam_T[i]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    prob = lba.BAProblem(
        cam_T=dev(cam_T_noisy),
        cam_fixed=dev(np.arange(C) == 0),
        cam_valid=dev(np.ones(C, bool)),
        points=dev(pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)),
        point_valid=dev(np.ones(L, bool)),
        e_cam=dev(np.repeat(np.arange(C), L).astype(np.int32)),
        e_lm=dev(np.tile(np.arange(L), C).astype(np.int32)),
        e_uv=dev(np.concatenate(uv).astype(np.float32)),
        e_ur=dev(np.concatenate(ur).astype(np.float32)),
        e_z=dev(np.concatenate(z).astype(np.float32)),
        e_valid=dev(np.ones(C * L, bool)),
    )

    # the joint GN-CG map: keyframe c sees the first M points from camera
    # c % C, with noisy poses and points
    K, M = 8, 64
    sys_cfg = SystemConfig(camera=CAM,
                           extractor=ExtractorConfig(max_keypoints=M),
                           map=MapConfig(max_keyframes=K, max_landmarks=64))
    kf_xy = np.zeros((K, M, 2), np.float32)
    kf_z = np.zeros((K, M), np.float32)
    for c in range(K):
        T = cam_T[c % C]
        kf_xy[c], kf_z[c] = _project(pts[:M] @ T[:3, :3].T + T[:3, 3])
    kf_T = np.tile(cam_T, (2, 1, 1))[:K].copy()
    for c in range(1, K):
        xi = np.concatenate([rng.normal(0, 0.004, 3), rng.normal(0, 0.004, 3)])
        kf_T[c] = _exp(xi) @ kf_T[c]
    kf_ur = np.where(kf_z > 0, kf_xy[..., 0] - CAM.bf / np.maximum(kf_z, 1e-6),
                     -1.0).astype(np.float32)
    m = ms.init_map(sys_cfg, device)._replace(
        kf_T_cw=dev(kf_T),
        kf_valid=dev(np.ones(K, bool)),
        kf_id=dev(np.arange(K, dtype=np.int32)),
        kf_xy=dev(kf_xy), kf_z=dev(kf_z), kf_ur=dev(kf_ur),
        kf_kp_valid=dev(kf_z > 0),
        kf_lm=dev(np.tile(np.arange(M, dtype=np.int32), (K, 1))),
        lm_pos=dev(pts[:64] + rng.normal(0, 0.008, pts[:64].shape)
                   .astype(np.float32)),
        lm_valid=dev(np.ones(64, bool)),
    )
    return prob, m


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def dryrun_multichip(n_devices: int, dp: int | None = None,
                     lm: int | None = None, device=None) -> dict:
    """Both distributed solvers on a dp x lm mesh over the initialized
    world of `n_devices` ranks, against the same problems solved on one
    device.  Rank 0 prints the two lines; every rank checks them and
    returns the numbers -> {"schur": {...}, "gn_cg": {...}}."""
    mesh = make_mesh(n_devices, dp=dp, lm=lm, device=device)
    prob, m = dryrun_problems(mesh.device)
    out = {}

    # ---- windowed-Schur path
    C, L = prob.cam_T.shape[0], prob.points.shape[0]
    *_, chi2_e, active_e = lba.edge_terms(prob, CAM, CFG, robust=False)
    before = float(torch.sum(torch.where(active_e, chi2_e, 0.0)))
    prob_ref, stats_ref = lba.local_ba(prob, CAM, CFG)
    res, chi2, n_edges = sharded_local_ba(pad_problem(prob, mesh), CAM, CFG,
                                          mesh)
    out["schur"] = dict(
        before=before, after=float(chi2), single=float(stats_ref.chi2),
        edges=int(n_edges), d_T=_max_abs(res.cam_T[:C], prob_ref.cam_T),
        d_X=_max_abs(res.points[:L], prob_ref.points))
    s = out["schur"]
    if mesh.rank == 0:
        print(f"dryrun_multichip (windowed Schur): mesh={dict(mesh.shape)} "
              f"chi2 {s['before']:.3f} -> {s['after']:.3f} (single-device "
              f"{s['single']:.3f}) edges={s['edges']} | parity "
              f"max|dT|={s['d_T']:.2e} max|dX|={s['d_X']:.2e}", flush=True)
    if not s["before"] > 1.0:
        raise AssertionError("dryrun problem degenerate (chi2_before ~ 0)")
    if not s["after"] < s["before"]:
        raise AssertionError("sharded BA did not reduce chi2")
    if not (s["d_T"] < 1e-3 and s["d_X"] < 1e-3):
        raise AssertionError("sharded != single-device")

    # ---- joint GN-CG path over a small noisy map (the config-5 step)
    K, L2 = m.kf_T_cw.shape[0], m.lm_pos.shape[0]
    _, _, _, _, chi2_e, active_e, _ = _edge_terms(m, CAM, CFG, robust=False)
    before = float(torch.sum(torch.where(active_e, chi2_e, 0.0)))
    m_ref, stats_ref = gn_cg_step(m, CAM, CFG, cg_iters=8)
    res, stats = sharded_gn_cg_step(pad_map_for_mesh(m, mesh), CAM, CFG, mesh,
                                    cg_iters=8)
    out["gn_cg"] = dict(
        before=before, after=float(stats.chi2), single=float(stats_ref.chi2),
        edges=int(stats.n_edges),
        d_T=_max_abs(res.kf_T_cw[:K], m_ref.kf_T_cw),
        d_X=_max_abs(res.lm_pos[:L2], m_ref.lm_pos))
    s = out["gn_cg"]
    if mesh.rank == 0:
        print(f"dryrun_multichip (joint GN-CG): chi2 {s['before']:.3f} -> "
              f"{s['after']:.3f} (single-device {s['single']:.3f}) "
              f"edges={s['edges']} | parity max|dT|={s['d_T']:.2e} "
              f"max|dX|={s['d_X']:.2e}", flush=True)
    if not s["before"] > 1.0:
        raise AssertionError("GN-CG dryrun problem degenerate")
    if not s["after"] < s["before"]:
        raise AssertionError("sharded GN-CG did not reduce chi2")
    if not (s["d_T"] < 1e-3 and s["d_X"] < 1e-3):
        raise AssertionError("sharded GN-CG != single-device")
    return out


def main(argv=None) -> None:
    import torch.distributed as dist

    from aslam_tpu_torch.parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="NCCL on the cards (default) or gloo on the CPU")
    ap.add_argument("--dp", type=int)
    ap.add_argument("--lm", type=int)
    args = ap.parse_args(argv)
    if not launch.initialize_from_env(args.device):
        launch.initialize(device=args.device)      # env://, as torchrun sets
    try:
        dryrun_multichip(dist.get_world_size(), dp=args.dp, lm=args.lm)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""One rank of the multi-rank parity job of tests/test_torch_parallel_ranks.py.

    python tests/_torch_parallel_worker.py RANK WORLD PORT INPUTS.npz OUT.npz

Joins a gloo group of WORLD CPU ranks at 127.0.0.1:PORT, runs the port's
sharded solvers on the problems in INPUTS (local-BA problems under keys
`lba_<field>` and `ref_<field>`, a map under `map_<field>`) on every dp x lm
layout of the world, and the dry run of `parallel/dryrun.py`; rank 0 writes
the results to OUT under `<dp>x<lm>_<solver>_<field>`.  Imports no jax.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from aslam_tpu_torch import config, convert
from aslam_tpu_torch.models.mapstate import MapState
from aslam_tpu_torch.ops.lba import BAProblem

# the settings both sides of the parity tests use: the local BA's are those
# of the reference's tests/test_lba.py
LBA_CAM = config.CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                             width=320, height=240)
LBA_CFG = config.BAConfig(local_iters_1=5, local_iters_2=10)
MAP_CFG = config.small_config()
GBA = dict(iters=4, robust_iters=2)
CG = dict(cg_iters=24)


def layouts(world: int) -> list[tuple[int, int]]:
    return [(dp, world // dp) for dp in range(1, world + 1) if world % dp == 0]


def load_inputs(path: str):
    """-> ({"lba": BAProblem, "ref": BAProblem}, MapState) on the CPU."""
    z = np.load(path)

    def fields(prefix):
        return {k[4:]: convert.tensor(z[k], "cpu") for k in z.files
                if k.startswith(prefix + "_")}

    probs = {name: BAProblem(**fields(name)) for name in ("lba", "ref")}
    return probs, MapState(**fields("map"))


def run(rank: int, world: int, port: int, inputs: str, out: str) -> None:
    import torch.distributed as dist

    from aslam_tpu_torch.parallel import launch
    from aslam_tpu_torch.parallel.dryrun import dryrun_multichip
    from aslam_tpu_torch.parallel.mesh import make_mesh
    from aslam_tpu_torch.parallel.partition import (partitioned_global_ba,
                                                    partitioned_gn_cg_step)
    from aslam_tpu_torch.parallel.sharded_ba import (pad_problem,
                                                     sharded_local_ba)
    from aslam_tpu_torch.parallel.sharded_global_ba import (pad_map_for_mesh,
                                                            sharded_global_ba)
    from aslam_tpu_torch.parallel.sharded_gn_cg import sharded_gn_cg_step

    torch.set_num_threads(1)     # WORLD ranks share the machine with the tests
    launch.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    probs, m = load_inputs(inputs)
    K, Lm = m.kf_T_cw.shape[0], m.lm_pos.shape[0]
    cam, ba = MAP_CFG.camera, MAP_CFG.ba
    res = {}
    for dp, lm in layouts(world):
        tag = f"{dp}x{lm}"
        mesh = make_mesh(world, dp, lm)

        def put(name, mm, stats):
            res[f"{tag}_{name}_kf_T_cw"] = mm.kf_T_cw[:K].numpy()
            res[f"{tag}_{name}_lm_pos"] = mm.lm_pos[:Lm].numpy()
            if isinstance(stats, tuple):
                res[f"{tag}_{name}_chi2"] = stats.chi2.numpy()
                res[f"{tag}_{name}_n_edges"] = stats.n_edges.numpy()
            else:
                res[f"{tag}_{name}_chi2"] = stats.numpy()

        for name, prob in probs.items():
            E, L = prob.e_cam.shape[0], prob.points.shape[0]
            padded = pad_problem(prob, mesh)
            p, chi2, n_edges = sharded_local_ba(padded, LBA_CAM, LBA_CFG,
                                                mesh)
            again = sharded_local_ba(padded, LBA_CAM, LBA_CFG, mesh)[0]
            res[f"{tag}_{name}_cam_T"] = p.cam_T.numpy()
            res[f"{tag}_{name}_points"] = p.points[:L].numpy()
            res[f"{tag}_{name}_e_valid"] = p.e_valid[:E].numpy()
            res[f"{tag}_{name}_chi2"] = chi2.numpy()
            res[f"{tag}_{name}_n_edges"] = n_edges.numpy()
            res[f"{tag}_{name}_same_bits"] = np.bool_(
                torch.equal(p.cam_T, again.cam_T)
                and torch.equal(p.points, again.points))

        mp = pad_map_for_mesh(m, mesh)
        put("gba", *sharded_global_ba(mp, cam, ba, mesh, **GBA))
        put("gncg", *sharded_gn_cg_step(mp, cam, ba, mesh, **CG))
        put("part", *partitioned_gn_cg_step(m, cam, ba, mesh, **CG))
        put("pgba", *partitioned_global_ba(m, cam, ba, mesh, **GBA))

        d = dryrun_multichip(world, dp, lm)
        for path, val in d.items():
            for key, v in val.items():
                res[f"{tag}_dry_{path}_{key}"] = np.float64(v)
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, p = (int(a) for a in sys.argv[1:4])
    run(r, w, p, sys.argv[4], sys.argv[5])

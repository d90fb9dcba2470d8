"""Multi-process launch wiring for distributed BA.

Port of `aslam_tpu/parallel/launch.py`.  Where the reference calls
`jax.distributed.initialize` and builds a mesh over the global device list,
the port starts one process per device and joins them in a
`torch.distributed` process group: NCCL on the card, gloo only where the
caller asks for the CPU (the tests).  The collectives of
`parallel/sharded_*.py` then run between processes, on one host or several.

Three entry styles:

  * torchrun (or any launcher that sets MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK): `initialize()` with no arguments reads `env://`, the
    counterpart of JAX's auto-detection on pods;
  * explicit: `initialize(coordinator, num_processes, process_id)`, a TCP
    rendezvous at "host:port";
  * `initialize_from_env()`: the same from ASLAM_COORDINATOR /
    ASLAM_NUM_PROCESSES / ASLAM_PROCESS_ID.

`initialize_local(device)` makes the one-rank group a single-process run
uses (one card = a 1x1 mesh).
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist

from aslam_tpu_torch.ops.lba import BAProblem
from aslam_tpu_torch.parallel.mesh import Mesh, make_mesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_EDGE_FIELDS = ("e_cam", "e_lm", "e_uv", "e_ur", "e_z", "e_valid")


def _backend(device) -> str:
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("NCCL process group asked for, but no CUDA device")
    return _BACKENDS[kind]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
    device: torch.device | str = "cuda",
) -> None:
    """Join the process group; call exactly once per process, before any
    mesh is made.  `device` "cuda" (the default) joins with NCCL and makes
    this rank's card current: `local_device_ids[0]`, else LOCAL_RANK, else
    the rank modulo the visible cards.  "cpu" joins with gloo."""
    backend = _backend(device)
    if backend == "nccl":
        rank = process_id if process_id is not None \
            else int(os.environ.get("RANK", 0))
        idx = (local_device_ids[0] if local_device_ids else
               int(os.environ.get("LOCAL_RANK", rank))
               % torch.cuda.device_count())
        torch.cuda.set_device(idx)
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def initialize_from_env(device: torch.device | str = "cuda") -> bool:
    """Initialize from ASLAM_COORDINATOR / ASLAM_NUM_PROCESSES /
    ASLAM_PROCESS_ID, or return False when they are unset (single-process
    runs, and torchrun jobs, which call `initialize()` themselves)."""
    coord = os.environ.get("ASLAM_COORDINATOR")
    if not coord:
        return False
    initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["ASLAM_NUM_PROCESSES"]),
        process_id=int(os.environ["ASLAM_PROCESS_ID"]),
        device=device,
    )
    return True


def initialize_local(device: torch.device | str) -> None:
    """A process group of this process alone, on `device`'s backend (NCCL
    for a card, gloo for the CPU), over an in-process store: what a
    single-process session reduces over.  A failure raises."""
    backend = _backend(device)
    device = torch.device(device)
    if backend == "nccl" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)


def global_mesh(dp: int | None = None, lm: int | None = None) -> Mesh:
    """Mesh over the whole world (every process's rank).  Axes as in
    parallel/mesh.py: 'dp' over BA edges, 'lm' over landmark shards.  Ranks
    of one 'lm' group are consecutive, so with one process per card and the
    ranks of a host numbered together, the high-traffic 'lm' collectives
    (reduce-scatter and all-gather of landmark blocks) stay within a host
    where lm divides the cards per host."""
    return make_mesh(dp=dp, lm=lm)


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process."""
    return dist.get_rank(), dist.get_world_size()


def shard_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """This rank's view of a BAProblem that every process holds whole:
    cameras and points replicated, edges sharded over all mesh axes (rank r
    keeps edges [r E / n, (r + 1) E / n), the ('dp', 'lm') order of the
    reference's `P(('dp', 'lm'))`), on the mesh's device.  E must divide by
    the mesh size (`sharded_ba.pad_problem`)."""
    E = prob.e_cam.shape[0]
    if E % mesh.size:
        raise ValueError(f"{E} edges do not divide over {mesh.size} ranks: "
                         "pad the problem first (sharded_ba.pad_problem)")
    return BAProblem(**{
        name: (mesh.shard(x) if name in _EDGE_FIELDS else x).to(mesh.device)
        for name, x in prob._asdict().items()})

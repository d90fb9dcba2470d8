"""Multi-process distribution of bundle adjustment over `torch.distributed`.

Port of `aslam_tpu/parallel/`.  Where the reference runs one SPMD program
over a JAX device mesh (`shard_map` bodies with `psum`, `psum_scatter` and
`all_gather`), the port runs one process per device: each rank executes the
body of the reference's `shard_map` on its own shard, and the collectives
are `torch.distributed` ones (NCCL on the card, gloo when the caller asks
for the CPU).  Replicated arrays are held whole on every rank.

    mesh.py               the ('dp', 'lm') grid of ranks and its collectives
    launch.py             process-group start-up, edge sharding of a problem
    sharded_ba.py         windowed Schur local BA across ranks
    sharded_global_ba.py  alternating-sweep global BA across ranks
    sharded_gn_cg.py      joint GN-CG step across ranks
    partition.py          covisibility-aware keyframe placement
    dryrun.py             the two parity lines of the multichip dry run
"""

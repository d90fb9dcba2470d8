"""The ('dp', 'lm') grid of ranks for distributed BA.

Port of `aslam_tpu/parallel/mesh.py`.  In JAX a mesh is a grid of devices
inside one program; here it is a grid of ranks of the initialized process
group, one process per device.  Rank r sits at (r // lm, r % lm), where
`np.reshape(devices, (dp, lm))` places device r.

Axes:
  'dp' - data parallelism over BA edges (residual blocks): each rank
         accumulates normal-equation contributions for its edge shard,
         reduced with `psum`.
  'lm' - model parallelism over landmarks: the block-diagonal landmark
         system and the Schur cross terms are reduce-scattered so each rank
         eliminates its own landmark shard.

`psum(x, 'dp')` reduces over the ranks that share this rank's 'lm' index
(its dp group), `psum(x, 'lm')` over those that share its 'dp' index (its
lm group), `psum(x, ('dp', 'lm'))` over the world.  A collective over an
axis of size 1 still runs, on a group of one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

AXES = ("dp", "lm")


def factor_devices(n: int) -> tuple[int, int]:
    """Split n devices into (dp, lm) as close to square as possible."""
    best = (n, 1)
    for dp in range(1, n + 1):
        if n % dp == 0:
            lm = n // dp
            if abs(dp - lm) <= abs(best[0] - best[1]):
                best = (dp, lm)
    return best


def _axes(axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if axes not in (("dp",), ("lm",), AXES):
        raise ValueError(f"mesh axes are 'dp', 'lm' or {AXES}, got {axes}")
    return axes


class Mesh:
    """This rank's place in a dp x lm grid of the world's ranks, with the
    process groups of its two axes and the reference's collectives on them.

    Every rank must build every mesh, in the same order: `dist.new_group` is
    collective, so each rank creates every dp group and every lm group, the
    ones it is not in too."""

    def __init__(self, dp: int, lm: int, device: torch.device):
        self.shape = {"dp": dp, "lm": lm}
        self.size = dp * lm
        self.device = device
        self.rank = dist.get_rank()
        self.coords = {"dp": self.rank // lm, "lm": self.rank % lm}
        self.world = dist.group.WORLD
        self.dp_group = self.lm_group = None
        for j in range(lm):      # dp groups: the ranks of one 'lm' index
            g = dist.new_group([i * lm + j for i in range(dp)])
            if j == self.coords["lm"]:
                self.dp_group = g
        for i in range(dp):      # lm groups: the ranks of one 'dp' index
            g = dist.new_group([i * lm + j for j in range(lm)])
            if i == self.coords["dp"]:
                self.lm_group = g

    def _group(self, axes):
        axes = _axes(axes)
        if len(axes) == 2:
            return self.world, self.size
        return ((self.dp_group, self.shape["dp"]) if axes[0] == "dp"
                else (self.lm_group, self.shape["lm"]))

    def axis_index(self, axes) -> int:
        """This rank's index along `axes` (a host int, as `lax.axis_index`
        is a constant of each device's program); along ('dp', 'lm') it is
        the rank."""
        axes = _axes(axes)
        return self.rank if len(axes) == 2 else self.coords[axes[0]]

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of `x` over the ranks of `axes` (`all_reduce`), out of place."""
        group, _ = self._group(axes)
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    def psum_scatter(self, x: torch.Tensor, axes,
                     dim: int = 0) -> torch.Tensor:
        """`lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)`:
        the sum over the ranks of `axes`, of which this rank keeps its block
        of `dim`.  `reduce_scatter_tensor` splits dim 0, so `dim` moves to
        the front first (a contiguous copy)."""
        group, n = self._group(axes)
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((xs.shape[0] // n,) + xs.shape[1:])
        dist.reduce_scatter_tensor(out, xs, group=group)
        return out.movedim(0, dim)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """`lax.all_gather(x, axes, axis=dim, tiled=True)`: the blocks of
        the ranks of `axes` concatenated along `dim`, in rank order."""
        group, n = self._group(axes)
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((xs.shape[0] * n,) + xs.shape[1:])
        dist.all_gather_into_tensor(out, xs, group=group)
        return out.movedim(0, dim)

    def shard(self, x: torch.Tensor, axes=AXES, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous block of `dim` along `axes` (the slice a
        `P(axes)` in_spec hands the shard_map body)."""
        _, n = self._group(axes)
        i = self.axis_index(axes)
        size = x.shape[dim] // n
        return x.narrow(dim, i * size, size)


def _default_device() -> torch.device:
    """The device the process group's backend reduces on: the current CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              lm: int | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """A dp x lm mesh over the initialized world (`launch.initialize`).
    `n_devices` must equal the world size; dp and lm default to the most
    square split.  `device` (default: the backend's, the current card under
    NCCL, the CPU under gloo) is where this rank's tensors live."""
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"mesh of {n} devices over a world of {world} ranks")
    if dp is None or lm is None:
        dp, lm = factor_devices(n)
    if dp * lm != n:
        raise ValueError(f"mesh {dp}x{lm} != {n} devices")
    return Mesh(dp, lm, torch.device(device) if device is not None
                else _default_device())

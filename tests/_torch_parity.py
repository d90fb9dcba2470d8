"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*).

Each such test feeds the same numpy inputs, made from a seed, to a function
of the JAX package and to its counterpart in `aslam_tpu_torch`, both on the
CPU, and compares the outputs.  Data crosses between the two as numpy
arrays.  Packed descriptors are uint32 words in JAX and int32 words (the
same bit patterns) in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# xdist runs several workers on one machine: keep each one's intra-op pool small
torch.set_num_threads(2)


def t(a) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (uint32 words viewed as int32)."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def n(x) -> np.ndarray:
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def words(x) -> np.ndarray:
    """Packed descriptor words from either side as int32 bit patterns."""
    a = n(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def tree_np(x):
    """A jax pytree (NamedTuples of arrays) -> the same tree of numpy arrays."""
    import jax

    return jax.tree.map(np.asarray, x)


def port_config(ref_cfg):
    """The reference's SystemConfig -> the port's equal one."""
    from aslam_tpu_torch import convert

    return convert.system_config(dataclasses.asdict(ref_cfg))

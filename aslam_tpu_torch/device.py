"""Precision policy for the whole port, set when the package is imported,
and the one helper through which the engine reads the device.

The counterpart of `aslam_tpu/__init__.py:38`, which forces full-f32
matmuls engine-wide.  On Hopper a float32 matmul may run in TF32 and a
float32 convolution does so by default through cuDNN; TF32 keeps about three
decimal digits, which moves pose geometry and flips the sign tests that
decide rBRIEF bits.  So both are turned off here.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def read_host(*xs: torch.Tensor) -> list[int]:
    """Read integer or bool tensors back to the host in one transfer (one
    device sync), flattened into one list of ints.  The SLAM engine's
    control flow reads the device only through here; each call adds one to
    `read_host.count`."""
    read_host.count += 1
    return torch.cat([x.reshape(-1).to(torch.int64) for x in xs]).tolist()


read_host.count = 0


def to_host(x: torch.Tensor) -> np.ndarray:
    """Read one tensor of any dtype back to the host as a numpy array (one
    transfer, one device sync), counted in `read_host.count` like every
    other read the engine makes.  Callers pack what they need into one
    tensor first."""
    read_host.count += 1
    return x.cpu().numpy()


def as_device(x, device: torch.device | str) -> torch.Tensor:
    """A numpy array or a tensor -> a tensor on `device`, dtype kept."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)

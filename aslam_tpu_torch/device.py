"""Precision policy for the whole port, set when the package is imported.

The counterpart of `aslam_tpu/__init__.py:38`, which forces full-f32
matmuls engine-wide.  On Hopper a float32 matmul may run in TF32 and a
float32 convolution does so by default through cuDNN; TF32 keeps about three
decimal digits, which moves pose geometry and flips the sign tests that
decide rBRIEF bits.  So both are turned off here.
"""

from __future__ import annotations

import torch

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

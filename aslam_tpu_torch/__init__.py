"""aslam_tpu_torch — the PyTorch and CUDA port of `aslam_tpu`.

The port mirrors the JAX package's layout and function names, so that
`aslam_tpu/ops/ransac.py::ransac_align` has its counterpart at
`aslam_tpu_torch/ops/ransac.py::ransac_align`.  The JAX package stays the
reference: every ported function is held to it by a test under
`tests/test_torch_*.py` that feeds both the same numpy inputs.

Layer map:

    models/   frame construction, frame-to-frame odometry, the VO driver
    ops/      pyramid, FAST, grid top-k, rBRIEF, Hamming matching (with the
              hand-written `hamming_top2` CUDA kernel), RANSAC, pose BA
    utils/    SE(3), camera model, synthetic scenes, trajectory metrics
    kernels/  builds the CUDA sources under `csrc/` with nvcc on first use
    convert   carries the JAX package's values (as numpy) into port tensors

The package imports torch and numpy, never jax or `aslam_tpu`.  Importing it
sets the float32 precision policy (`device.py`).
"""

from aslam_tpu_torch import device as _device  # noqa: F401  (sets precision)

__version__ = "0.1.0"

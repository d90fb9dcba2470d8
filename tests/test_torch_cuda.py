"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no jax), so that it runs where the card is:

    python -m pytest tests/test_torch_cuda.py -q

Without a CUDA device every test here skips: a CUDA kernel has no CPU mode.
The plain versions themselves are held to the JAX package by
tests/test_torch_hamming.py on the CPU.
"""

import numpy as np
import pytest
import torch

from aslam_tpu_torch.ops.hamming_top2 import hamming_top2, hamming_top2_plain


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(n, m, seed, dev, ties=True, p_mask=0.1):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    va, vb = rng.random(n) > p_mask, rng.random(m) > p_mask
    if ties and m > 4 and n > 2:
        b[m // 2:] = b[0]                    # equal minima across tiles
        a[: n // 2] = b[0] ^ np.uint32(1)
    return [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
            .to(dev) for x in (a, va, b, vb)]


# odd sizes: rows not a multiple of 8 warps, targets below one warp, not a
# multiple of the 256-target tile, one target only, and the main path's sizes
SHAPES = [(1, 1), (7, 2), (33, 31), (100, 257), (257, 513), (256, 256),
          (1024, 1024), (1000, 2049)]


@pytest.mark.parametrize("n,m", SHAPES)
def test_hamming_top2_kernel_equals_plain(n, m):
    dev = _card()
    for seed, ties, p_mask in ((0, True, 0.1), (1, False, 0.5), (2, True, 1.0)):
        args = _inputs(n, m, seed, dev, ties, p_mask)
        before = hamming_top2.launches
        out = hamming_top2(*args)
        torch.cuda.synchronize()
        assert hamming_top2.launches == before + 1
        if m == 1:
            # no second value in a one-target row: the kernel reports the
            # INVALID_DIST sentinel, as a masked second target would give
            a_, va_, b_, vb_ = args
            args = [a_, va_, torch.cat([b_, b_]),
                    torch.cat([vb_, torch.zeros_like(vb_)])]
        ref = hamming_top2_plain(*args)
        for x, y in zip(out, ref):
            assert torch.equal(x, y), (n, m, seed)


def test_hamming_top2_wrapper_rejects_bad_inputs():
    dev = _card()
    a, va, b, vb = _inputs(16, 16, 0, dev)
    with pytest.raises(TypeError):
        hamming_top2(a.to(torch.int64), va, b, vb)
    with pytest.raises(ValueError):
        hamming_top2(a, va, b[:, :4], vb)
    with pytest.raises(ValueError):
        hamming_top2(a, va, b.t().contiguous().t(), vb)
    with pytest.raises(ValueError):
        hamming_top2(a, va, b.cpu(), vb)
    with pytest.raises(TypeError):
        hamming_top2(a, va.to(torch.uint8), b, vb)

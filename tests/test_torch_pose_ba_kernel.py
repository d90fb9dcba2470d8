"""Motion-only BA's dispatch and its CUDA kernel's wrapper, on the CPU.

`ops/ba.py::pose_only_ba` takes the plain version for CPU tensors and the
kernel of `csrc/pose_ba.cu` for CUDA tensors; the kernel itself runs only on
a card (tests/test_torch_cuda.py, marker `cuda`).  Here: the CPU path leaves
the kernel's launch counter alone, the wrapper refuses what the kernel does
not take before it looks for a card, its C binding matches the source, and
the plain version is held to `aslam_tpu/ops/ba.py::pose_only_ba` across the
options the kernel takes as arguments (information model, rounds x
iterations, the prior weight as a float and as a tensor).
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.ops import ba as jba
from aslam_tpu.utils import se3 as jse3
from aslam_tpu_torch.ops import ba as tba
from aslam_tpu_torch.ops import pose_ba_kernel as pk


def _problem(rng, N, cam):
    """One frame's edges: points seen from a pose near the truth, 0.5 px
    noise, the first tenth 30 px off, a fifth mono, a twentieth invalid."""
    pts_w = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1, 1, N),
                      rng.uniform(0.8, 3.5, N)], -1).astype(np.float32)
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.02, 0.01, -0.03, 0.01, 0.02, -0.01], np.float32))))
    pc = pts_w @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:N // 10] += 30.0
    z = (pc[:, 2] + rng.normal(0, 0.005, N)).astype(np.float32)
    ur = np.where(rng.random(N) > 0.2, uv[:, 0] - cam.bf / z, -1.0).astype(np.float32)
    valid = rng.random(N) > 0.05
    T_init = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.01, -0.01, 0.01, 0.005, 0.0, 0.01], np.float32)))) @ T_true
    return T_init.astype(np.float32), pts_w, uv, ur, z, valid


def _port_args(seed=0, N=64):
    cfg = P.port_config(small_config())
    args = [P.t(a) for a in _problem(np.random.default_rng(seed), N, cfg.camera)]
    return args, cfg


def test_pose_only_ba_on_cpu_runs_plain_and_launches_nothing():
    args, cfg = _port_args()
    before = pk.pose_only_ba_kernel.launches
    out = tba.pose_only_ba(*args, cfg.camera, cfg.ba, prior_weight=2.0e6)
    ref = tba.pose_only_ba_plain(*args, cfg.camera, cfg.ba, prior_weight=2.0e6)
    assert pk.pose_only_ba_kernel.launches == before
    assert isinstance(out, tba.PoseBAResult)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


def test_kernel_wrapper_refuses_cpu_tensors():
    args, cfg = _port_args()
    before = pk.pose_only_ba_kernel.launches
    with pytest.raises(ValueError, match="runs on the card"):
        pk.pose_only_ba_kernel(*args, cfg.camera, cfg.ba)
    assert pk.pose_only_ba_kernel.launches == before


@pytest.mark.parametrize("which,dtype", [(0, torch.float64), (1, torch.float64),
                                         (2, torch.float16), (3, torch.int32),
                                         (4, torch.bfloat16), (5, torch.uint8)])
def test_kernel_wrapper_refuses_wrong_dtypes(which, dtype):
    """Types are checked before the device: CPU tensors of a wrong type get
    a TypeError that names the input."""
    args, cfg = _port_args()
    args[which] = args[which].to(dtype)
    names = ("T_cw_init", "pts_w", "obs_uv", "obs_ur", "obs_z", "valid")
    with pytest.raises(TypeError, match=names[which]):
        pk.pose_only_ba_kernel(*args, cfg.camera, cfg.ba)


@pytest.mark.parametrize("case", ["uv_rows", "ur_rows", "z_rows", "valid_rows",
                                  "uv_width", "T_lead", "pts_lead", "pts_width",
                                  "pts_4d"])
def test_kernel_wrapper_refuses_mismatched_shapes(case):
    """Shapes are checked first: mismatched N, a batch on some inputs only,
    points not [..., N, 3]."""
    args, cfg = _port_args()
    T, pts, uv, ur, z, valid = args
    if case == "uv_rows":
        uv = uv[:-1]
    elif case == "ur_rows":
        ur = ur[:-2]
    elif case == "z_rows":
        z = torch.cat([z, z[:1]])
    elif case == "valid_rows":
        valid = valid[:5]
    elif case == "uv_width":
        uv = torch.cat([uv, uv[:, :1]], -1)
    elif case == "T_lead":
        T = torch.stack([T, T])
    elif case == "pts_lead":
        pts = torch.stack([pts, pts])
    elif case == "pts_width":
        pts = pts[:, :2]
    else:
        pts = pts[None, None]
    with pytest.raises(ValueError, match="shape|points"):
        pk.pose_only_ba_kernel(T, pts, uv, ur, z, valid, cfg.camera, cfg.ba)


@pytest.mark.parametrize("prior", [torch.tensor([1.0, 2.0]),
                                   torch.tensor(2.0e6, dtype=torch.float64)])
def test_kernel_wrapper_refuses_bad_prior_weights(prior):
    args, cfg = _port_args()
    with pytest.raises(TypeError, match="prior_weight"):
        pk.pose_only_ba_kernel(*args, cfg.camera, cfg.ba, prior_weight=prior)


def test_kernel_wrapper_refuses_zero_rounds():
    args, cfg = _port_args()
    ba_cfg = dataclasses.replace(cfg.ba, pose_rounds=0)
    with pytest.raises(ValueError, match="pose_rounds"):
        pk.pose_only_ba_kernel(*args, cfg.camera, ba_cfg)


def test_binding_matches_the_kernel_source():
    """The ctypes argument list the wrapper sets (as it does on first use on a
    card) against the C entry point's parameters in csrc/pose_ba.cu: the same
    count, a pointer where the source has one, an int where it has an int,
    a float where it has a float."""
    import ctypes

    src = (Path(pk.__file__).parent.parent / "csrc" / "pose_ba.cu").read_text()
    params = re.search(r'extern "C" int pose_ba_launch\(([^)]*)\)', src).group(1)
    kinds = []
    for p in params.split(","):
        p = " ".join(p.split())
        kinds.append(ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                      else ctypes.c_float if p.startswith("float")
                      else ctypes.c_int)

    class Fn:
        pass

    class Lib:
        pose_ba_launch = Fn()

    from aslam_tpu_torch.kernels import build

    saved_load, saved = build.load, pk._launch
    build.load, pk._launch = (lambda name: Lib), None
    try:
        fn = pk._kernel()
    finally:
        build.load, pk._launch = saved_load, saved
    assert fn.argtypes == kinds
    assert fn.restype is ctypes.c_int


def test_kernel_is_one_of_the_built_sources():
    from aslam_tpu_torch.kernels import build

    assert {"hamming_top2", "pose_ba"} <= set(build.kernel_names())


@pytest.mark.parametrize("n,b", [(1024, 1), (1024, 16), (37, 1)])
def test_bound_counts_the_kernels_work(n, b):
    """The bound scales with lanes and edges, and at the main path's shapes
    the float64 sums set it, far above the bytes' time."""
    one = pk.pose_ba_bound(n)
    got = pk.pose_ba_bound(n, b)
    assert got["fp64"] == b * 40 * n * pk.EDGE_FP64
    assert got["bytes"] == b * one["bytes"]
    assert got["bound_by"] == "operations"
    assert got["bound_us"] == pytest.approx(b * one["bound_us"])
    if n == 1024:
        assert 0.1 < one["bound_us"] < 1.0


@pytest.mark.parametrize("prior_kind", ["float", "tensor"])
@pytest.mark.parametrize("rounds,iters", [(4, 10), (1, 1)])
@pytest.mark.parametrize("info_model", ["inv_z2", "constant"])
def test_pose_only_ba_options_match_reference(info_model, rounds, iters,
                                              prior_kind):
    """The plain version against the JAX package across the options the
    kernel takes as arguments: T to 1e-4 (the float32 LM's rounding), the
    inlier sets and counts exactly."""
    cfg = small_config()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, info_model=info_model, pose_rounds=rounds, pose_iters=iters))
    args = _problem(np.random.default_rng(11), 256, cfg.camera)
    ref = jba.pose_only_ba(*(jnp.asarray(a) for a in args), cfg.camera, cfg.ba,
                           prior_weight=2.0e6)
    pcfg = P.port_config(cfg)
    assert pcfg.ba.info_model == info_model
    prior = 2.0e6 if prior_kind == "float" else torch.tensor(2.0e6)
    out = tba.pose_only_ba(*(P.t(a) for a in args), pcfg.camera, pcfg.ba,
                           prior_weight=prior)
    np.testing.assert_allclose(P.n(out.T_cw), np.asarray(ref.T_cw), atol=1e-4)
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(P.n(out.inliers), np.asarray(ref.inliers))
    np.testing.assert_allclose(P.n(out.chi2), np.asarray(ref.chi2),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case", ["n1", "n37", "all_invalid", "nonfinite",
                                  "prior_tensor", "constant_1x1"])
def test_card_check_accepts_plain_and_refuses_faults(case):
    """`kernels/bench_pose_ba.check_against_plain`, which chip_smoke.py and
    the card tests hold the kernel to, on the CPU: the plain version passes
    against itself, and a pose moved by 1e-3 or an inlier flag flipped away
    from its threshold fails."""
    from aslam_tpu_torch.kernels import bench_pose_ba as PB

    cam = PB.camera()
    args, cfg, prior = PB.pose_ba_case(case, "cpu")
    ref = tba.pose_only_ba_plain(*args, cam, cfg, prior)
    got = PB.check_against_plain(ref, ref, args, cam, cfg, prior)
    assert got == {"dT": 0.0, "near_ties": 0}
    moved = ref._replace(T_cw=ref.T_cw + 1e-3)
    with pytest.raises(AssertionError):
        PB.check_against_plain(moved, ref, args, cam, cfg, prior)
    flipped = ref.inliers.clone()
    flipped[0] = ~flipped[0]
    with pytest.raises(AssertionError, match="inlier"):
        PB.check_against_plain(ref._replace(inliers=flipped), ref, args, cam,
                               cfg, prior)

"""Parity of the port's `aslam_tpu_torch/parallel/` with the JAX package's
`aslam_tpu/parallel/` in one process: the mesh factorisation, the
covisibility placement (on tests/test_partition.py's inputs), the padding
of problems and maps, the row permutation, the mesh's collectives on a
one-rank gloo group, and the session's sharded post-loop GBA
(`LoopClosing._post_loop_gba` with `post_gba_method="sharded_gn_cg"`: the
reference over conftest's 8 virtual CPU devices, the port over a one-rank
group it creates, which the test destroys after).

Integer outputs and permutations must be equal; padded arrays equal; the
sharded GBA's poses and points within 2e-3 (the reference's bound for the
global solvers, tests/test_sharded_global_ba.py).  The multi-rank checks
are in tests/test_torch_parallel_ranks.py.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parity as P
import test_torch_lba as TL
from aslam_tpu.models import loopclosing as jlc
from aslam_tpu.parallel import mesh as jmesh
from aslam_tpu.parallel import partition as jpart
from aslam_tpu.parallel import sharded_ba as jsba
from aslam_tpu.parallel import sharded_global_ba as jsgba
from aslam_tpu_torch.models import loopclosing as tlc
from aslam_tpu_torch.ops import global_ba as tgba
from aslam_tpu_torch.parallel import launch
from aslam_tpu_torch.parallel import mesh as tmesh
from aslam_tpu_torch.parallel import partition as tpart
from aslam_tpu_torch.parallel import sharded_ba as tsba
from aslam_tpu_torch.parallel import sharded_global_ba as tsgba
from test_partition import interleaved_clusters
from tests.test_global_ba import build_noisy_map


@pytest.fixture
def one_rank():
    """A one-rank gloo group for the test, destroyed after it."""
    launch.initialize_local("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def noisy_map():
    cfg, m, *_ = build_noisy_map(np.random.default_rng(42), n_kfs=8,
                                 n_pts=128)
    return cfg, m, P.port_map(m)


def _layout_mesh(layout):
    """The JAX mesh of a layout and the fields the port's padding reads of
    its own (`size`, `shape`)."""
    dp, lm = layout
    return (jmesh.make_mesh(dp * lm, dp=dp, lm=lm),
            types.SimpleNamespace(size=dp * lm, shape={"dp": dp, "lm": lm}))


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_devices_matches_reference(n):
    assert tmesh.factor_devices(n) == jmesh.factor_devices(n)


def _corridor(K=24):
    W = np.zeros((K, K))
    for d in (1, 2, 3):
        idx = np.arange(K - d)
        W[idx, idx + d] = W[idx + d, idx] = 10.0 / d
    return W, np.ones(K, bool)


def _backfill(K=16):
    valid = np.zeros(K, bool)
    valid[:10] = True
    W = np.zeros((K, K))
    W[:10, :10] = 5.0
    np.fill_diagonal(W, 0.0)
    return W, valid


CASES = {"interleaved": lambda: (interleaved_clusters()[0], np.ones(32, bool)),
         "corridor": _corridor, "backfill": _backfill}


@pytest.mark.parametrize("case", CASES)
def test_partition_matches_reference(case):
    W, valid = CASES[case]()
    K = len(valid)
    perm = tpart.partition_keyframes(W, valid, 4)
    np.testing.assert_array_equal(perm, jpart.partition_keyframes(W, valid, 4))
    assert perm.dtype == np.int32 and sorted(perm) == list(range(K))
    shard = tpart.shard_of_from_perm(perm, 4)
    np.testing.assert_array_equal(shard, jpart.shard_of_from_perm(perm, 4))
    contig = tpart.contiguous_assignment(K, 4)
    np.testing.assert_array_equal(contig, jpart.contiguous_assignment(K, 4))
    for s in (shard, contig):
        assert tpart.edge_cut_fraction(W, s) == jpart.edge_cut_fraction(W, s)
    with pytest.raises(ValueError, match="divisible"):
        tpart.partition_keyframes(W, valid, 5 if K % 5 else 7)


@pytest.mark.parametrize("layout", [(2, 2), (1, 4), (4, 1), (3, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pad_problem_matches_reference(layout):
    jm, tm = _layout_mesh(layout)
    jp, tp, _ = TL.make_problem(0, C=5, M=63, Lw=70)
    ref, out = jsba.pad_problem(jp, jm), tsba.pad_problem(tp, tm)
    for name in ref._fields:
        np.testing.assert_array_equal(P.n(getattr(out, name)),
                                      np.asarray(getattr(ref, name)), name)
    assert out.e_cam.shape[0] % tm.size == 0
    assert out.points.shape[0] % layout[1] == 0


@pytest.mark.parametrize("layout", [(3, 1), (1, 3), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pad_map_for_mesh_matches_reference(noisy_map, layout):
    cfg, mj, mt = noisy_map
    jm, tm = _layout_mesh(layout)
    ref, out = jsgba.pad_map_for_mesh(mj, jm), tsgba.pad_map_for_mesh(mt, tm)
    L = mt.lm_pos.shape[0]
    obs = ("lm_obs_kf", "lm_obs_feat", "lm_obs_ptr")
    P.assert_maps_equal(out, ref, atol=0, skip=obs)
    # the reference leaves the observer index at L rows; the port pads it
    # with empty entries
    L2 = out.lm_pos.shape[0]
    for name, fill in zip(obs, (-1, 0, 0)):
        x = P.n(getattr(out, name))
        assert x.shape[0] == L2
        np.testing.assert_array_equal(x[:L], P.n(getattr(mt, name)))
        assert (x[L:] == fill).all()


def test_permute_kf_rows_and_covisibility_match_reference(noisy_map):
    cfg, mj, mt = noisy_map
    K = mt.kf_T_cw.shape[0]
    perm = np.random.default_rng(0).permutation(K).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(K, dtype=np.int32)
    P.assert_maps_equal(tpart.permute_kf_rows(mt, perm),
                        jpart.permute_kf_rows(mj, perm), atol=0)
    back = tpart.permute_kf_rows(tpart.permute_kf_rows(mt, perm), inv)
    for f in tpart._KF_FIELDS:
        assert torch.equal(getattr(back, f), getattr(mt, f)), f
    np.testing.assert_array_equal(tpart.covisibility_weights(mt),
                                  jpart.covisibility_weights(mj))


def test_mesh_collectives_on_one_rank(one_rank):
    mesh = tmesh.make_mesh(1)
    assert mesh.shape == {"dp": 1, "lm": 1} and mesh.size == 1
    assert mesh.axis_index("dp") == mesh.axis_index("lm") == 0
    assert mesh.axis_index(("dp", "lm")) == 0
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    for axes in ("dp", "lm", ("dp", "lm")):
        assert torch.equal(mesh.psum(x, axes), x)
        assert torch.equal(mesh.psum(x[0, 0, 0], axes), x[0, 0, 0])
        for dim in (0, 1, 2):
            assert torch.equal(mesh.psum_scatter(x, axes, dim), x)
            assert torch.equal(mesh.all_gather(x, axes, dim), x)
    with pytest.raises(ValueError, match="axes"):
        mesh.psum(x, ("lm", "dp"))
    with pytest.raises(ValueError, match="world of 1"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="mesh 2x1"):
        tmesh.make_mesh(1, dp=2, lm=1)
    _, tp, _ = TL.make_problem(0, C=5, M=63, Lw=70)
    assert all(torch.equal(a, b)
               for a, b in zip(launch.shard_problem(tp, mesh), tp))


def test_post_loop_gba_sharded_gn_cg_matches_reference():
    """The session's config-5 path, both packages on the same drifted
    looped map: two covisibility-placed sharded GN-CG steps at lam 0.3."""
    cfg, pcfg, mt, mj, *_ = P.looped(seed=1234)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, post_gba_method="sharded_gn_cg"))
    pcfg = P.port_config(cfg)
    out_j = jlc.LoopClosing(cfg, train_after_kfs=4)._post_loop_gba(mj)
    assert not dist.is_initialized()
    try:
        lt = tlc.LoopClosing(pcfg, "cpu", train_after_kfs=4)
        out_t = lt._post_loop_gba(mt)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert lt._mesh.shape == {"dp": 1, "lm": 1}
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(P.n(out_t.kf_T_cw), np.asarray(out_j.kf_T_cw),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(P.n(out_t.lm_pos), np.asarray(out_j.lm_pos),
                               rtol=0, atol=2e-3)
    before = float(tgba.map_chi2(mt, pcfg.camera, pcfg.ba))
    after = float(tgba.map_chi2(out_t, pcfg.camera, pcfg.ba))
    assert after < 0.5 * before, (before, after)
    # only the poses and points move
    P.assert_maps_equal(out_t, mt, atol=0, skip=("kf_T_cw", "lm_pos"))

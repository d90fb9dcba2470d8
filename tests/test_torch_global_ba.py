"""Parity of the port's whole-map solvers with the JAX package's, on the CPU,
on the hand-built looped map (20 keyframes, drifted poses) at small_config:
`ops/global_ba.py` (`map_chi2`, `ba_sweep`, `gn_cg_step` with and without the
chain regularizer, `global_ba`) and `ops/pose_graph.py` (`optimize`,
`total_error`).

Tolerances: chi2 and graph errors relative 1e-3; keyframe poses 1e-4 and
landmark positions 1e-3 after one step, 5e-4 / 2e-3 after several (the port's
scatter-adds sum in another order, and the CG amplifies it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu_torch.utils import se3 as tse3
from aslam_tpu.models import loopclosing as jlc
from aslam_tpu.ops import global_ba as jgba
from aslam_tpu.ops import lba as jlba
from aslam_tpu.ops import pose_graph as jpg
from aslam_tpu_torch import convert
from aslam_tpu_torch.models import loopclosing as tlc
from aslam_tpu_torch.ops import global_ba as tgba
from aslam_tpu_torch.ops import lba as tlba
from aslam_tpu_torch.ops import pose_graph as tpg


@pytest.fixture(scope="module")
def maps():
    cfg, pcfg, mt, mj, T_true, T_est, drift = P.looped()
    # a map that is off its optimum in the points too
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(0, 0.01, mt.lm_pos.shape)
                             .astype(np.float32))
    mt = mt._replace(lm_pos=mt.lm_pos + noise * mt.lm_valid[:, None])
    return cfg, pcfg, mt, P.ref_map(mt)


def _assert_close(mt, mj, atol_T, atol_p):
    np.testing.assert_allclose(P.n(mt.kf_T_cw), np.asarray(mj.kf_T_cw),
                               atol=atol_T)
    np.testing.assert_allclose(P.n(mt.lm_pos), np.asarray(mj.lm_pos),
                               atol=atol_p)


def _assert_stats(st, sj):
    np.testing.assert_allclose(float(st.chi2), float(sj.chi2), rtol=1e-3)
    assert int(st.n_edges) == int(sj.n_edges) > 1000


def test_map_chi2_matches_reference(maps):
    cfg, pcfg, mt, mj = maps
    c_j = float(jgba.map_chi2(mj, cfg.camera, cfg.ba))
    c_t = float(tgba.map_chi2(mt, pcfg.camera, pcfg.ba))
    assert c_j > 0
    np.testing.assert_allclose(c_t, c_j, rtol=1e-3)


@pytest.mark.parametrize("robust", [True, False])
def test_ba_sweep_matches_reference(maps, robust):
    cfg, pcfg, mt, mj = maps
    m_j, s_j = jgba.ba_sweep(mj, cfg.camera, cfg.ba, robust=robust)
    m_t, s_t = tgba.ba_sweep(mt, pcfg.camera, pcfg.ba, robust=robust)
    _assert_stats(s_t, s_j)
    _assert_close(m_t, m_j, 1e-4, 1e-3)
    # the gauge anchor (oldest keyframe) does not move
    assert torch.equal(m_t.kf_T_cw[0], mt.kf_T_cw[0])


@pytest.mark.parametrize("with_chain", [False, True])
def test_gn_cg_step_matches_reference(maps, with_chain):
    cfg, pcfg, mt, mj = maps
    ch_j = ch_t = None
    if with_chain:
        w = cfg.ba.chain_prior_weight
        ch_j = jlba.map_chain(mj.kf_T_cw, mj.kf_valid, mj.kf_id, w)
        ch_t = tlba.map_chain(mt.kf_T_cw, mt.kf_valid, mt.kf_id, w)
    K = mj.kf_valid.shape[0]
    m_j, s_j = jgba.gn_cg_step(mj, cfg.camera, cfg.ba, kf_chunk=K, chain=ch_j)
    m_t, s_t = tgba.gn_cg_step(mt, pcfg.camera, pcfg.ba, chain=ch_t)
    _assert_stats(s_t, s_j)
    _assert_close(m_t, m_j, 1e-4, 1e-3)
    before = float(tgba.map_chi2(mt, pcfg.camera, pcfg.ba))
    assert float(s_t.chi2) < before


@pytest.mark.parametrize("method", ["sweep", "gn_cg"])
def test_global_ba_matches_reference(maps, method):
    cfg, pcfg, mt, mj = maps
    m_j, s_j = jgba.global_ba(mj, cfg.camera, cfg.ba, iters=3, robust_iters=2,
                              method=method)
    m_t, s_t = tgba.global_ba(mt, pcfg.camera, pcfg.ba, iters=3,
                              robust_iters=2, method=method)
    _assert_stats(s_t, s_j)
    _assert_close(m_t, m_j, 5e-4, 2e-3)


def test_global_ba_rejects_what_it_cannot_do(maps):
    cfg, pcfg, mt, mj = maps
    ch = tlba.map_chain(mt.kf_T_cw, mt.kf_valid, mt.kf_id, 1.0)
    with pytest.raises(ValueError, match="gn_cg"):
        tgba.global_ba(mt, pcfg.camera, pcfg.ba, method="sweep", chain=ch)
    with pytest.raises(ValueError, match="sharded_gn_cg"):
        tgba.global_ba(mt, pcfg.camera, pcfg.ba, method="sharded_gn_cg")


def test_pose_graph_optimize_matches_reference(maps):
    """The loop edge 19 -> 0 with the true relative pose pulls the drifted
    chain back; same graph on both sides (build_pose_graph, carried)."""
    cfg, pcfg, mt, mj = maps
    T_qc = np.eye(4, dtype=np.float32)          # KF 19 sits on KF 0 in truth
    pg_j = jlc.build_pose_graph(mj, jnp.int32(19), jnp.int32(0),
                                jnp.asarray(T_qc), cfg,
                                loop_inliers=jnp.int32(60))
    pg_t = tlc.build_pose_graph(mt, 19, 0, P.t(T_qc), pcfg, loop_inliers=60)
    carried = convert.pose_graph(P.tree_np(pg_j), "cpu")
    for name in ("node_valid", "node_fixed", "e_i", "e_j"):
        assert torch.equal(getattr(pg_t, name), getattr(carried, name)), name
    np.testing.assert_allclose(P.n(pg_t.e_w), np.asarray(pg_j.e_w), atol=1e-6)
    np.testing.assert_allclose(P.n(pg_t.e_meas), np.asarray(pg_j.e_meas),
                               atol=1e-6)

    e0_j, e0_t = float(jpg.total_error(pg_j)), float(tpg.total_error(pg_t))
    np.testing.assert_allclose(e0_t, e0_j, rtol=1e-3)
    out_j = jpg.optimize(pg_j, iters=cfg.loop.pose_graph_iters)
    out_t = tpg.optimize(pg_t, iters=pcfg.loop.pose_graph_iters)
    np.testing.assert_allclose(P.n(out_t.T), np.asarray(out_j.T), atol=1e-4)
    e1_j, e1_t = float(jpg.total_error(out_j)), float(tpg.total_error(out_t))
    assert e1_t < 0.8 * e0_t
    np.testing.assert_allclose(e1_t, e1_j, rtol=1e-3, atol=1e-7)
    # fixed and invalid nodes stay where they were
    still = P.n(pg_t.node_fixed | ~pg_t.node_valid)
    np.testing.assert_array_equal(P.n(out_t.T)[still], P.n(pg_t.T)[still])
    assert still[0] and not still[19]


def _chain_graph(rng, n=12):
    """A drifted odometry chain closed by one strong loop edge
    (tests/test_pose_graph.py::test_cg_matches_dense)."""
    xi = np.concatenate([rng.normal(0, 0.1, (n, 3)) + [0.3, 0, 0],
                         rng.normal(0, 0.05, (n, 3))], -1).astype(np.float32)
    step = P.n(tse3.se3_exp(P.t(xi)))
    T_gt = [np.eye(4, dtype=np.float32)]
    for k in range(1, n):
        T_gt.append(step[k] @ T_gt[-1])
    T_gt = np.stack(T_gt)
    drift = P.n(tse3.se3_exp(P.t(
        (rng.normal(0, 0.01, (n, 6))).astype(np.float32))))
    T_est = [T_gt[0]]
    for k in range(1, n):
        T_est.append(drift[k] @ T_gt[k] @ np.linalg.inv(T_gt[k - 1]) @ T_est[-1])
    T_est = np.stack(T_est).astype(np.float32)
    e_i = np.arange(1, n, dtype=np.int32)
    e_j = np.arange(0, n - 1, dtype=np.int32)
    meas = np.stack([T_est[i] @ np.linalg.inv(T_est[j])
                     for i, j in zip(e_i, e_j)])
    e_i = np.concatenate([e_i, [n - 1]]).astype(np.int32)
    e_j = np.concatenate([e_j, [0]]).astype(np.int32)
    meas = np.concatenate([meas, (T_gt[-1] @ np.linalg.inv(T_gt[0]))[None]]) \
        .astype(np.float32)
    w = np.ones(n, np.float32)
    w[-1] = 10.0
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return dict(T=T_est, node_valid=np.ones(n, bool), node_fixed=fixed,
                e_i=e_i, e_j=e_j, e_meas=meas, e_w=w)


def test_pose_graph_optimize_cg_matches_reference_and_dense():
    """The matrix-free solver loop closing takes above 256 keyframes: equal
    to the reference's `optimize_cg` on the same graph, and to the port's
    dense solver as tests/test_pose_graph.py:109 holds the reference's."""
    g = _chain_graph(np.random.default_rng(3))
    pg_j = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()})
    pg_t = tpg.PoseGraph(**{k: P.t(v) for k, v in g.items()})
    cg_j = jpg.optimize_cg(pg_j, iters=15, cg_iters=100)
    cg_t = tpg.optimize_cg(pg_t, iters=15, cg_iters=100)
    np.testing.assert_allclose(P.n(cg_t.T), np.asarray(cg_j.T), atol=1e-4)
    dense = tpg.optimize(pg_t, iters=15)
    e0, e_cg, e_dense = (float(tpg.total_error(x)) for x in (pg_t, cg_t, dense))
    assert e_cg < 0.2 * e0
    assert e_cg < 1.5 * e_dense + 1e-5
    np.testing.assert_allclose(P.n(cg_t.T), P.n(dense.T), atol=5e-3)
    np.testing.assert_array_equal(P.n(cg_t.T[0]), g["T"][0])    # the gauge


@pytest.mark.parametrize("robust", [True, False])
def test_ba_sweep_chunked_matches_dense(maps, robust):
    """`ba_sweep_chunked` over 4 keyframe chunks against the port's dense
    `ba_sweep` to 1e-5 (the reference's own bound), and against the
    reference's chunked sweep."""
    cfg, pcfg, mt, mj = maps
    K = mt.kf_T_cw.shape[0]
    dense, s1 = tgba.ba_sweep(mt, pcfg.camera, pcfg.ba, robust=robust)
    chunked, s2 = tgba.ba_sweep_chunked(mt, pcfg.camera, pcfg.ba,
                                        robust=robust, kf_chunk=K // 4)
    np.testing.assert_allclose(P.n(chunked.kf_T_cw), P.n(dense.kf_T_cw),
                               atol=1e-5)
    np.testing.assert_allclose(P.n(chunked.lm_pos), P.n(dense.lm_pos),
                               atol=1e-5)
    assert int(s1.n_edges) == int(s2.n_edges)
    np.testing.assert_allclose(float(s2.chi2), float(s1.chi2), rtol=1e-4)
    m_j, s_j = jgba.ba_sweep_chunked(mj, cfg.camera, cfg.ba, robust=robust,
                                     kf_chunk=K // 4)
    _assert_stats(s2, s_j)
    _assert_close(chunked, m_j, 1e-4, 1e-3)
    with pytest.raises(ValueError):
        tgba.ba_sweep_chunked(mt, pcfg.camera, pcfg.ba, kf_chunk=K // 4 + 1)


def test_ordered_scatter_add_equals_index_add(maps):
    """The ordered scatter-add the point sweep takes on the card
    (`ops/index.py::_sorted_add`), run here on the CPU on the map's real
    landmark blocks, against `index_add_`: equal to 1e-6 relative."""
    from aslam_tpu_torch.ops.index import _sorted_add

    cfg, pcfg, mt, mj = maps
    r, _, Jp, w, _, active, lm = tgba._edge_terms(mt, pcfg.camera, pcfg.ba,
                                                  True)
    wJp = w[..., None, None] * Jp
    blocks = torch.einsum("kmri,kmrj->kmij", wJp, Jp).reshape(-1, 9)
    L = mt.lm_pos.shape[0]
    ref = torch.zeros(L, 9).index_add_(0, lm.reshape(-1), blocks)
    # the inactive edges (padding at landmark 0 among them) left out, as the
    # sweeps pass them: the same sums, they weigh 0
    out = _sorted_add(torch.zeros(L, 9), lm.reshape(-1), blocks,
                      active.reshape(-1))
    assert int((~active).sum()) > 1000
    scale = P.n(ref).__abs__().max(axis=1, keepdims=True)
    assert np.all(np.abs(P.n(out) - P.n(ref)) <= 1e-6 * scale + 1e-30)

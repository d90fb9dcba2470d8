"""Parity of the port's local BA (`aslam_tpu_torch/ops/lba.py`) with the JAX
package's on seeded multi-view problems in the camera-grouped layout that
local mapping builds (edge e belongs to camera e // M).

Tolerances: edge terms 1e-5 relative (see TOL for the residual-derived
ones); `assemble_grouped` against the JAX
one and against the port's own ungrouped `assemble` at rtol 1e-4 (the
reference's one-hot matmul and the port's `index_add_` sum in different
orders); a full `local_ba` to 1e-3 in poses and points, with the pruned
`e_valid` mask equal except for edges whose chi2 lies within 1e-3 relative
of its threshold at the pruning step."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import BAConfig, CameraModel
from aslam_tpu.ops import lba as jlba
from aslam_tpu_torch import config as tconfig
from aslam_tpu_torch.ops import lba as tlba
from aslam_tpu_torch.utils.synthetic import _np_se3_exp

CAM = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320,
                  height=240)
CFG = BAConfig(local_iters_1=3, local_iters_2=5)
TCAM = tconfig.CameraModel(**dataclasses.asdict(CAM))
TCFG = tconfig.BAConfig(**dataclasses.asdict(CFG))


def make_problem(seed, C=6, M=96, Lw=128, n_fixed=1, outlier_frac=0.05):
    """C cameras on a short arc, each observing the M points (edge
    c*M + m -> point m), some edges invalid or mono, a few outliers, noisy
    initial poses and points; the first n_fixed cameras are the gauge.
    Cameras 0 and 1 see every point in stereo without outliers, so each
    point stays well constrained (a point left with one stereo edge moves
    by millimetres under float32 reordering alone)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M),
                    rng.uniform(2.0, 4.0, M)], -1).astype(np.float32)
    T_true = np.stack([_np_se3_exp(np.concatenate(
        [[0.15 * c, 0.01 * c, 0.0], rng.normal(0, 0.02, 3)])) for c in range(C)])
    uv, ur, z = [], [], []
    for c in range(C):
        pc = pts @ T_true[c, :3, :3].T + T_true[c, :3, 3]
        u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx + rng.normal(0, 0.3, M)
        v = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy + rng.normal(0, 0.3, M)
        mono = (rng.random(M) < 0.2) & (c >= 2)
        uv.append(np.stack([u, v], -1))
        ur.append(np.where(mono, -1.0, u - CAM.bf / pc[:, 2]))
        z.append(np.where(mono, 0.0, pc[:, 2]))
    E = C * M
    e_uv = np.concatenate(uv).astype(np.float32)
    out = (rng.random(E) < outlier_frac) & (np.arange(E) >= 2 * M)
    e_uv[out] += rng.uniform(10, 30, (out.sum(), 2)).astype(np.float32)
    cam_T = T_true.copy()
    for c in range(n_fixed, C):
        cam_T[c] = _np_se3_exp(rng.normal(0, 0.02, 6)) @ T_true[c]
    points = np.zeros((Lw, 3), np.float32)
    points[:M] = pts + rng.normal(0, 0.02, pts.shape)
    prob = dict(
        cam_T=cam_T.astype(np.float32),
        cam_fixed=np.arange(C) < n_fixed,
        cam_valid=np.ones(C, bool),
        points=points,
        point_valid=np.arange(Lw) < M,
        e_cam=np.repeat(np.arange(C), M).astype(np.int32),
        e_lm=np.tile(np.arange(M), C).astype(np.int32),
        e_uv=e_uv,
        e_ur=np.concatenate(ur).astype(np.float32),
        e_z=np.concatenate(z).astype(np.float32),
        e_valid=(rng.random(E) > 0.1) | (np.arange(E) < 2 * M),
    )
    return (jlba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()}),
            tlba.BAProblem(**{k: torch.from_numpy(np.asarray(v))
                              for k, v in prob.items()}), M)


def make_chain(C):
    """Consecutive-camera chain edges with one inactive edge."""
    c_i, c_j = np.arange(C - 1), np.arange(1, C)
    w = np.full(C - 1, 2.5e5, np.float32)
    w[1] = 0.0
    return c_i, c_j, w


def _chains(prob_j, prob_t):
    C = prob_j.cam_T.shape[0]
    c_i, c_j, w = make_chain(C)
    T = np.asarray(prob_j.cam_T)
    meas = np.stack([T[i] @ np.linalg.inv(T[j]) for i, j in zip(c_i, c_j)])
    meas = (meas @ _np_se3_exp(np.full(6, 1e-3))).astype(np.float32)
    cj = jlba.ChainSpec(*(jnp.asarray(a) for a in (c_i, c_j, meas, w)))
    ct = tlba.ChainSpec(*(torch.from_numpy(np.asarray(a))
                          for a in (c_i, c_j, meas, w)))
    return cj, ct


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(P.n(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


# (rtol, atol) per edge term: residuals are differences of pixel
# coordinates of a few hundred, which carry float32 ulps of 3e-5, and chi2
# and the Huber weights square them
TOL = {"r": (1e-5, 1e-4), "Jc": (1e-5, 1e-5), "Jp": (1e-5, 1e-5),
       "w": (1e-4, 1e-6), "chi2": (1e-4, 1e-5)}


@pytest.mark.parametrize("robust", [True, False])
def test_edge_terms_match_reference(robust):
    pj, pt, M = make_problem(0)
    ref = jlba.edge_terms(pj, CAM, CFG, robust)
    out = tlba.edge_terms(pt, TCAM, TCFG, robust)
    refg = jlba.edge_terms_grouped(pj, CAM, CFG, robust, M)
    outg = tlba.edge_terms_grouped(pt, TCAM, TCFG, robust, M)
    for name, a, b, ag, bg in zip(("r", "Jc", "Jp", "w", "chi2", "active"),
                                  out, ref, outg, refg):
        if name == "active":
            np.testing.assert_array_equal(P.n(a), np.asarray(b))
            np.testing.assert_array_equal(P.n(ag), np.asarray(bg))
        else:
            rtol, atol = TOL[name]
            _close(a, b, rtol, atol, name)
            _close(ag, bg, rtol, atol, name)
            _close(ag.reshape(a.shape), P.n(a), rtol, atol, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_grouped_matches_reference_and_ungrouped(seed):
    pj, pt, M = make_problem(seed)
    ref = jlba.assemble_grouped(pj, CAM, CFG, True, M)
    out = tlba.assemble_grouped(pt, TCAM, TCFG, True, M)
    scatter = tlba.assemble(pt, TCAM, TCFG, True)
    ref_scatter = jlba.assemble(pj, CAM, CFG, True)
    for name, a, b, s, rs in zip(("Hcc", "bc", "Hll", "bl", "W", "chi2"),
                                 out, ref, scatter, ref_scatter):
        scale = float(np.abs(np.asarray(b)).max())
        _close(a, b, 1e-4, 1e-6 * scale, name)
        _close(s, P.n(a), 1e-4, 1e-6 * scale, name)
        _close(s, rs, 1e-4, 1e-6 * scale, name)
    assert float(np.abs(np.asarray(ref[4])).max()) > 0


def test_chain_terms_and_map_chain_match_reference():
    pj, pt, _ = make_problem(2)
    cj, ct = _chains(pj, pt)
    for name, a, b in zip(("H", "b", "chi2"), tlba.chain_terms(pt.cam_T, ct),
                          jlba.chain_terms(pj.cam_T, cj)):
        _close(a, b, 1e-4, 1e-2, name)
    K = 8
    T = np.stack([_np_se3_exp(np.full(6, 0.01 * k)) for k in range(K)])
    valid = np.array([1, 1, 0, 1, 0, 1, 1, 1], bool)
    kf_id = np.array([5, 0, 9, 3, -1, 7, 1, 2], np.int32)
    ref = jlba.map_chain(jnp.asarray(T), jnp.asarray(valid),
                         jnp.asarray(kf_id), 3.0)
    out = tlba.map_chain(torch.from_numpy(T), torch.from_numpy(valid),
                         torch.from_numpy(kf_id), 3.0)
    for a, b in zip(out, ref):
        _close(a, b, 1e-6, 1e-6)


def test_schur_solve_and_apply_update_match_reference():
    pj, pt, M = make_problem(3, n_fixed=2)
    cj, ct = _chains(pj, pt)
    Hj = jlba.assemble_grouped(pj, CAM, CFG, True, M)[:5]
    Hch, bch, _ = jlba.chain_terms(pj.cam_T, cj)
    lam = 1e-3
    dxc_j, dxl_j = jlba.schur_solve(*Hj, pj.cam_fixed, pj.point_valid, lam,
                                    H_chain=Hch, b_chain=bch)
    dxc_t, dxl_t = tlba.schur_solve(
        *(P.t(x) for x in Hj), pt.cam_fixed, pt.point_valid,
        torch.tensor(lam), H_chain=P.t(Hch), b_chain=P.t(bch))
    _close(dxc_t, dxc_j, 1e-3, 1e-6, "dxc")
    _close(dxl_t, dxl_j, 1e-3, 1e-6, "dxl")
    assert (P.n(dxc_t)[:2] == 0).all() and np.abs(P.n(dxc_t)[2:]).max() > 1e-4
    upd_j = jlba.apply_update(pj, dxc_j, dxl_j)
    upd_t = tlba.apply_update(pt, P.t(dxc_j), P.t(dxl_j))
    _close(upd_t.cam_T, upd_j.cam_T, 1e-6, 1e-6)
    _close(upd_t.points, upd_j.points, 1e-6, 1e-6)


@pytest.mark.parametrize("grouped,chain", [(True, True), (True, False),
                                           (False, False)])
def test_local_ba_matches_reference(grouped, chain):
    pj, pt, M = make_problem(4)
    cj, ct = _chains(pj, pt) if chain else (None, None)
    group = M if grouped else None
    runs = tlba.local_ba.runs
    ref, ref_stats = jlba.local_ba(pj, CAM, CFG, chain=cj, group=group)
    out, out_stats = tlba.local_ba(pt, TCAM, TCFG, chain=ct, group=group)
    assert tlba.local_ba.runs == runs + 1
    _close(out.cam_T, ref.cam_T, 0, 1e-3, "cam_T")
    _close(out.points, ref.points, 0, 1e-3, "points")
    assert np.abs(np.asarray(ref.cam_T) - np.asarray(pj.cam_T)).max() > 1e-3

    # the pruning decision, edge by edge, away from its threshold
    mid = jlba.ba_iterate(pj, CAM, CFG, CFG.local_iters_1, robust=True,
                          chain=cj, group=group)
    chi2 = np.asarray(jlba.edge_terms(mid, CAM, CFG, robust=False)[4])
    th = np.where(np.asarray(pj.e_ur) >= 0, CFG.chi2_stereo, CFG.chi2_mono)
    near = np.abs(chi2 - th) <= 1e-3 * th
    ev_t, ev_j = P.n(out.e_valid), np.asarray(ref.e_valid)
    np.testing.assert_array_equal(ev_t[~near], ev_j[~near])
    assert (~ev_j & np.asarray(pj.e_valid)).sum() > 0      # some were pruned
    assert int(out_stats.n_edges) == int(ref_stats.n_edges) or near.any()
    np.testing.assert_allclose(float(out_stats.chi2), float(ref_stats.chi2),
                               rtol=1e-3)


@pytest.mark.parametrize("width,targets", [((6, 6), 8), ((18,), 8 * 128),
                                           ((9,), 128), ((3,), 128)])
def test_ordered_scatter_add_equals_index_add(width, targets):
    """The ordered scatter-add the local BA's assembly takes on the card
    (`ops/index.py::_sorted_add`), run here on the CPU, against the CPU's
    `index_add_`, at the grouped layout's shapes (6 cameras x 96 edges):
    equal to 1e-6 relative."""
    from aslam_tpu_torch.ops.index import _sorted_add, index_add_ordered

    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, targets, (6 * 96,), generator=g)
    src = torch.randn((6 * 96,) + width, generator=g) * 1e3
    ref = torch.zeros((targets,) + width).index_add_(0, idx, src)
    out = _sorted_add(torch.zeros((targets,) + width), idx, src)
    np.testing.assert_allclose(P.n(out), P.n(ref), rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))
    # on the CPU the helper is index_add_ itself
    assert torch.equal(index_add_ordered(torch.zeros((targets,) + width), idx,
                                         src), ref)
    # masked rows, all pointing at row 0 as padded edges do, are left out
    valid = torch.rand(len(idx), generator=g) > 0.5
    idx_m = torch.where(valid, idx, 0)
    ref = torch.zeros((targets,) + width).index_add_(0, idx[valid], src[valid])
    out = _sorted_add(torch.zeros((targets,) + width), idx_m, src, valid)
    np.testing.assert_allclose(P.n(out), P.n(ref), rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))
    assert torch.equal(index_add_ordered(torch.zeros((targets,) + width),
                                         idx_m, src, valid), ref)

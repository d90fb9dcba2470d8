"""Parity of the port's sharded solvers (`aslam_tpu_torch/parallel/`) across
real process boundaries: one job of 4 CPU ranks on a gloo process group
(`tests/_torch_parallel_worker.py`) runs each solver on the layouts 1x4,
2x2 and 4x1, and each result is held to the JAX package's sharded function
on a virtual mesh of the same layout (conftest's 8 CPU devices) and to the
port's single-device solver, on the same seeded inputs.

Tolerances are the reference's own (tests/test_sharded_ba.py,
tests/test_sharded_global_ba.py): local BA 1e-3 on poses and points,
n_edges exact, chi2 rtol 0.05; the global solvers 2e-3.  The local BA is
held to the JAX sharded function on a problem with outliers, mono and
invalid edges (`test_torch_lba.make_problem`), and to the single-device
`local_ba` on the reference's own sharded-test problem
(`test_lba.make_ba_problem`, no outliers): the sharded schedule takes every
step at a fixed lam where `local_ba` is a monotone LM, so with outliers the
two prune different edges (289 against 287 on the first problem, in the
JAX package as in the port) and settle 1.1e-3 apart.  The dry run's two
problems must start at the reference's chi2 (370.329, 340.829, relative
1e-3) and agree with one device to 1e-3.  The job starts when the module's
fixture is set up, runs while the JAX side compiles, and is killed after
240 s.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import _torch_parallel_worker as W
import _torch_parity as P
import test_torch_lba as TL
from aslam_tpu.ops import global_ba as jgba
from aslam_tpu.parallel import mesh as jmesh
from aslam_tpu.parallel import partition as jpart
from aslam_tpu.parallel import sharded_ba as jsba
from aslam_tpu.parallel import sharded_global_ba as jsgba
from aslam_tpu.parallel import sharded_gn_cg as jsgc
from aslam_tpu_torch.ops import global_ba as tgba
from aslam_tpu_torch.ops import lba as tlba
from tests.test_global_ba import build_noisy_map
from tests.test_lba import CAM as LBA_CAM
from tests.test_lba import CFG as LBA_CFG
from tests.test_lba import make_ba_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LAYOUTS = W.layouts(WORLD)
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankJob:
    """WORLD worker processes started at once; `result()` waits for them
    (up to TIMEOUT_S from the start, then kills every rank) and loads rank
    0's npz."""

    def __init__(self, tmp, inputs):
        self.out = str(tmp / "out.npz")
        self.logs = [tmp / f"rank{r}.log" for r in range(WORLD)]
        env = dict(os.environ, PYTHONPATH=REPO)
        port = _free_port()
        self.t0 = time.monotonic()
        self.procs = []
        for r in range(WORLD):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(REPO, "tests",
                                                  "_torch_parallel_worker.py"),
                     str(r), str(WORLD), str(port), inputs, self.out],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        self._res = None

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def _logs(self):
        return "\n---\n".join(f.read_text()[-3000:] for f in self.logs)

    def result(self):
        if self._res is None:
            try:
                for p in self.procs:
                    p.wait(max(TIMEOUT_S - (time.monotonic() - self.t0), 1))
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"ranks timed out after {TIMEOUT_S} s:\n"
                            + self._logs())
            codes = [p.returncode for p in self.procs]
            if any(codes):
                pytest.fail(f"ranks exited {codes}:\n" + self._logs())
            self._res = dict(np.load(self.out))
        return self._res


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_ranks")
    jp, _, _ = TL.make_problem(3, C=5, M=63, Lw=70)
    ref = make_ba_problem(np.random.default_rng(42), n_cams=5, n_pts=64)[0]
    cfg, mj, *_ = build_noisy_map(np.random.default_rng(42), n_kfs=8,
                                  n_pts=128)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **{f"{name}_{k}": np.asarray(v)
                        for name, x in (("lba", jp), ("ref", ref),
                                        ("map", mj))
                        for k, v in x._asdict().items()})
    rj = RankJob(tmp, inputs)
    yield dict(jp=jp, ref=ref, cfg=cfg, mj=mj, mt=P.port_map(mj), rj=rj)
    rj.kill()


@pytest.fixture(scope="module")
def single(job):
    """The port's single-device solvers on the same inputs."""
    pcfg = P.port_config(job["cfg"])
    ref = tlba.BAProblem(*(P.t(x) for x in job["ref"]))
    lba_out = tlba.local_ba(ref, W.LBA_CAM, W.LBA_CFG)
    m = job["mt"]
    for i in range(W.GBA["iters"]):
        m, _ = tgba.ba_sweep(m, pcfg.camera, pcfg.ba,
                             robust=i < W.GBA["robust_iters"])
    gn = tgba.gn_cg_step(job["mt"], pcfg.camera, pcfg.ba, **W.CG)
    return dict(lba=lba_out, gba=m, gncg=gn)


def _tag(layout):
    return f"{layout[0]}x{layout[1]}"


def _mesh(layout):
    return jmesh.make_mesh(WORLD, dp=layout[0], lm=layout[1])


def _close(a, b, atol, msg):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol, err_msg=msg)


def _map_close(r, name, m, n_kfs, n_pts, atol):
    _close(r[f"{name}_kf_T_cw"][:n_kfs], P.n(m.kf_T_cw)[:n_kfs], atol,
           name + " poses")
    _close(r[f"{name}_lm_pos"][:n_pts], P.n(m.lm_pos)[:n_pts], atol,
           name + " points")


def _stats_close(r, name, stats):
    assert int(r[f"{name}_n_edges"]) == int(stats.n_edges) > 0
    assert np.isclose(float(r[f"{name}_chi2"]), float(stats.chi2), rtol=0.05)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_sharded_local_ba_matches_reference(job, layout):
    mesh = _mesh(layout)
    jp = job["jp"]
    E, L = jp.e_cam.shape[0], jp.points.shape[0]
    out, chi2, n_edges = jsba.sharded_local_ba(
        jsba.pad_problem(jp, mesh), LBA_CAM, LBA_CFG, mesh)
    r = job["rj"].result()
    t = f"{_tag(layout)}_lba"
    _close(r[f"{t}_cam_T"], P.n(out.cam_T), 1e-3, "cam_T")
    _close(r[f"{t}_points"], P.n(out.points)[:L], 1e-3, "points")
    assert int(r[f"{t}_n_edges"]) == int(n_edges) > E // 2
    assert np.isclose(float(r[f"{t}_chi2"]), float(chi2), rtol=0.05)
    # the pruned edge mask, all-gathered, is the reference's
    np.testing.assert_array_equal(r[f"{t}_e_valid"],
                                  np.asarray(out.e_valid)[:E])
    assert r[f"{t}_same_bits"], "a second run differs"


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_sharded_local_ba_matches_one_device(job, single, layout):
    ref_out, stats = single["lba"]
    r = job["rj"].result()
    t = f"{_tag(layout)}_ref"
    _close(r[f"{t}_cam_T"], P.n(ref_out.cam_T), 1e-3, "cam_T")
    _close(r[f"{t}_points"], P.n(ref_out.points), 1e-3, "points")
    assert int(r[f"{t}_n_edges"]) == int(stats.n_edges) > 0
    assert np.isclose(float(r[f"{t}_chi2"]), float(stats.chi2), rtol=0.05)
    assert r[f"{t}_same_bits"], "a second run differs"


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_sharded_global_ba_matches_reference_and_ba_sweep(job, single,
                                                          layout):
    mesh = _mesh(layout)
    cfg = job["cfg"]
    out, chi2 = jsgba.sharded_global_ba(
        jsgba.pad_map_for_mesh(job["mj"], mesh), cfg.camera, cfg.ba, mesh,
        **W.GBA)
    r = job["rj"].result()
    t = _tag(layout)
    _map_close(r, f"{t}_gba", out, 8, 128, 2e-3)
    _map_close(r, f"{t}_gba", single["gba"], 8, 128, 2e-3)
    assert np.isclose(float(r[f"{t}_gba_chi2"]), float(chi2), rtol=0.05)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_sharded_gn_cg_step_matches_reference_and_gn_cg_step(job, single,
                                                             layout):
    mesh = _mesh(layout)
    cfg = job["cfg"]
    out, stats = jsgc.sharded_gn_cg_step(
        jsgba.pad_map_for_mesh(job["mj"], mesh), cfg.camera, cfg.ba, mesh,
        **W.CG)
    r = job["rj"].result()
    t = _tag(layout)
    for m, st in ((out, stats), single["gncg"]):
        _map_close(r, f"{t}_gncg", m, 8, 128, 2e-3)
        _stats_close(r, f"{t}_gncg", st)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_partitioned_gn_cg_step_matches_reference_and_gn_cg_step(
        job, single, layout):
    mesh = _mesh(layout)
    cfg = job["cfg"]
    out, stats = jpart.partitioned_gn_cg_step(job["mj"], cfg.camera, cfg.ba,
                                              mesh, **W.CG)
    r = job["rj"].result()
    t = _tag(layout)
    for m, st in ((out, stats), single["gncg"]):
        _map_close(r, f"{t}_part", m, 8, 128, 2e-3)
        _stats_close(r, f"{t}_part", st)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_partitioned_global_ba_matches_unpartitioned(job, layout):
    """A row permutation changes no math: the placed solve is the plain
    sharded one (tests/test_partition.py's check, across ranks)."""
    r = job["rj"].result()
    t = _tag(layout)
    for f in ("kf_T_cw", "lm_pos"):
        _close(r[f"{t}_pgba_{f}"], r[f"{t}_gba_{f}"], 2e-3, f)
    # and the sweeps lower the input map's chi2 (the JAX package's map_chi2)
    ref = jgba.map_chi2(job["mj"], job["cfg"].camera, job["cfg"].ba)
    assert float(r[f"{t}_pgba_chi2"]) < float(ref)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_dryrun_reproduces_the_reference_lines(job, layout):
    """`MULTICHIP_r05.json`: windowed Schur chi2 370.329 -> 0.000, joint
    GN-CG 340.829 -> 0.064, each within 1e-3 of one device."""
    r = job["rj"].result()
    t = _tag(layout)
    for path, before, after in (("schur", 370.329, 0.0),
                                ("gn_cg", 340.829, 0.064)):
        d = {k: r[f"{t}_dry_{path}_{k}"]
             for k in ("before", "after", "single", "d_T", "d_X")}
        np.testing.assert_allclose(d["before"], before, rtol=1e-3)
        np.testing.assert_allclose(d["after"], after, atol=1e-3)
        assert d["d_T"] < 1e-3 and d["d_X"] < 1e-3, d
    assert int(r[f"{t}_dry_schur_edges"]) == 256
    assert int(r[f"{t}_dry_gn_cg_edges"]) == 512

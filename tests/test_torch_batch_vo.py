"""Parity of the port's batched VO (`aslam_tpu_torch/models/batch_vo.py`)
with the JAX package's and with the port's own single-frame chain, on the
CPU at `small_config()`.

The reference `vmap`s its frame pipeline; the port broadcasts its functions
over a leading [B] axis.  The port's batched odometry is held to the
reference's `BatchVisualOdometry` on the reference's frames, fed the
reference's RANSAC draws (its key recurrence rebuilt per step); the port's
own `BatchVisualOdometry` to the reference's at the trajectory level and,
lane by lane, to B unbatched `track_frame` chains of the port with the same
draws; and `process_chunk` to `process`.  The batched pieces (frames,
the kernel's plain version, scatters, RANSAC, motion-only BA) are each held
to per-lane calls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.models import batch_vo as jbatch
from aslam_tpu.utils import synthetic
from aslam_tpu_torch.models import batch_vo as tbatch
from aslam_tpu_torch.models import odometry as todo
from aslam_tpu_torch.models.extractor import init_grid_thresholds
from aslam_tpu_torch.models.frame import _make_frame_impl, make_frame
from aslam_tpu_torch.ops import ba as tba
from aslam_tpu_torch.ops import fast, matching
from aslam_tpu_torch.ops import ransac as transac
from aslam_tpu_torch.ops.hamming_top2 import hamming_top2, hamming_top2_plain
from aslam_tpu_torch.utils import trajectory

B, F = 3, 4


def _lane(tree, b):
    return jax.tree.map(lambda x: x[b], tree)


def _sequences(seed0, n=B, frames=F):
    """The renders of tests/test_batch_vo.py in the sensor's dtypes -> (imgs
    uint8, depths uint16 [n,F,H,W], poses [n,F,4,4]).  The port's pyramid
    is not bit-identical to the reference's; on the float renders the
    responses of levels > 0 can then reorder the top-M merge of all levels,
    and a lane's match pool differ from the reference's by a few percent,
    so that fed draws pick other matches.  As every VO parity test of the port, the
    frames go in as a sensor gives them."""
    cam = small_config().camera
    seqs = [synthetic.make_sequence(n_frames=frames, n_points=400,
                                    seed=seed0 + b) for b in range(n)]
    return (np.stack([np.clip(s[0], 0, 255).astype(np.uint8) for s in seqs]),
            np.stack([np.clip(s[1] / cam.depth_factor, 0, 65535)
                      .astype(np.uint16) for s in seqs]),
            np.stack([s[2] for s in seqs]))


@pytest.fixture(scope="module")
def runs():
    """The reference's BatchVisualOdometry over B sequences with its frames
    and draws per step; the port's `batch_rba` chained over the reference's
    frames with those draws; and the port's BatchVisualOdometry, extracting
    its own frames, fed the same draws."""
    from aslam_tpu_torch import convert

    cfg = small_config()
    pcfg = P.port_config(cfg)
    imgs, deps, gt = _sequences(10)
    h, w = imgs.shape[2:]
    ref = jbatch.BatchVisualOdometry(cfg, batch=B, seed=0)
    port = tbatch.BatchVisualOdometry(pcfg, B, "cpu")
    draws, n_ref, n_port, on_ref = [], [], [], []
    prev_t = None
    for f in range(F):
        im, de = imgs[:, f], deps[:, f]
        # the step's frames and keys as `process` makes them
        cur, _ = jbatch.batch_frame(jnp.asarray(im), jnp.asarray(de),
                                    ref.grids, cfg, h, w)
        cur_t = convert.frame_data(P.tree_np(cur), "cpu")
        if f:
            _, sub = jax.random.split(ref.key)
            keys = jax.random.split(sub, B)
            d = np.stack([P.ref_draws(_lane(ref.prev, b), _lane(cur, b),
                                      keys[b], cfg) for b in range(B)])
            res_j = jbatch.batch_rba(ref.prev, cur, keys, cfg)
            res_t = tbatch.batch_rba(prev_t, cur_t, None, pcfg, draws=P.t(d))
            on_ref.append((res_j, res_t))
            cur_t = cur_t._replace(T_cw=res_t.T_cw2)
            n_ref.append(np.asarray(res_j.n_matches))
            draws.append(d)
        prev_t = cur_t
        ref.process(im, de)
        port.process(P.t(im), P.t(de), draws=P.t(draws[-1]) if f else None)
        if f:
            n_port.append(P.n(port.last.n_matches))
    return (pcfg, imgs, deps, gt, ref, port, np.stack(draws, 1),
            np.stack(n_ref), np.stack(n_port), on_ref)


def test_batch_rba_on_reference_frames_matches_reference(runs):
    """The port's batched odometry chained over the reference's frames with
    the reference's draws: matches and inliers exactly, poses to 1e-4."""
    *_, ref, port, draws, n_ref, n_port, on_ref = runs
    traj = ref.trajectories()
    for f, (res_j, res_t) in enumerate(on_ref):
        np.testing.assert_array_equal(P.n(res_t.match_idx),
                                      np.asarray(res_j.match_idx))
        np.testing.assert_array_equal(P.n(res_t.n_matches), n_ref[f])
        np.testing.assert_array_equal(P.n(res_t.inliers),
                                      np.asarray(res_j.inliers))
        np.testing.assert_allclose(P.n(res_t.T_cw2), traj[f], rtol=0,
                                   atol=1e-4)
    assert (n_ref >= 30).all()


def test_batch_vo_lanes_track_like_the_reference(runs):
    """The port's BatchVisualOdometry, extracting its own frames, fed the
    reference's draws: every lane's ATE within 1.5x the reference's (or 2
    mm of it, the gate of tests/test_torch_odometry.py), and match counts
    within a tenth of the reference's: its pyramid is a few 1e-4 gray levels
    from the reference's, which can flip near-tied descriptor bits on
    levels > 0 and change a few percent of the matches."""
    _, _, _, gt, ref, port, draws, n_ref, n_port, _ = runs
    assert (np.abs(n_port - n_ref) <= n_ref // 10).all(), (n_port, n_ref)
    for b in range(B):
        ates = []
        for traj in (port.trajectories(), ref.trajectories()):
            poses = np.concatenate([np.eye(4)[None], traj[:, b]])
            ates.append(trajectory.ate_rmse(trajectory.camera_centers(poses),
                                            trajectory.camera_centers(gt[b])))
        assert ates[0] <= max(1.5 * ates[1], ates[1] + 0.002), (b, ates)
    np.testing.assert_allclose(P.n(port.grids), np.asarray(ref.grids),
                               rtol=1e-6)


def test_batch_vo_lanes_equal_unbatched_chains(runs):
    """Each lane against the port's own single-frame chain with the same
    draws: poses to 1e-5, threshold grids and the last frame's features
    exactly."""
    pcfg, imgs, deps, gt, ref, port, draws, *_ = runs
    traj = port.trajectories()
    for b in range(B):
        grid = init_grid_thresholds(pcfg.extractor, "cpu")
        frame, grid = make_frame(P.t(imgs[b, 0]), P.t(deps[b, 0]), pcfg, grid)
        for f in range(1, F):
            frame, grid, res = todo.track_frame(
                frame, P.t(imgs[b, f]), P.t(deps[b, f]), grid, None, pcfg,
                draws=P.t(draws[b, f - 1]))
            np.testing.assert_allclose(P.n(res.T_cw2), traj[f - 1, b],
                                       rtol=0, atol=1e-5)
        assert torch.equal(grid, port.grids[b])
        for name in ("xy", "desc", "valid", "octave"):
            assert torch.equal(getattr(frame.feat, name),
                               getattr(port.prev.feat, name)[b]), name


def test_batch_vo_lanes_reach_the_reference_gate(runs):
    """Every lane's ATE below 0.02, the gate of tests/test_batch_vo.py, on
    both sides."""
    _, _, _, gt, ref, port, *_ = runs
    for name, traj in (("port", port.trajectories()),
                       ("reference", ref.trajectories())):
        for b in range(B):
            poses = np.concatenate([np.eye(4)[None], traj[:, b]])
            ate = trajectory.ate_rmse(trajectory.camera_centers(poses),
                                      trajectory.camera_centers(gt[b]))
            assert ate < 0.02, (name, b, ate)


def test_batch_chunk_equals_streaming_bit_for_bit():
    """process_chunk in two chunks draws what F `process` calls draw from
    the device generator: the same bits (the reference reaches 0.01)."""
    pcfg = P.port_config(small_config())
    imgs, deps, _ = _sequences(20, n=2, frames=5)
    stream = tbatch.BatchVisualOdometry(pcfg, 2, "cpu", seed=1)
    for f in range(5):
        stream.process(imgs[:, f], deps[:, f])
    chunked = tbatch.BatchVisualOdometry(pcfg, 2, "cpu", seed=1)
    chunked.process_chunk(imgs[:, :3], deps[:, :3])
    chunked.process_chunk(imgs[:, 3:], deps[:, 3:])
    assert np.array_equal(chunked.trajectories(), stream.trajectories())
    assert torch.equal(chunked.grids, stream.grids)
    assert chunked.trajectories().shape == (4, 2, 4, 4)


@pytest.mark.parametrize("det, des, adaptive", [
    ("FAST", "ORB", True), ("FAST", "ORB", False), ("GFTT", "LATCH", True),
    ("HARRIS", "FREAK", True), ("DOG", "SIFT", True),
    ("HESSIAN", "BRIEF", True), ("STAR", "ORB", False)])
def test_batch_frame_lane_equals_single_frame(det, des, adaptive):
    """`batch_frame` lane b against `_make_frame_impl` on image b, for every
    detector and descriptor family: level-0 keypoints and descriptors
    exactly, the rest but for near ties (at most one row in a hundred)."""
    cfg = small_config()
    cfg = cfg.replace(extractor=dataclasses.replace(
        cfg.extractor, detector=det, descriptor=des, adaptive=adaptive))
    pcfg = P.port_config(cfg)
    imgs, deps, _ = _sequences(30, frames=2)
    imgs_u8, deps_u16 = P.t(imgs[:, 1]), P.t(deps[:, 1])
    g = init_grid_thresholds(pcfg.extractor, "cpu")
    grids = torch.stack([g * (1.0 + 0.1 * b) for b in range(B)])
    fb, new_b = tbatch.batch_frame(imgs_u8, deps_u16, grids, pcfg)
    for b in range(B):
        fs, new_s = _make_frame_impl(imgs_u8[b], deps_u16[b], grids[b], pcfg)
        assert torch.equal(new_s, new_b[b])
        lvl0 = fs.feat.octave == 0
        assert lvl0.any()
        for name in ("xy", "desc", "valid"):
            a, c = getattr(fs.feat, name), getattr(fb.feat, name)[b]
            assert torch.equal(a[lvl0], c[lvl0]), name
            rows = (a != c).reshape(a.shape[0], -1).any(1)
            assert int(rows.sum()) <= a.shape[0] // 100, (name, int(rows.sum()))
        assert torch.equal(fs.T_cw, fb.T_cw[b])
        np.testing.assert_allclose(P.n(fb.p3d[b]), P.n(fs.p3d), atol=1e-6)


def test_batch_frame_takes_only_batches():
    pcfg = P.port_config(small_config())
    g = init_grid_thresholds(pcfg.extractor, "cpu")
    img = torch.zeros(pcfg.camera.height, pcfg.camera.width)
    with pytest.raises(ValueError, match=r"\[B,H,W\]"):
        tbatch.batch_frame(img, img, g, pcfg)


def _words(rng, shape):
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize("n, m", [(64, 80), (7, 3), (128, 2)])
def test_batched_top2_plain_equals_per_lane(n, m):
    """The kernel's plain version over [B,N,8] x [B,M,8] equals B unbatched
    calls exactly (and the CPU wrapper is the plain version), with masks and
    ties."""
    rng = np.random.default_rng(n + m)
    a, b = _words(rng, (4, n, 8)), _words(rng, (4, m, 8))
    b[:, m // 2:] = b[:, :1]                       # tied targets
    va = torch.from_numpy(rng.random((4, n)) > 0.2)
    vb = torch.from_numpy(rng.random((4, m)) > 0.2)
    vb[1] = False                                  # a lane with no target
    va[2] = False                                  # a lane with no query
    out = hamming_top2_plain(a, va, b, vb)
    assert [x.shape for x in out] == [(4, n)] * 3
    for lane in range(4):
        ref = hamming_top2_plain(a[lane], va[lane], b[lane], vb[lane])
        for x, y in zip(out, ref):
            assert torch.equal(x[lane], y)
    for x, y in zip(hamming_top2(a, va, b, vb), out):
        assert torch.equal(x, y)
    m1 = matching.knn_ratio_match(a, va, b, vb, ratio=0.9)
    for lane in range(4):
        m2 = matching.knn_ratio_match(a[lane], va[lane], b[lane], vb[lane],
                                      ratio=0.9)
        for x, y in zip(m1, m2):
            assert torch.equal(x[lane], y)


def test_batched_scatters_equal_per_lane():
    """The two integer scatters that take lane offsets: per-cell corner
    counts and duplicate resolution, exactly as per lane."""
    rng = np.random.default_rng(3)
    score = torch.from_numpy(
        (rng.random((3, 61, 77)) > 0.7).astype(np.float32))
    counts = fast.counts_per_grid_cell(score, 3, 4)
    m = matching.Matches(
        target_idx=torch.from_numpy(rng.integers(-1, 9, (3, 40))
                                    .astype(np.int32)),
        distance=torch.from_numpy(rng.integers(0, 5, (3, 40))
                                  .astype(np.float32)),
        valid=torch.from_numpy(rng.random((3, 40)) > 0.3))
    m = m._replace(valid=m.valid & (m.target_idx >= 0))
    res = matching.resolve_duplicates(m, 9)
    for b in range(3):
        assert torch.equal(counts[b], fast.counts_per_grid_cell(score[b], 3, 4))
        one = matching.resolve_duplicates(
            matching.Matches(*(x[b] for x in m)), 9)
        for x, y in zip(res, one):
            assert torch.equal(x[b], y)


def _pools(n_lanes=3, M=200):
    rng = np.random.default_rng(5)
    p1 = np.stack([rng.uniform(-1.5, 1.5, (n_lanes, M)),
                   rng.uniform(-1, 1, (n_lanes, M)),
                   rng.uniform(0.8, 3.5, (n_lanes, M))], -1).astype(np.float32)
    t = rng.normal(0, 0.03, (n_lanes, 3)).astype(np.float32)
    p2 = p1 + t[:, None] + rng.normal(0, 0.002, p1.shape).astype(np.float32)
    bad = rng.random((n_lanes, M)) < 0.25
    p2[bad] += rng.normal(0, 0.3, (int(bad.sum()), 3)).astype(np.float32)
    valid = rng.random((n_lanes, M)) > 0.1
    return P.t(p1), P.t(p2.astype(np.float32)), P.t(valid)


def test_batched_ransac_equals_per_lane():
    """One batched `ransac_align` (draws [B,H,S]) against B calls with each
    lane's draws: inliers and counts exactly, T to 1e-6."""
    pcfg = P.port_config(small_config())
    p1, p2, valid = _pools()
    H, S = pcfg.ransac.n_hypotheses, pcfg.ransac.sample_size
    draws = torch.from_numpy(np.random.default_rng(6).integers(0, 150,
                                                                (3, H, S)))
    out = transac.ransac_align(p1, p2, valid, None, pcfg.ransac, pcfg.camera,
                               draws=draws)
    assert out.T12.shape == (3, 4, 4) and out.inliers.shape == (3, 200)
    for b in range(3):
        one = transac.ransac_align(p1[b], p2[b], valid[b], None, pcfg.ransac,
                                   pcfg.camera, draws=draws[b])
        assert bool(one.ok) and bool(out.ok[b])
        assert torch.equal(one.inliers, out.inliers[b])
        assert int(one.n_inliers) == int(out.n_inliers[b])
        np.testing.assert_allclose(P.n(out.T12[b]), P.n(one.T12), atol=1e-6)
        np.testing.assert_allclose(float(out.rmse[b]), float(one.rmse),
                                   atol=1e-6)
    # its own draws: [B,H,S] in one call of the generator
    gen = torch.Generator().manual_seed(0)
    own = transac.ransac_align(p1, p2, valid, gen, pcfg.ransac, pcfg.camera)
    assert own.ok.all() and (own.n_inliers >= 100).all()


def test_batched_pose_only_ba_equals_per_lane():
    pcfg = P.port_config(small_config())
    cam = pcfg.camera
    rng = np.random.default_rng(8)
    N = 150
    pts = np.stack([rng.uniform(-1, 1, (3, N)), rng.uniform(-1, 1, (3, N)),
                    rng.uniform(1, 3, (3, N))], -1).astype(np.float32)
    T_true = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T_true[:, :3, 3] = rng.normal(0, 0.05, (3, 3))
    pc = pts + T_true[:, None, :3, 3]
    uv = np.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                   cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    ur = (uv[..., 0] - cam.bf / pc[..., 2]).astype(np.float32)
    z = pc[..., 2].astype(np.float32)
    valid = rng.random((3, N)) > 0.1
    T0 = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    args = [P.t(x) for x in (T0, pts, uv, ur, z, valid)]
    out = tba.pose_only_ba(*args, cam, pcfg.ba)
    for b in range(3):
        one = tba.pose_only_ba(*(a[b] for a in args), cam, pcfg.ba)
        np.testing.assert_allclose(P.n(out.T_cw[b]), P.n(one.T_cw), atol=1e-6)
        assert torch.equal(out.inliers[b], one.inliers)
        assert int(out.n_inliers[b]) == int(one.n_inliers)
        np.testing.assert_allclose(P.n(out.T_cw[b])[:3, 3], T_true[b, :3, 3],
                                   atol=0.01)

"""Parity of the port's pose stage with the JAX package: RANSAC fed the
reference's own sample draws, motion-only BA, one `rba_step` on a frame pair
carried across by `convert.py`, and the chained VO over a short synthetic
sequence (ATE against ground truth, both sides)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.models import frame as jframe
from aslam_tpu.models import odometry as jodo
from aslam_tpu.models.vo import VisualOdometry as JVisualOdometry
from aslam_tpu.ops import ba as jba
from aslam_tpu.ops import matching as jmatch
from aslam_tpu.ops import ransac as jransac
from aslam_tpu.utils import se3 as jse3
from aslam_tpu.utils import synthetic
from aslam_tpu_torch import convert
from aslam_tpu_torch.models import odometry as todo
from aslam_tpu_torch.models.extractor import init_grid_thresholds
from aslam_tpu_torch.models.frame import make_frame
from aslam_tpu_torch.models.vo import VisualOdometry
from aslam_tpu_torch.ops import ba as tba
from aslam_tpu_torch.ops import ransac as transac
from aslam_tpu_torch.utils import trajectory


def _ref_draws(good, key, cfg):
    """The raw samples `aslam_tpu/ops/ransac.py:113` draws for this pool."""
    n_good = jnp.sum(jnp.asarray(good).astype(jnp.int32))
    draw = jax.jit(lambda k, n: jax.random.randint(
        k, (cfg.n_hypotheses, cfg.sample_size), 0, jnp.maximum(n, 1)))
    return np.asarray(draw(key, n_good))


def _match_pool(seed, M=256, outliers=0.25):
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M),
                   rng.uniform(0.8, 3.5, M)], -1).astype(np.float32)
    xi = np.array([0.03, -0.02, 0.04, 0.01, -0.02, 0.015], np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    p2 = p1 @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.002, (M, 3))
    bad = rng.random(M) < outliers
    p2[bad] += rng.normal(0, 0.3, (bad.sum(), 3))
    p2 = p2.astype(np.float32)
    valid = rng.random(M) > 0.1
    p2[:3, 2] = -1.0                                  # invalid depth
    return p1, p2, valid, T


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_with_reference_draws_matches_reference(seed):
    cfg = small_config()
    p1, p2, valid, T_true = _match_pool(seed)
    key = jax.random.PRNGKey(seed + 7)
    ref = jransac.ransac_align(jnp.asarray(p1), jnp.asarray(p2),
                               jnp.asarray(valid), key, cfg.ransac, cfg.camera)
    good = valid & (p1[:, 2] > 0) & (p2[:, 2] > 0)
    draws = _ref_draws(good, key, cfg.ransac)
    pcfg = P.port_config(cfg)
    out = transac.ransac_align(P.t(p1), P.t(p2), P.t(valid), None, pcfg.ransac,
                               pcfg.camera, draws=P.t(draws))
    assert bool(ref.ok) and bool(out.ok)
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(P.n(out.T12), np.asarray(ref.T12), atol=1e-4)
    np.testing.assert_array_equal(P.n(out.inliers), np.asarray(ref.inliers))
    np.testing.assert_allclose(float(out.rmse), float(ref.rmse), atol=1e-4)

    # the port's own draws, from a generator on the pool's device
    gen = torch.Generator().manual_seed(seed)
    own = transac.ransac_align(P.t(p1), P.t(p2), P.t(valid), gen, pcfg.ransac,
                               pcfg.camera)
    assert bool(own.ok)
    assert abs(int(own.n_inliers) - int(ref.n_inliers)) <= 5
    np.testing.assert_allclose(P.n(own.T12), T_true, atol=5e-3)
    d = P.n(transac.sample_draws(torch.tensor(10), (64, 4), gen))
    assert d.min() >= 0 and d.max() <= 9


@pytest.mark.parametrize("prior_weight", [0.0, 2.0e6])
def test_pose_only_ba_matches_reference(prior_weight):
    cfg = small_config()
    cam = cfg.camera
    rng = np.random.default_rng(3)
    N = 256
    pts_w = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1, 1, N),
                      rng.uniform(0.8, 3.5, N)], -1).astype(np.float32)
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.02, 0.01, -0.03, 0.01, 0.02, -0.01], np.float32))))
    pc = pts_w @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:20] += 30.0                                          # outliers
    z = (pc[:, 2] + rng.normal(0, 0.005, N)).astype(np.float32)
    ur = np.where(rng.random(N) > 0.2, uv[:, 0] - cam.bf / z, -1.0).astype(np.float32)
    valid = rng.random(N) > 0.05
    T_init = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.01, -0.01, 0.01, 0.005, 0.0, 0.01], np.float32)))) @ T_true
    args = (T_init, pts_w, uv, ur, z, valid)
    ref = jba.pose_only_ba(*(jnp.asarray(a) for a in args), cam, cfg.ba,
                           prior_weight=prior_weight)
    pcfg = P.port_config(cfg)
    out = tba.pose_only_ba(*(P.t(a) for a in args), pcfg.camera, pcfg.ba,
                           prior_weight=prior_weight)
    np.testing.assert_allclose(P.n(out.T_cw), np.asarray(ref.T_cw), atol=1e-4)
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(P.n(out.inliers), np.asarray(ref.inliers))


def _frames_u8(n, seed, cam):
    imgs, depths, poses, _ = synthetic.make_sequence(n_frames=n, n_points=500,
                                                     seed=seed)
    return (np.clip(imgs, 0, 255).astype(np.uint8),
            np.clip(depths / cam.depth_factor, 0, 65535).astype(np.uint16), poses)


def test_rba_step_on_reference_frames_matches_reference():
    cfg = small_config()
    cam = cfg.camera
    imgs, depths, _ = _frames_u8(3, 3, cam)
    grid = jnp.full((3, 3), 20.0, jnp.float32)
    jf1, g1 = jframe._make_frame_impl(jnp.asarray(imgs[1]), jnp.asarray(depths[1]),
                                      grid, cfg, *imgs[1].shape)
    jf2, _ = jframe._make_frame_impl(jnp.asarray(imgs[2]), jnp.asarray(depths[2]),
                                     g1, cfg, *imgs[2].shape)
    key = jax.random.PRNGKey(5)
    ref = jodo.rba_step(jf1, jf2, key, cfg)

    # the reference's draws for the pool its matcher builds
    m = jmatch.resolve_duplicates(jmatch.knn_ratio_match(
        jf1.feat.desc, jf1.feat.valid, jf2.feat.desc, jf2.feat.valid,
        ratio=cfg.matcher.ratio_frame, max_dist=float(cfg.matcher.th_high)),
        jf2.feat.desc.shape[0])
    tgt = np.maximum(np.asarray(m.target_idx), 0)
    p1, p2 = np.asarray(jf1.p3d), np.asarray(jf2.p3d)[tgt]
    good = (np.asarray(m.valid) & np.asarray(jf1.has_depth)
            & np.asarray(jf2.has_depth)[tgt] & (p1[:, 2] > 0) & (p2[:, 2] > 0))
    draws = _ref_draws(good, key, cfg.ransac)

    tf1 = convert.frame_data(P.tree_np(jf1), "cpu")
    tf2 = convert.frame_data(P.tree_np(jf2), "cpu")
    assert tf1.feat.desc.dtype == torch.int32
    out = todo.rba_step(tf1, tf2, None, P.port_config(cfg), draws=P.t(draws))

    assert int(out.n_matches) == int(ref.n_matches) > 30
    np.testing.assert_array_equal(P.n(out.match_idx), np.asarray(ref.match_idx))
    assert int(out.n_inliers) == int(ref.n_inliers)
    dT = np.linalg.inv(np.asarray(ref.T_cw2, np.float64)) @ P.n(out.T_cw2)
    assert np.linalg.norm(dT[:3, 3]) < 1e-3
    assert np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)) < 1e-3


def test_chained_vo_reaches_reference_ate():
    cfg = small_config()
    cam = cfg.camera
    imgs, depths, poses_gt = _frames_u8(6, 3, cam)

    jvo = JVisualOdometry(cfg)
    tvo = VisualOdometry(P.port_config(cfg), "cpu",
                         generator=torch.Generator().manual_seed(0))
    for i in range(len(imgs)):
        jvo.process(imgs[i], depths[i])
        tvo.process(imgs[i], depths[i])
    gt = trajectory.camera_centers(poses_gt)
    ate_j = trajectory.ate_rmse(trajectory.camera_centers(np.stack(jvo.poses)), gt)
    ate_t = trajectory.ate_rmse(trajectory.camera_centers(np.stack(tvo.poses)), gt)
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.002), (ate_t, ate_j)
    assert ate_t < 0.01
    for s in tvo.stats:
        assert s["n_matches"] >= 30 and s["n_inliers"] >= 20, s


def test_track_sequence_equals_streaming_track_frame():
    pcfg = P.port_config(small_config())
    pcfg = pcfg.replace(ransac=dataclasses.replace(pcfg.ransac, n_hypotheses=32))
    imgs, depths, _ = _frames_u8(4, 7, pcfg.camera)
    imgs, depths = torch.from_numpy(imgs), torch.from_numpy(depths)
    f0, grid0 = make_frame(imgs[0], depths[0], pcfg,
                           init_grid_thresholds(pcfg.extractor, "cpu"))

    gen = torch.Generator().manual_seed(11)
    prev, grid, poses = f0, grid0, []
    for i in range(1, 4):
        prev, grid, res = todo.track_frame(prev, imgs[i], depths[i], grid, gen, pcfg)
        poses.append(res.T_cw2)

    gen = torch.Generator().manual_seed(11)
    last, grid_s, seq = todo.track_sequence(f0, imgs[1:], depths[1:], grid0, gen,
                                            pcfg)
    assert torch.equal(seq.T_cw, torch.stack(poses))
    assert torch.equal(grid_s, grid)
    assert torch.equal(last.T_cw, prev.T_cw)
    assert seq.n_matches.shape == (3,) and (seq.n_matches >= 30).all()

"""The port's CUDA kernels against their plain PyTorch versions, and the
SLAM engines and the CLI on the card against themselves on the CPU.

Imports torch and the port only (no jax), so that it runs where the card is:

    python -m pytest tests/test_torch_cuda.py -q

Without a CUDA device every test here skips: a CUDA kernel has no CPU mode.
The plain versions themselves are held to the JAX package by
tests/test_torch_hamming.py on the CPU.
"""

import numpy as np
import pytest
import torch

from aslam_tpu_torch.kernels import bench_pose_ba as PB
from aslam_tpu_torch.ops.hamming_top2 import hamming_top2, hamming_top2_plain

pytestmark = pytest.mark.cuda


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


# odd sizes: rows not a multiple of a block's 8, targets below one warp, not a
# multiple of the 256-target chunk or the 512-target pass, one and two targets
# only, the main path's sizes, many more rows than SMs times 8, the most
# targets that stay resident in shared memory (6144), and more than that,
# where the chunks go round a ring
SHAPES = [(1, 1), (7, 2), (5, 3), (33, 31), (257, 31), (100, 257), (257, 513),
          (256, 256), (1024, 1024), (1000, 1023), (1000, 2049), (2049, 77),
          (4100, 530), (8200, 33), (64, 6144), (64, 6145), (40, 12800),
          (1024, 16384)]


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


def test_hamming_top2_rejects_misplaced_and_mixed_card_inputs():
    dev = _card()
    a, va, b, vb = _inputs(16, 16, 0, dev)
    with pytest.raises(ValueError):
        hamming_top2(a, va, b, torch.ones(32, dtype=torch.bool, device=dev)[::2])
    with pytest.raises(ValueError):           # descriptors off a 16-byte boundary
        hamming_top2(torch.zeros(16 * 8 + 1, dtype=torch.int32, device=dev)[1:]
                     .view(16, 8), va, b, vb)
    if torch.cuda.device_count() > 1:
        with pytest.raises(ValueError):
            hamming_top2(a, va, b.to("cuda:1"), vb.to("cuda:1"))


def test_hamming_top2_is_capturable_in_a_cuda_graph():
    """Two calls captured in one CUDA graph; a replay over new input contents
    gives the plain version's outputs exactly.  `launches` counts the two
    calls made while capturing, not the replays."""
    dev = _card()
    first, second = _inputs(1024, 1024, 0, dev), _inputs(300, 7000, 1, dev)
    hamming_top2(*first)                      # builds and loads the kernel
    torch.cuda.synchronize()
    before = hamming_top2.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [hamming_top2(*first), hamming_top2(*second)]
    assert hamming_top2.launches == before + 2
    for seed in (5, 6):
        for held, new in ((first, _inputs(1024, 1024, seed, dev, seed == 5)),
                          (second, _inputs(300, 7000, seed + 10, dev))):
            for x, y in zip(held, new):
                x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        assert hamming_top2.launches == before + 2
        for out, args in zip(outs, (first, second)):
            for x, y in zip(out, hamming_top2_plain(*args)):
                assert torch.equal(x, y), seed


@pytest.mark.parametrize("b,n,m", [(1, 1024, 1024), (16, 1024, 1024),
                                   (3, 257, 513), (5, 7, 2), (2, 64, 6145),
                                   (4, 1000, 1023)])
def test_hamming_top2_batched_kernel_equals_plain_and_per_lane(b, n, m):
    """The batch axis: [B,N,8] x [B,M,8] in one launch equals the batched
    plain version and B unbatched launches exactly, with ties and masks, a
    lane with no valid target and a lane with no valid query."""
    dev = _card()
    lanes = [_inputs(n, m, seed, dev, ties=seed % 2 == 0) for seed in range(b)]
    if b > 2:
        lanes[1][3] = torch.zeros_like(lanes[1][3])
        lanes[2][1] = torch.zeros_like(lanes[2][1])
    args = [torch.stack([lane[k] for lane in lanes]) for k in range(4)]
    before = hamming_top2.launches
    out = hamming_top2(*args)
    assert hamming_top2.launches == before + 1
    single = [hamming_top2(*lane) for lane in lanes]
    ref = hamming_top2_plain(*args)
    torch.cuda.synchronize()
    for k in range(3):
        assert out[k].shape == (b, n)
        assert torch.equal(out[k], ref[k]), k
        assert torch.equal(out[k], torch.stack([x[k] for x in single])), k


def test_hamming_top2_rejects_bad_batches():
    dev = _card()
    a, va, b, vb = (torch.stack([x, x]) for x in _inputs(16, 16, 0, dev))
    with pytest.raises(ValueError, match="batch"):
        hamming_top2(a, va, b[0], vb[0])              # a batch against one set
    with pytest.raises(ValueError):
        hamming_top2(a, va, b[:1], vb[:1])            # lane counts differ
    with pytest.raises(ValueError):
        hamming_top2(a, va[:, :8], b, vb)
    with pytest.raises(ValueError, match="batch"):
        hamming_top2(a[None], va[None], b[None], vb[None])


def test_batch_vo_on_card_equals_unbatched_chain():
    """`BatchVisualOdometry` on the card at small shape: each lane equal to
    the unbatched `track_frame` chain with the same draws (poses to 1e-5,
    grids exactly), one kernel launch per batched step, and
    `process_chunk` equal to `process` bit for bit."""
    from aslam_tpu_torch.config import small_config
    from aslam_tpu_torch.models import odometry
    from aslam_tpu_torch.models.batch_vo import BatchVisualOdometry
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import make_frame
    from aslam_tpu_torch.utils import synthetic

    dev = _card()
    cfg = small_config()
    cam = cfg.camera
    B, F = 3, 5
    seqs = [synthetic.make_sequence(n_frames=F, n_points=400, cam=cam,
                                    seed=10 + b) for b in range(B)]
    imgs = torch.from_numpy(np.stack([np.clip(s[0], 0, 255).astype(np.uint8)
                                      for s in seqs])).to(dev)
    deps = torch.from_numpy(np.stack([
        np.clip(s[1] / cam.depth_factor, 0, 65535).astype(np.uint16)
        for s in seqs])).to(dev)
    H, S = cfg.ransac.n_hypotheses, cfg.ransac.sample_size
    draws = torch.from_numpy(np.random.default_rng(0).integers(
        0, 40, (B, F - 1, H, S))).to(dev)
    bvo = BatchVisualOdometry(cfg, B, dev)
    before = hamming_top2.launches
    for f in range(F):
        bvo.process(imgs[:, f], deps[:, f],
                    draws=None if f == 0 else draws[:, f - 1])
    assert hamming_top2.launches == before + F - 1
    traj = bvo.trajectories()
    for b in range(B):
        grid = init_grid_thresholds(cfg.extractor, dev)
        frame, grid = make_frame(imgs[b, 0], deps[b, 0], cfg, grid)
        for f in range(1, F):
            frame, grid, res = odometry.track_frame(
                frame, imgs[b, f], deps[b, f], grid, None, cfg,
                draws=draws[b, f - 1])
            np.testing.assert_allclose(res.T_cw2.cpu().numpy(), traj[f - 1, b],
                                       rtol=0, atol=1e-5)
        assert torch.equal(grid, bvo.grids[b])
    stream = BatchVisualOdometry(cfg, B, dev, seed=3)
    for f in range(F):
        stream.process(imgs[:, f], deps[:, f])
    chunked = BatchVisualOdometry(cfg, B, dev, seed=3)
    chunked.process_chunk(imgs[:, :2], deps[:, :2])
    chunked.process_chunk(imgs[:, 2:], deps[:, 2:])
    assert np.array_equal(stream.trajectories(), chunked.trajectories())


def test_mma_peak_probe_reads_about_the_rate_the_bound_divides_by():
    """`hamming_top2_bound` divides by a measured 1-bit tensor-core rate: the
    probe that measured it reads no more than a tenth above the constant on
    this card (a lower constant would flatter the kernel), and not far below."""
    from aslam_tpu_torch.kernels.bench_top2 import mma_peak_ops_per_s
    from aslam_tpu_torch.ops.hamming_top2 import MMA_OPS_PER_S

    rate = mma_peak_ops_per_s(_card())
    assert 0.7 * MMA_OPS_PER_S <= rate <= 1.1 * MMA_OPS_PER_S, rate


def test_device_slam_on_card_matches_cpu_run():
    """The counterpart of chip_smoke.py's phase 4 at small shape: the
    synthetic walk of tests/test_device_slam.py through `DeviceSlam` on the
    card, chunked and streamed: one `hamming_top2` launch per tracked
    frame, a local BA, every keyframe mapped, no device sync but the
    engine's own reads and the frames' upload, and stream equal to chunked
    within 1 mm.  Against the same run on the CPU (the kernel's plain
    version, and another random stream for the RANSAC samples: a CUDA and a
    CPU generator draw differently from one seed) within 1 cm, and both
    with ATE < 3 cm."""
    from aslam_tpu_torch.config import small_config
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.device_slam import DeviceSlam
    from aslam_tpu_torch.ops.lba import local_ba
    from aslam_tpu_torch.profile_slam import sync_sites
    from aslam_tpu_torch.utils import synthetic, trajectory

    dev = _card()
    cfg = small_config()
    rng = np.random.default_rng(4)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(10, step_t=0.05, step_r=0.02, rng=rng)
    tex = synthetic.point_textures(500, seed=5)
    imgs = np.stack([synthetic.render_intensity_image(cfg.camera, T, pts, tex)
                     for T in poses])
    depths = np.stack([synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
                       for T in poses])
    # first use on the card copies the front end's constant tables there
    DeviceSlam(cfg, dev).process(imgs[0], depths[0])

    def run(where, chunked):
        before, lba, reads = hamming_top2.launches, local_ba.runs, read_host.count
        slam = DeviceSlam(cfg, where, sync_every=4)
        if chunked and where == dev:
            sites = sync_sites(lambda: slam.process_chunk(imgs, depths))
            # the card waits for the host only at the engine's reads and at
            # the upload of the chunk (its frames and depths: two copies)
            n = sum(k for site, k in sites.items()
                    if site.startswith("aslam_tpu_torch"))
            assert n == read_host.count - reads + 2, sites
        elif chunked:
            slam.process_chunk(imgs, depths)
        else:
            for i in range(len(imgs)):
                slam.process(imgs[i], depths[i])
        traj, _ = slam.finish()
        assert np.isfinite(traj).all()
        assert slam.kfs_mapped == int(slam.state.n_kfs) >= 2
        ate = trajectory.ate_rmse(trajectory.camera_centers(traj),
                                  trajectory.camera_centers(poses))
        assert ate < 0.03
        return (traj, int(slam.state.n_kfs), hamming_top2.launches - before,
                local_ba.runs - lba)

    chunk = run(dev, True)
    stream = run(dev, False)
    cpu = run("cpu", True)
    assert chunk[2] == stream[2] == len(imgs) - 1 and cpu[2] == 0
    assert chunk[3] >= 1 and chunk[1] == stream[1]
    np.testing.assert_allclose(stream[0], chunk[0], atol=1e-3)
    np.testing.assert_allclose(cpu[0], chunk[0], atol=1e-2)


def test_loop_closing_on_card_matches_cpu_walk():
    """The looped map (small_config) through `LoopClosing.process_keyframe`
    on the card and on the CPU: the same vocabulary (trained on the host from
    the same sample), the same database words, the same loop, corrected
    poses within 1 cm (the verification's RANSAC draws differ: a CUDA and a
    CPU generator draw differently from one seed), drift at the closing
    keyframe cut by 20%, and no device sync but the counted reads."""
    from aslam_tpu_torch.config import small_config
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.loopclosing import LoopClosing
    from aslam_tpu_torch.profile_slam import looped_map, sync_sites

    dev = _card()
    cfg = small_config()

    def walk(where, count_syncs=False):
        m, T_true, T_est, _ = looped_map(cfg, where, seed=1234)
        lc = LoopClosing(cfg, where, train_after_kfs=4)
        reads = read_host.count

        def go():
            nonlocal m
            for k in range(20):
                m = lc.process_keyframe(m, k, k)

        if count_syncs:
            sites = sync_sites(go)
            n = sum(k for site, k in sites.items()
                    if site.startswith("aslam_tpu_torch"))
            # beside the counted reads: the trained vocabulary's upload (4
            # level tensors and idf per training) and the loop transform's
            uploads = 5 * 2 + len(lc.loops)
            assert n <= read_host.count - reads + uploads, sites
        else:
            go()
        return lc, m, T_true, T_est

    walk(dev)                                                # warm-up
    lc_c, m_c, T_true, T_est = walk(dev, count_syncs=True)
    lc_h, m_h, _, _ = walk("cpu")
    assert lc_c.loops == lc_h.loops and len(lc_c.loops) == 1
    for a, b in zip(lc_c.vocab.level_cents, lc_h.vocab.level_cents):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(lc_c.db.kf_words.cpu(), lc_h.db.kf_words)
    assert torch.equal(lc_c.db.kf_hist.cpu(), lc_h.db.kf_hist)
    np.testing.assert_allclose(m_c.kf_T_cw.cpu().numpy(), m_h.kf_T_cw.numpy(),
                               atol=1e-2)
    q, _ = lc_c.loops[0]
    before = np.linalg.norm(T_est[q][:3, 3] - T_true[q][:3, 3])
    after = np.linalg.norm(m_c.kf_T_cw.cpu().numpy()[q][:3, 3] - T_true[q][:3, 3])
    assert after < 0.8 * before


def test_bow_transform_takes_the_first_minimum_on_card():
    """`torch.argmin` on the card returns the first of equal minima, as on
    the CPU: two equal children at every node of a random tree."""
    from aslam_tpu_torch.ops import bow

    dev = _card()
    rng = np.random.default_rng(0)
    levels = []
    for lvl in range(3):
        c = rng.integers(0, 2**32, (10**lvl, 10, 8), dtype=np.uint32)
        c[:, 7] = c[:, 3]                      # children 3 and 7 tie everywhere
        levels.append(torch.from_numpy(c.view(np.int32)))
    desc = torch.from_numpy(rng.integers(0, 2**32, (4096, 8), dtype=np.uint32)
                            .view(np.int32))
    cpu = bow.transform(bow.Vocabulary(tuple(levels), torch.ones(1000)), desc)
    card = bow.transform(bow.Vocabulary(tuple(x.to(dev) for x in levels),
                                        torch.ones(1000, device=dev)),
                         desc.to(dev))
    assert torch.equal(card.cpu(), cpu)
    digits = torch.stack([cpu // 100, cpu // 10 % 10, cpu % 10])
    assert (digits == 3).any() and not (digits == 7).any()


def test_ricp_and_gicp_slam_on_card_match_cpu():
    """Config 3 at small shape on the card: `ricp_fused` equals `ricp_step`
    on a frame pair with the escalation forced, reads nothing, and agrees
    with the CPU's result to 5 mm; `DeviceSlam` with `use_gicp` and
    `use_loop_closing` tracks the walk with ATE < 3 cm."""
    import dataclasses

    from aslam_tpu_torch.config import small_config
    from aslam_tpu_torch.device import read_host
    from aslam_tpu_torch.models.device_slam import DeviceSlam
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import make_frame
    from aslam_tpu_torch.models.odometry import ricp_fused, ricp_step
    from aslam_tpu_torch.utils import synthetic, trajectory

    dev = _card()
    cfg = small_config().replace(use_gicp=True, use_loop_closing=True)
    forced = cfg.replace(icp=dataclasses.replace(cfg.icp,
                                                 escalate_min_inliers=10**6))
    rng = np.random.default_rng(4)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(10, step_t=0.05, step_r=0.02, rng=rng)
    tex = synthetic.point_textures(500, seed=5)
    imgs = np.stack([synthetic.render_intensity_image(cfg.camera, T, pts, tex)
                     for T in poses])
    depths = np.stack([synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
                       for T in poses])

    def pair(where):
        grid = init_grid_thresholds(cfg.extractor, where)
        f1, grid = make_frame(torch.from_numpy(imgs[1]).to(where),
                              torch.from_numpy(depths[1]).to(where), cfg, grid)
        f2, _ = make_frame(torch.from_numpy(imgs[2]).to(where),
                           torch.from_numpy(depths[2]).to(where), cfg, grid)
        gen = torch.Generator(device=where).manual_seed(0)
        draws = torch.randint(0, 100, (cfg.ransac.n_hypotheses,
                                       cfg.ransac.sample_size),
                              generator=torch.Generator().manual_seed(1))
        reads = read_host.count
        fused = ricp_fused(f1, f2, gen, forced, draws=draws.to(where))
        assert read_host.count == reads
        step = ricp_step(f1, f2, gen, forced, draws=draws.to(where))
        assert read_host.count == reads + 2
        np.testing.assert_allclose(fused.T_cw2.cpu().numpy(),
                                   step.T_cw2.cpu().numpy(), atol=1e-5)
        return fused.T_cw2.cpu().numpy()

    T_card, T_cpu = pair(dev), pair("cpu")
    np.testing.assert_allclose(T_card, T_cpu, atol=5e-3)
    T12_true = poses[2] @ np.linalg.inv(poses[1])
    assert np.linalg.norm((np.linalg.inv(T_card) @ T12_true)[:3, 3]) < 0.02

    before = hamming_top2.launches
    slam = DeviceSlam(cfg, dev, sync_every=4)
    slam.loop_closing.train_after = 2       # the walk ends with 3 keyframes
    slam.process_chunk(imgs[:5], depths[:5])
    for i in range(5, 10):
        slam.process(imgs[i], depths[i])
    traj, _ = slam.finish()
    assert hamming_top2.launches - before == 9
    assert np.isfinite(traj).all() and len(slam.sync_reads) >= 2
    assert slam.last_n_kfs >= 2 and slam.loop_closing.vocab is not None
    assert int(slam.loop_closing.db.kf_in_db.sum()) == slam.last_n_kfs
    ate = trajectory.ate_rmse(trajectory.camera_centers(traj),
                              trajectory.camera_centers(poses))
    assert ate < 0.03


@pytest.mark.parametrize("flags", [
    ["--mode", "vo"],
    ["--mode", "slam+gicp", "--engine", "device", "--chunk", "4"],
    ["--mode", "slam+loop", "--engine", "host"],
    ["--mode", "vo", "--detector", "DOG", "--descriptor", "SIFT"],
    ["--mode", "slam+gicp", "--engine", "device", "--chunk", "4",
     "--detector", "GFTT", "--descriptor", "LATCH"],
], ids=["vo", "device", "host", "vo-dog-sift", "device-gftt-latch"])
def test_cli_on_card_matches_cli_on_cpu(tmp_path, flags):
    """`python -m aslam_tpu_torch.main` at small shape over a fabricated TUM
    directory: on the card by default, one kernel launch per tracked frame,
    the reference's output files, and camera centres within 1 cm of the same
    run with `--device cpu` (other RANSAC draws: the generators differ).
    The float SIFT family matches through the L2 matrix: no launch."""
    from aslam_tpu_torch import main as cli
    from aslam_tpu_torch.config import small_config
    from aslam_tpu_torch.utils import dataset, synthetic, trajectory

    _card()
    cfg = small_config()
    n = 10
    rng = np.random.default_rng(4)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(n, step_t=0.05, step_r=0.02, rng=rng)
    tex = synthetic.point_textures(500, seed=5)
    imgs = [np.clip(synthetic.render_intensity_image(cfg.camera, T, pts, tex),
                    0, 255).astype(np.uint8) for T in poses]
    deps = [np.clip(synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
                    / cfg.camera.depth_factor, 0, 65535).astype(np.uint16)
            for T in poses]
    root = str(tmp_path / "tum")
    dataset.write_tum_sequence(root, imgs, deps,
                               [100.0 + 0.033 * i for i in range(n)])
    cli.CAMERAS["test"] = cfg.camera

    def run(out, *device):
        before = hamming_top2.launches
        cli.main(["--dataset", root, "--camera", "test", "--out-dir",
                  str(tmp_path / out), *flags, *device], base_config=cfg)
        _, xyz, _ = trajectory.load_tum_trajectory(
            str(tmp_path / out / "CameraTrajectory.txt"))
        return xyz, hamming_top2.launches - before

    card, launched = run("card")                 # the default device
    cpu, launched_cpu = run("cpu", "--device", "cpu")
    assert launched == (0 if "SIFT" in flags else n - 1) and launched_cpu == 0
    assert card.shape == (n, 3) and np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, atol=0.01)
    gt = trajectory.camera_centers(poses)
    assert trajectory.ate_rmse(card, gt) < 0.03
    host = flags[-1] == "host"
    for name in ("KeyFrameTrajectory.txt", "Histogram.csv"):
        assert (tmp_path / "card" / name).exists() == host
    assert (tmp_path / "card" / "metrics.json").exists()


@pytest.mark.parametrize("family", ["GFTT", "HARRIS", "DOG", "HESSIAN", "STAR",
                                    "BRIEF", "FREAK", "LATCH", "SIFT"])
def test_family_on_card_matches_cpu(family):
    """A detector response or a descriptor on one textured image, on the card
    and on the CPU: equal masks (but within 1e-3 of the threshold) and values
    to rtol 1e-5; descriptor rows equal (SIFT to 1e-5) but where the two IC
    angles steer a sample onto another pixel."""
    from aslam_tpu_torch.ops import desc, detectors, pyramid

    dev = _card()
    rng = np.random.default_rng(3)
    img = np.kron(rng.uniform(0, 255, (30, 40)), np.ones((8, 8)))
    img = torch.from_numpy(np.clip(img + rng.normal(0, 2, img.shape), 0, 255)
                           .astype(np.float32))
    if family in detectors.DETECTOR_DEFAULTS:
        th = torch.full(img.shape, detectors.defaults(family)["threshold"])
        ref = detectors.response(family, img, th)
        out = detectors.response(family, img.to(dev), th.to(dev)).cpu()
        differ = (ref > 0) != (out > 0)
        raw = torch.maximum(ref, out)
        assert bool((torch.abs(raw - th)[differ] <= 1e-3 * th[differ]).all())
        both = (ref > 0) & (out > 0)
        assert int(both.sum()) > 100
        torch.testing.assert_close(out[both], ref[both], rtol=1e-5, atol=1e-5)
        return
    blur = pyramid.gaussian_blur(img)
    xy = torch.from_numpy(np.stack([rng.uniform(16, 303, 500),
                                    rng.uniform(16, 223, 500)], 1)
                          .astype(np.float32))
    d_c, a_c = desc.describe(family, blur, xy)
    d_g, a_g = desc.describe(family, blur.to(dev), xy.to(dev))
    tie = (desc.steered_index(family, a_c)
           != desc.steered_index(family, a_g).cpu()).any(1)
    d_g = d_g.cpu()
    assert float(tie.float().mean()) < 0.02
    if desc.is_binary(family):
        assert torch.equal(d_c[~tie], d_g[~tie])
    else:
        torch.testing.assert_close(d_g[~tie], d_c[~tie], rtol=0, atol=1e-5)


@pytest.fixture
def nccl_world1():
    """A one-rank NCCL group on the card and its 1x1 mesh, destroyed after
    the test."""
    import torch.distributed as dist

    from aslam_tpu_torch.parallel import launch
    from aslam_tpu_torch.parallel.mesh import make_mesh

    dev = _card()
    launch.initialize_local(dev)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_sharded_local_ba_on_nccl_equals_local_ba(nccl_world1):
    """The dry run's windowed Schur problem (4 cameras x 64 points): the
    sharded schedule on a world-1 NCCL group against `local_ba` on the card,
    to the reference's 1e-3, and a second run bit for bit."""
    from aslam_tpu_torch.ops.lba import local_ba
    from aslam_tpu_torch.parallel.dryrun import CAM, CFG, dryrun_problems
    from aslam_tpu_torch.parallel.sharded_ba import (pad_problem,
                                                     sharded_local_ba)

    mesh = nccl_world1
    prob, _ = dryrun_problems(mesh.device)
    padded = pad_problem(prob, mesh)
    out, chi2, n_edges = sharded_local_ba(padded, CAM, CFG, mesh)
    again = sharded_local_ba(padded, CAM, CFG, mesh)[0]
    ref, stats = local_ba(prob, CAM, CFG)
    assert out.cam_T.is_cuda and chi2.is_cuda
    assert float((out.cam_T - ref.cam_T).abs().max()) <= 1e-3
    assert float((out.points - ref.points).abs().max()) <= 1e-3
    assert int(n_edges) == int(stats.n_edges) == 256
    assert abs(float(chi2) - float(stats.chi2)) < 1e-3
    assert torch.equal(out.cam_T, again.cam_T)
    assert torch.equal(out.points, again.points)


def test_partitioned_gn_cg_step_on_nccl_equals_gn_cg_step(nccl_world1):
    """The dry run's joint GN-CG map (8 keyframes x 64 features): the placed
    sharded step on a world-1 NCCL group against `gn_cg_step` on the card,
    to the reference's 2e-3."""
    from aslam_tpu_torch.ops.global_ba import gn_cg_step
    from aslam_tpu_torch.parallel.dryrun import CAM, CFG, dryrun_problems
    from aslam_tpu_torch.parallel.partition import partitioned_gn_cg_step

    mesh = nccl_world1
    _, m = dryrun_problems(mesh.device)
    out, stats = partitioned_gn_cg_step(m, CAM, CFG, mesh, cg_iters=8)
    ref, ref_stats = gn_cg_step(m, CAM, CFG, cg_iters=8)
    assert float((out.kf_T_cw - ref.kf_T_cw).abs().max()) <= 2e-3
    assert float((out.lm_pos - ref.lm_pos).abs().max()) <= 2e-3
    assert int(stats.n_edges) == int(ref_stats.n_edges) == 512
    assert np.isclose(float(stats.chi2), float(ref_stats.chi2), rtol=0.05)


# motion-only BA: csrc/pose_ba.cu (ops/pose_ba_kernel.py) against
# ops/ba.py::pose_only_ba_plain on the card; the cases and the comparison are
# kernels/bench_pose_ba.py's (PB), which chip_smoke.py uses too

@pytest.mark.parametrize("case", PB.CASES)
def test_pose_ba_kernel_equals_plain(case):
    """`pose_only_ba` on the card launches the kernel once (and never the
    plain version) and agrees with `pose_only_ba_plain` on the same card."""
    from aslam_tpu_torch.ops import ba
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    dev = _card()
    cam = PB.camera()
    args, cfg, prior = PB.pose_ba_case(case, dev)
    plain = ba.pose_only_ba_plain

    def refuse(*a, **kw):
        raise AssertionError("pose_only_ba took the plain version on the card")

    before = pose_only_ba_kernel.launches
    ba.pose_only_ba_plain = refuse
    try:
        out = ba.pose_only_ba(*args, cam, cfg, prior)
    finally:
        ba.pose_only_ba_plain = plain
    assert pose_only_ba_kernel.launches == before + 1
    ref = plain(*args, cam, cfg, prior)
    torch.cuda.synchronize()
    assert out.T_cw.shape == (4, 4) and out.n_inliers.shape == ()
    assert out.T_cw.is_cuda and out.inliers.dtype == torch.bool
    PB.check_against_plain(out, ref, args, cam, cfg, prior)
    if case in ("all_invalid", "nonfinite"):
        # every step zero (no edge weighs) or zeroed (NaN): the pose stays
        assert torch.equal(out.T_cw, args[0]) and torch.equal(ref.T_cw, args[0])
    if case == "all_invalid":
        assert int(out.n_inliers) == 0


def test_pose_ba_batch_lanes_equal_single_calls_bit_for_bit():
    """B = 16 problems in one launch: each lane the same bits as the same
    problem alone, and the batch held to the batched plain version."""
    from aslam_tpu_torch.config import BAConfig
    from aslam_tpu_torch.ops import ba
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    dev = _card()
    cam, cfg = PB.camera(), BAConfig()
    lanes, args = PB.pose_ba_batch(dev)
    before = pose_only_ba_kernel.launches
    out = ba.pose_only_ba(*args, cam, cfg)
    assert pose_only_ba_kernel.launches == before + 1
    assert out.T_cw.shape == (16, 4, 4) and out.n_inliers.shape == (16,)
    for k, lane in enumerate(lanes):
        one = ba.pose_only_ba(*lane, cam, cfg)
        for x, y in zip(one, out):
            assert PB.same_bits(x, y[k]), k
    ref = ba.pose_only_ba_plain(*args, cam, cfg)
    torch.cuda.synchronize()
    PB.check_against_plain(out, ref, args, cam, cfg, 0.0)


def test_pose_ba_two_runs_are_bit_identical():
    from aslam_tpu_torch.ops import ba

    dev = _card()
    cam = PB.camera()
    args, cfg, _ = PB.pose_ba_case("vo_frame_1024", dev)
    prior = torch.tensor(2.0e6, device=dev)
    first = ba.pose_only_ba(*args, cam, cfg, prior)
    second = ba.pose_only_ba(*args, cam, cfg, prior)
    for x, y in zip(first, second):
        assert PB.same_bits(x, y)


def test_pose_ba_is_capturable_in_a_cuda_graph():
    """One call at N = 1024 with a device prior weight and one at B = 16,
    captured in a CUDA graph; replays over new input contents (and a new
    prior weight) equal eager calls on them bit for bit.  `launches` counts
    the two captured calls, not the replays."""
    from aslam_tpu_torch.config import BAConfig
    from aslam_tpu_torch.ops import ba
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    dev = _card()
    cam, cfg = PB.camera(), BAConfig()
    single = PB.pose_ba_inputs(1024, 1, dev)
    _, batch = PB.pose_ba_batch(dev)
    prior = torch.tensor(2.0e6, device=dev)
    ba.pose_only_ba(*single, cam, cfg, prior)        # builds and loads the kernel
    torch.cuda.synchronize()
    before = pose_only_ba_kernel.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ba.pose_only_ba(*single, cam, cfg, prior),
                ba.pose_only_ba(*batch, cam, cfg)]
    assert pose_only_ba_kernel.launches == before + 2
    for seed in (7, 8):
        new_single = PB.pose_ba_inputs(1024, seed, dev)
        new_batch = PB.pose_ba_batch(dev)[1]
        for held, new in zip(single + batch, new_single + new_batch):
            held.copy_(new)
        prior.fill_(1.0e5 * seed)
        captured = pose_only_ba_kernel.launches
        graph.replay()
        torch.cuda.synchronize()
        assert pose_only_ba_kernel.launches == captured
        eager = [ba.pose_only_ba(*single, cam, cfg, prior),
                 ba.pose_only_ba(*batch, cam, cfg)]
        for got, want in zip(outs, eager):
            for x, y in zip(got, want):
                assert PB.same_bits(x, y), seed


def test_pose_ba_kernel_refuses_misplaced_inputs():
    from aslam_tpu_torch.config import BAConfig
    from aslam_tpu_torch.ops.pose_ba_kernel import pose_only_ba_kernel

    dev = _card()
    cam, cfg = PB.camera(), BAConfig()
    args = PB.pose_ba_inputs(64, 0, dev)
    with pytest.raises(ValueError, match="prior_weight"):
        pose_only_ba_kernel(*args, cam, cfg, prior_weight=torch.tensor(1.0))
    mixed = list(args)
    mixed[1] = mixed[1].cpu()
    with pytest.raises(ValueError, match="runs on the card"):
        pose_only_ba_kernel(*mixed, cam, cfg)
    strided = list(args)
    strided[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        pose_only_ba_kernel(*strided, cam, cfg)
    if torch.cuda.device_count() > 1:
        split = list(args)
        split[4] = split[4].to("cuda:1")
        with pytest.raises(ValueError, match="different cards"):
            pose_only_ba_kernel(*split, cam, cfg)

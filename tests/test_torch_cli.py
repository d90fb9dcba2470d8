"""The port's CLI (`python -m aslam_tpu_torch.main`) end to end on the CPU,
over a TUM-layout directory fabricated from the synthetic renderer (the
recipe of tests/test_multisequence_cli.py, PNGs written by the port's own
`write_tum_sequence`): every mode and engine at `small_config()` shapes
(`main(..., base_config=)`), the other detector and descriptor families, the
output files, `--render-map` and `--viewer` on both engines, the flags that
stop with a named error (misspelt family names, the map's flags in `--mode
vo`), and the refusal to run without a CUDA device unless `--device cpu` is
given.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_parity as P  # noqa: F401  (caps torch threads)
from aslam_tpu_torch import main as cli
from aslam_tpu_torch.config import small_config
from aslam_tpu_torch.utils import dataset, synthetic, trajectory

N = 10


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    cfg = small_config()
    rng = np.random.default_rng(4)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(N, step_t=0.05, step_r=0.02, rng=rng)
    tex = synthetic.point_textures(500, seed=5)
    imgs = [np.clip(synthetic.render_intensity_image(cfg.camera, T, pts, tex),
                    0, 255).astype(np.uint8) for T in poses]
    deps = [np.clip(synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
                    / cfg.camera.depth_factor, 0, 65535).astype(np.uint16)
            for T in poses]
    root = tmp_path_factory.mktemp("tum")
    dataset.write_tum_sequence(str(root), imgs, deps,
                               [100.0 + 0.033 * i for i in range(N)])
    cli.CAMERAS["test"] = cfg.camera
    return cfg, str(root), poses


def _run(tum, out, *flags):
    cfg, root, _ = tum
    return cli.main(["--dataset", root, "--camera", "test", "--device", "cpu",
                     "--out-dir", str(out), *flags], base_config=cfg)


def _ate(path, poses):
    ts, xyz, quat = trajectory.load_tum_trajectory(str(path))
    assert np.isfinite(xyz).all() and np.isfinite(quat).all()
    np.testing.assert_allclose(np.linalg.norm(quat, axis=1), 1.0, atol=1e-4)
    return ts, trajectory.ate_rmse(
        xyz, trajectory.camera_centers(poses[:len(ts)]))


def test_cli_vo(tum, tmp_path):
    m = _run(tum, tmp_path, "--mode", "vo")
    ts, ate = _ate(tmp_path / "CameraTrajectory.txt", tum[2])
    assert len(ts) == N and ts[0] == pytest.approx(100.0) and ate < 0.03
    summary = json.load(open(tmp_path / "metrics.json"))
    assert summary["counters"]["frames"] == N
    assert summary["timers"]["track"]["n"] == N == summary["timers"]["load"]["n"]
    assert m.counters["frames"] == N


def test_cli_device_engine_chunked_with_tail(tum, tmp_path):
    """--chunk 3 over 7 frames: two chunks, then a 1-frame tail streamed."""
    m = _run(tum, tmp_path, "--mode", "slam", "--engine", "device",
             "--chunk", "3", "--max-frames", "7")
    ts, ate = _ate(tmp_path / "CameraTrajectory.txt", tum[2])
    assert len(ts) == 7 and ate < 0.03
    assert m.counters["frames"] == 7 and len(m.timers["track"]) == 3
    assert m.counters["keyframes"] >= 2
    assert not (tmp_path / "KeyFrameTrajectory.txt").exists()


@pytest.mark.parametrize("mode", ["slam", "slam+gicp"])
def test_cli_host_engine_equals_device_engine(tum, tmp_path, mode):
    """Both engines run `track_step` and the same mapping sequence; with
    loop closing they differ only in when detection runs."""
    _run(tum, tmp_path / "h", "--mode", mode, "--engine", "host")
    _run(tum, tmp_path / "d", "--mode", mode, "--engine", "device")
    _, ate_h = _ate(tmp_path / "h" / "CameraTrajectory.txt", tum[2])
    _, ate_d = _ate(tmp_path / "d" / "CameraTrajectory.txt", tum[2])
    assert ate_h < 0.03 and ate_d < 0.03
    # the host engine writes the rebuilt trajectory, the device engine the
    # tracked one: a few mm apart after local BA
    a = np.loadtxt(tmp_path / "h" / "CameraTrajectory.txt")
    b = np.loadtxt(tmp_path / "d" / "CameraTrajectory.txt")
    np.testing.assert_allclose(a, b, atol=0.02)
    for name in ("KeyFrameTrajectory.txt", "Histogram.csv", "metrics.json"):
        assert (tmp_path / "h" / name).exists()
    kfs = np.loadtxt(tmp_path / "h" / "KeyFrameTrajectory.txt").reshape(-1, 8)
    assert len(kfs) >= 2 and (np.diff(kfs[:, 0]) > 0).all()
    hist = open(tmp_path / "h" / "Histogram.csv").read().splitlines()
    assert hist[0] == "n_observations,n_landmarks" and len(hist) >= 3


def test_cli_checkpoint_then_resume_as_second_sequence(tum, tmp_path):
    ck = str(tmp_path / "ck")
    m1 = _run(tum, tmp_path / "a", "--mode", "slam+loop", "--engine", "host",
              "--checkpoint", ck, "--pose-prior", "1e6", "--chain-prior", "1e5")
    meta = json.load(open(ck + ".meta.json"))
    # the vocabulary trains once the map has 4 keyframes
    trained = meta["vocab_trained_on_kfs"] > 0
    for suffix in (".npz",) + ((".vocab.npz", ".loopdb.npz") if trained else ()):
        assert os.path.exists(ck + suffix), suffix
    assert meta["state"] in ("OK", "WEAK") and meta["kf_counter"] >= 2
    m2 = _run(tum, tmp_path / "b", "--mode", "slam+loop", "--engine", "host",
              "--resume", ck, "--max-frames", "5", "--export-cloud")
    ts, ate = _ate(tmp_path / "b" / "CameraTrajectory.txt", tum[2])
    # anchored against the loaded map, from the last keyframe's pose 40 cm
    # away (no vocabulary yet, so no relocalization): the second pass lies
    # within 5 cm of the first
    assert len(ts) == 5 and ate < 0.03
    first = np.loadtxt(tmp_path / "a" / "CameraTrajectory.txt")[:5]
    second = np.loadtxt(tmp_path / "b" / "CameraTrajectory.txt")
    np.testing.assert_allclose(second[:, 1:4], first[:, 1:4], atol=0.05)
    kfs = np.loadtxt(tmp_path / "b" / "KeyFrameTrajectory.txt").reshape(-1, 8)
    assert len(kfs) >= meta["n_kfs"] - 1
    ply = open(tmp_path / "b" / "map.ply").read().splitlines()
    assert ply[0] == "ply" and int(ply[2].split()[-1]) > 100
    assert m2.counters["host_reads"] > 0 and m1.counters["keyframes"] >= 2


@pytest.mark.parametrize("mode, det, des", [
    ("vo", "GFTT", "BRIEF"),
    ("vo", "DOG", "SIFT"),
    ("slam", "HARRIS", "LATCH"),
])
def test_cli_runs_every_family(tum, tmp_path, mode, det, des):
    """--detector / --descriptor select the other families (the float SIFT
    one in --mode vo): a trajectory with one finite row per frame."""
    m = _run(tum, tmp_path, "--mode", mode, "--detector", det,
             "--descriptor", des)
    ts, ate = _ate(tmp_path / "CameraTrajectory.txt", tum[2])
    assert len(ts) == N and ate < 0.03
    assert m.counters["frames"] == N


@pytest.mark.parametrize("flags, names", [
    (["--mode", "slam", "--descriptor", "SIFT"], "binary"),
    (["--detector", "FASTT"], r"unknown detector 'FASTT'; have \['DOG', "
                              r"'FAST', 'GFTT', 'HARRIS', 'HESSIAN', 'STAR'\]"),
    (["--descriptor", "ORBB"], r"unknown descriptor 'ORBB'; have \['BRIEF', "
                               r"'FREAK', 'LATCH', 'ORB', 'SIFT'\]"),
    (["--mode", "vo", "--render-map"], "utils/viewer.py"),
    (["--mode", "vo", "--viewer", "0"], "utils/webviewer.py"),
])
def test_cli_flags_that_wait_stop_with_a_named_error(tum, tmp_path, flags,
                                                     names):
    with pytest.raises(SystemExit, match=names):
        _run(tum, tmp_path, *flags)
    assert not (tmp_path / "CameraTrajectory.txt").exists()


@pytest.mark.parametrize("engine", ["device", "host"])
def test_cli_render_map_and_viewer(tum, tmp_path, engine):
    """--render-map writes map.png and --viewer 0 serves the map and the
    whole trajectory after the run, on either engine."""
    import urllib.request

    cfg, root, _ = tum
    flags = ["--chunk", "4"] if engine == "device" else []
    _, slam = cli.run(["--dataset", root, "--camera", "test", "--device",
                       "cpu", "--out-dir", str(tmp_path), "--mode", "slam",
                       "--engine", engine, "--render-map", "--viewer", "0",
                       "--viewer-every", "3", *flags], base_config=cfg)
    viewer = slam.viewer
    try:
        st = json.loads(urllib.request.urlopen(viewer.url + "state",
                                               timeout=10).read())
    finally:
        viewer.stop()
    assert os.path.getsize(tmp_path / "map.png") > 5000
    assert len(st["traj"]) == N and len(st["kfs"]) >= 2
    assert len(st["landmarks"]) > 50 and st["stats"]["frame"] == N - 1
    assert st["stats"]["keyframes"] == len(st["kfs"])
    assert st["seq"] >= 3                 # frames 0 (or 3), 6, 9 and the end
    # the served trajectory is the camera centres the run tracked
    assert trajectory.ate_rmse(np.asarray(st["traj"]),
                               trajectory.camera_centers(tum[2])) < 0.03


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_cli_default_device_without_cuda_stops(tum, tmp_path):
    cfg, root, _ = tum
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--dataset", root, "--camera", "test", "--mode", "vo",
                  "--out-dir", str(tmp_path)], base_config=cfg)
    assert not (tmp_path / "CameraTrajectory.txt").exists()
    assert cli._parser().parse_args(["--dataset", "x"]).device == "cuda"


def test_cli_build_config_follows_the_reference():
    """Same flags, same configuration as `aslam_tpu.main.build_config`."""
    import dataclasses

    from aslam_tpu import main as jcli

    for argv in (["--mode", "vo"], ["--mode", "slam"], ["--mode", "slam+loop"],
                 ["--mode", "slam+gicp", "--camera", "fr3"],
                 ["--pose-prior", "0", "--chain-prior", "123.5"],
                 ["--mode", "vo", "--detector", "SURF", "--descriptor", "SIFT"],
                 ["--detector", "CENSURE", "--descriptor", "BRISK"]):
        argv = ["--dataset", "x", *argv]
        ns = cli._parser().parse_args(argv)
        assert dataclasses.asdict(cli.build_config(ns)) == \
            dataclasses.asdict(jcli.build_config(ns)), argv

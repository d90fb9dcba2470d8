"""The port's viewers on the CPU: `utils/webviewer.py` serves what the JAX
package's `WebViewer` serves for the same inputs (numpy arrays, or the
port's tensors), and `utils/viewer.py` draws the map of both engines and a
match picture to PNGs, and counts the HUD's numbers, reading the map
through the counted host reads."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.utils.webviewer import WebViewer as JWebViewer
from aslam_tpu_torch.device import read_host
from aslam_tpu_torch.models.device_slam import DeviceSlam
from aslam_tpu_torch.models.system import SlamSystem
from aslam_tpu_torch.utils import dataset, viewer
from aslam_tpu_torch.utils.webviewer import WebViewer


class _Map:
    """The four fields a viewer reads, as a MapState carries them."""

    def __init__(self, rng, n_lm=2000, n_kf=6, to=np.asarray):
        lm_pos = rng.normal(0, 2, (n_lm, 3)).astype(np.float32)
        lm_valid = rng.random(n_lm) > 0.3
        T = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
        T[:, :3, 3] = rng.normal(0, 1, (n_kf, 3))
        kf_valid = np.arange(n_kf) % 3 != 1
        self.lm_pos, self.lm_valid = to(lm_pos), to(lm_valid)
        self.kf_T_cw, self.kf_valid = to(T), to(kf_valid)


def _state(v, path="state"):
    return json.loads(urllib.request.urlopen(v.url + path, timeout=10).read())


@pytest.mark.parametrize("as_tensors", [False, True])
def test_webviewer_serves_the_reference_state(as_tensors):
    """Same map, trajectory and stats -> the same JSON as the reference's
    viewer, landmark thinning included (max_landmarks below the count)."""
    rng = np.random.default_rng(0)
    m = _Map(rng)
    traj = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    traj[:, :3, 3] = rng.normal(0, 1, (5, 3))
    stats = {"keyframes": 4, "fps": 12.3456, "frame": 9}
    mt = _Map(np.random.default_rng(0), to=torch.from_numpy) if as_tensors \
        else m
    tt = torch.from_numpy(traj) if as_tensors else traj
    ref, port = JWebViewer(port=0, max_landmarks=500), \
        WebViewer(port=0, max_landmarks=500)
    try:
        for v, mm, tr in ((ref, m, traj), (port, mt, tt)):
            v.update(mm, traj=tr, stats=stats)
            v.update(traj=tr[:, :3, 3])          # [N,3] positions too
        a, b = _state(ref), _state(port)
        assert a == b
        assert len(b["kfs"]) == 4 and b["seq"] == 2 and len(b["traj"]) == 5
        page = urllib.request.urlopen(port.url, timeout=10).read()
        assert page == urllib.request.urlopen(ref.url, timeout=10).read()
        with pytest.raises(urllib.error.HTTPError):
            _state(port, "nope")
    finally:
        ref.stop()
        port.stop()


@pytest.fixture(scope="module")
def engines():
    """The port's host and device engines over 6 frames of the parity walk."""
    cfg = P.port_config(small_config())
    imgs, deps, _ = P.walk(6)
    host, dev = SlamSystem(cfg, "cpu"), DeviceSlam(cfg, "cpu")
    for i in range(len(imgs)):
        host.process(imgs[i], deps[i], t=0.033 * i)
        dev.process(imgs[i], deps[i], t=0.033 * i)
    dev.finish()
    return host, dev


@pytest.mark.parametrize("which", ["host", "device"])
def test_render_map_draws_either_engine(engines, tmp_path, which):
    slam = engines[0] if which == "host" else engines[1]
    reads = read_host.count
    hud = viewer.hud_counters(slam)
    assert read_host.count == reads + 1             # one read for the HUD
    assert hud["keyframes"] >= 2 and hud["landmarks"] > 50
    assert hud["frames_processed"] == 6 and hud["frame_matches"] >= 30
    path = str(tmp_path / "map.png")
    viewer.render_map(slam, path)
    assert os.path.getsize(path) > 5000
    img = dataset.decode_png_zlib(path)
    assert img.shape == (800, 800, 3)
    # keyframes red, landmarks grey, trajectory blue, all on the picture
    for rgb in ((229, 62, 62), (136, 136, 136), (43, 108, 176)):
        assert (img == rgb).all(-1).sum() > 3, rgb


def test_draw_matches_writes_a_png(tmp_path):
    rng = np.random.default_rng(1)
    img1 = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    img2 = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy1 = rng.uniform(10, 150, (30, 2)).astype(np.float32)
    xy2 = rng.uniform(10, 110, (30, 2)).astype(np.float32)
    match_idx = np.arange(30, dtype=np.int32)
    match_idx[10:] = -1
    path = str(tmp_path / "matches.png")
    viewer.draw_matches(torch.from_numpy(img1), torch.from_numpy(xy1), img2,
                        xy2, torch.from_numpy(match_idx), path)
    assert os.path.getsize(path) > 5000
    img = dataset.decode_png_zlib(path)
    assert img.shape == (120, 320, 3)
    assert (img == (229, 62, 62)).all(-1).sum() >= 9 * 5     # 10 red dots

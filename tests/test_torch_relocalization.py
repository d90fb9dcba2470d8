"""Parity of the port's relocalization (`LoopClosing.relocalize`,
`_reloc_verify`) with the JAX package's: the three cases of
tests/test_relocalization.py on the hand-built looped map, the port fed the
reference's vocabulary, database and RANSAC draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as P
from aslam_tpu.models import loopclosing as jlc
from aslam_tpu.models.extractor import Features
from aslam_tpu.models.frame import FrameData
from aslam_tpu.utils import camera
from aslam_tpu_torch import convert
from aslam_tpu_torch.device import read_host
from aslam_tpu_torch.models import loopclosing as tlc

N_KFS = 20


def frame_from_kf(m, cfg, slot, pose):
    """A FrameData with the observations of keyframe `slot`
    (tests/test_relocalization.py:15)."""
    M = m.kf_lm.shape[1]
    xy, z = m.kf_xy[slot], m.kf_z[slot]
    feat = Features(xy=xy, response=jnp.ones(M), angle=jnp.zeros(M),
                    octave=jnp.zeros(M, jnp.int32), desc=m.kf_desc[slot],
                    valid=m.kf_kp_valid[slot])
    return FrameData(feat=feat, xy_und=xy,
                     p3d=camera.unproject(cfg.camera, xy, z), ur=m.kf_ur[slot],
                     depth=z, has_depth=z > 0, T_cw=jnp.asarray(pose),
                     depth_map=jnp.zeros((1, 1)))


def random_frame(m, cfg, rng):
    M = m.kf_lm.shape[1]
    feat = Features(
        xy=jnp.asarray(rng.uniform(10, 300, (M, 2)).astype(np.float32)),
        response=jnp.ones(M), angle=jnp.zeros(M),
        octave=jnp.zeros(M, jnp.int32),
        desc=jnp.asarray(rng.integers(0, 2**32, (M, 8), dtype=np.uint32)),
        valid=jnp.ones(M, bool))
    z = jnp.asarray(rng.uniform(0.5, 3.0, M).astype(np.float32))
    return FrameData(feat=feat, xy_und=feat.xy,
                     p3d=camera.unproject(cfg.camera, feat.xy, z),
                     ur=jnp.full(M, -1.0), depth=z, has_depth=z > 0,
                     T_cw=jnp.eye(4), depth_map=jnp.zeros((1, 1)))


@pytest.fixture(scope="module")
def world():
    cfg, pcfg, mt, mj, *_ = P.looped()
    lj = jlc.LoopClosing(cfg, train_after_kfs=4)
    lj._maybe_train_vocab(mj)
    assert lj.vocab is not None
    for k in range(N_KFS):
        lj.db = jlc.add_keyframe(lj.db, lj.vocab, mj.kf_desc[k],
                                 mj.kf_kp_valid[k], jnp.int32(k))
    return cfg, pcfg, mt, mj, lj


def _both(world, lost):
    """`relocalize` in the reference (its draws recorded) and in the port
    (fed them) -> (T_j, T_t, host reads of the port, candidates tried)."""
    cfg, pcfg, mt, mj, lj = world
    with P.HostSpy(cfg) as spy:
        T_j = lj.relocalize(mj, lost)
    lt = tlc.LoopClosing(pcfg, "cpu", train_after_kfs=4)
    convert.loop_closing_state(lj, lt)
    lt.verify_draws = [P.t(d) for d in spy.reloc_draws]
    reads = read_host.count
    T_t = lt.relocalize(mt, convert.frame_data(P.tree_np(lost), "cpu"))
    assert not lt.verify_draws
    return T_j, T_t, read_host.count - reads, len(spy.reloc_draws)


def test_relocalize_recovers_pose(world):
    cfg, _, mt, mj, _ = world
    # a "lost" frame that sees what KF 5 saw, at a garbage pose
    lost = frame_from_kf(mj, cfg, 5, np.eye(4, dtype=np.float32))
    T_j, T_t, reads, tried = _both(world, lost)
    assert T_j is not None and T_t is not None
    np.testing.assert_allclose(T_t, T_j, atol=1e-4)
    err = np.linalg.norm(T_t[:3, 3] - P.n(mt.kf_T_cw[5])[:3, 3])
    assert err < 0.02, err
    assert reads == 1 + tried            # the scores, then one per candidate


def test_relocalize_returns_none_without_vocab(world):
    cfg, pcfg, mt, mj, _ = world
    lost = frame_from_kf(mj, cfg, 0, np.eye(4, dtype=np.float32))
    assert jlc.LoopClosing(cfg).relocalize(mj, lost) is None
    reads = read_host.count
    lt = tlc.LoopClosing(pcfg, "cpu")
    assert lt.relocalize(mt, convert.frame_data(P.tree_np(lost), "cpu")) is None
    assert read_host.count == reads


def test_relocalize_rejects_unseen_place(world):
    cfg, _, mt, mj, _ = world
    lost = random_frame(mj, cfg, np.random.default_rng(0))
    T_j, T_t, reads, tried = _both(world, lost)
    assert T_j is None and T_t is None
    assert reads == 1 + tried

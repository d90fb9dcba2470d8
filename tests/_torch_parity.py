"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*).

Each such test feeds the same numpy inputs, made from a seed, to a function
of the JAX package and to its counterpart in `aslam_tpu_torch`, both on the
CPU, and compares the outputs.  Data crosses between the two as numpy
arrays.  Packed descriptors are uint32 words in JAX and int32 words (the
same bit patterns) in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# xdist runs several workers on one machine: keep each one's intra-op pool small
torch.set_num_threads(2)


def t(a) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (uint32 words viewed as int32)."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def n(x) -> np.ndarray:
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def words(x) -> np.ndarray:
    """Packed descriptor words from either side as int32 bit patterns."""
    a = n(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def tree_np(x):
    """A jax pytree (NamedTuples of arrays) -> the same tree of numpy arrays."""
    import jax

    return jax.tree.map(np.asarray, x)


def port_config(ref_cfg):
    """The reference's SystemConfig -> the port's equal one."""
    from aslam_tpu_torch import convert

    return convert.system_config(dataclasses.asdict(ref_cfg))


def walk(n_frames: int = 10, cam=None):
    """The synthetic walk of tests/test_device_slam.py (seed 4, 500 points,
    step 5 cm / 0.02 rad, textures seed 5) -> (imgs, depths) float32, poses."""
    from aslam_tpu.config import small_config
    from aslam_tpu.utils import synthetic

    cam = cam or small_config().camera
    rng = np.random.default_rng(4)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(n_frames, step_t=0.05, step_r=0.02,
                                        rng=rng)
    tex = synthetic.point_textures(500, seed=5)
    imgs = np.stack([synthetic.render_intensity_image(cam, T, pts, tex)
                     for T in poses])
    depths = np.stack([synthetic.render_depth_image(cam, T, pts, splat=4)
                       for T in poses])
    return imgs, depths, poses


def jax_walk_states(cfg, imgs, depths, seed: int = 0):
    """The reference's DeviceSlam (inline mapping) over the frames, one
    `process` at a time -> (the DeviceSlam, [(numpy SlamState, PRNG key)
    before each frame > 0])."""
    from aslam_tpu.models.device_slam import DeviceSlam

    dev = DeviceSlam(cfg, seed=seed, sync_every=4)
    before = []
    for i in range(len(imgs)):
        if i:
            before.append((tree_np(dev.state), dev.key))
        dev.process(imgs[i], depths[i], t=i * 0.033)
    return dev, before


def port_map(m):
    """A reference MapState (numpy or jax) -> the port's, on the CPU."""
    from aslam_tpu_torch import convert

    return convert.map_state(tree_np(m), "cpu")


def assert_maps_equal(mt, mj, atol=1e-5, skip=()):
    """Every field of a port MapState against the reference's: integer and
    boolean fields exactly, float fields to `atol`."""
    for name in mt._fields:
        if name in skip:
            continue
        a, b = n(getattr(mt, name)), words(getattr(mj, name))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def jtree(x):
    """A pytree of numpy arrays -> the same tree of jax arrays."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, x)


def ref_map(mt):
    """The port's MapState -> the reference's (jax arrays, uint32 words)."""
    import jax.numpy as jnp

    from aslam_tpu.models import mapstate as jms

    def conv(name):
        a = n(getattr(mt, name))
        return jnp.asarray(a.view(np.uint32) if name.endswith("desc") else a)

    return jms.MapState(**{name: conv(name) for name in jms.MapState._fields})


def looped(seed: int = 1234, **kw):
    """The hand-built looped map of tests/test_loopclosing.py at
    small_config, made by the port's `looped_map` -> (reference config,
    port config, port map, reference map, T_true, T_est, drift)."""
    from aslam_tpu.config import small_config
    from aslam_tpu_torch.profile_slam import looped_map

    cfg = small_config()
    pcfg = port_config(cfg)
    mt, T_true, T_est, drift = looped_map(pcfg, "cpu", seed=seed, **kw)
    return cfg, pcfg, mt, ref_map(mt), T_true, T_est, drift


def ref_draws(f1, f2, key, cfg):
    """The samples the reference's odometry draws for this frame pair
    (`aslam_tpu/ops/ransac.py:113`)."""
    import jax

    from aslam_tpu.ops import matching as jmatch

    m = jmatch.resolve_duplicates(jmatch.knn_ratio_match(
        f1.feat.desc, f1.feat.valid, f2.feat.desc, f2.feat.valid,
        ratio=cfg.matcher.ratio_frame, max_dist=float(cfg.matcher.th_high)),
        f2.feat.desc.shape[0])
    tgt = np.maximum(np.asarray(m.target_idx), 0)
    p1, p2 = np.asarray(f1.p3d), np.asarray(f2.p3d)[tgt]
    good = (np.asarray(m.valid) & np.asarray(f1.has_depth)
            & np.asarray(f2.has_depth)[tgt] & (p1[:, 2] > 0) & (p2[:, 2] > 0))
    r = cfg.ransac
    return np.asarray(jax.random.randint(
        key, (r.n_hypotheses, r.sample_size), 0, max(int(good.sum()), 1)))


class HostSpy:
    """Records what the reference's host engine does, frame by frame, so
    that the port can be fed the same frames and the same random draws:

      frames      every FrameData `make_frame` returned (numpy), in order;
      steps       per `track_step` call: its arguments (numpy, taken before
                  the call donates the map), the RANSAC draws of its key,
                  and its outputs;
      reloc_draws the RANSAC draws of every `_reloc_verify` call.

    Use as a context manager around the reference run."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.frames, self.steps, self.reloc_draws = [], [], []

    def __enter__(self):
        import jax
        import jax.numpy as jnp

        from aslam_tpu.models import frame as jframe
        from aslam_tpu.models import loopclosing as jlc
        from aslam_tpu.models import tracking as jtr
        from aslam_tpu.utils import camera as jcam

        self._saved = [(jframe, "make_frame", jframe.make_frame),
                       (jtr, "track_step", jtr.track_step),
                       (jlc, "_reloc_verify", jlc._reloc_verify)]
        make_frame, track_step, reloc_verify = (f for _, _, f in self._saved)

        def spy_frame(img, depth, cfg, state):
            frame, ad = make_frame(img, depth, cfg, state)
            self.frames.append(tree_np(frame))
            return frame, ad

        def spy_step(m, last_frame, last_assoc, frame, last_kf_T, key, cfg):
            args = dict(m=tree_np(m), last_frame=tree_np(last_frame),
                        last_assoc=np.asarray(last_assoc),
                        frame=tree_np(frame), last_kf_T=np.asarray(last_kf_T),
                        key=key)
            draws = ref_draws(last_frame, frame, key, cfg)
            out = track_step(m, last_frame, last_assoc, frame, last_kf_T, key,
                             cfg)
            self.steps.append(dict(args, draws=draws, out=tree_np(out)))
            return out

        def spy_reloc(db, m, cand, desc, valid, words, p3d, has_depth, key,
                      cfg):
            mm = jlc.bow_guided_match(
                db.kf_words[cand], m.kf_desc[cand], m.kf_kp_valid[cand],
                words, desc, valid, cfg)
            tgt = jnp.maximum(mm.target_idx, 0)
            p_kf = jcam.unproject(cfg.camera, m.kf_xy[cand], m.kf_z[cand])
            good = mm.valid & (m.kf_z[cand] > 0) & has_depth[tgt] \
                & (p_kf[:, 2] > 0) & (p3d[tgt][:, 2] > 0)
            r = cfg.ransac
            self.reloc_draws.append(np.asarray(jax.random.randint(
                key, (r.n_hypotheses, r.sample_size), 0,
                max(int(good.sum()), 1))))
            return reloc_verify(db, m, cand, desc, valid, words, p3d,
                                has_depth, key, cfg)

        jframe.make_frame = spy_frame
        jtr.track_step = spy_step
        jlc._reloc_verify = spy_reloc
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def replay_host(slam_t, spy, frames, ts, new_sequence_at=()):
    """Feed the port's SlamSystem the reference's frames `frames` (indices
    into `spy.frames`) with the reference's draws -> [(T, info, state)]."""
    from aslam_tpu_torch import convert

    tr = slam_t.tracking
    tr.ransac_draws = [t(s["draws"]) for s in spy.steps]
    if slam_t.loop_closing is not None:
        slam_t.loop_closing.verify_draws = [t(d) for d in spy.reloc_draws]
    out = []
    for i, stamp in zip(frames, ts):
        if i in new_sequence_at:
            slam_t.new_sequence()
        T, info = slam_t.process_frame(
            convert.frame_data(spy.frames[i], "cpu"), stamp)
        out.append((T, info, tr.state))
    return out

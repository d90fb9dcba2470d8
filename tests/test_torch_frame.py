"""Whole-frame parity of the port's `_make_frame_impl` with the JAX package on
synthetic RGB-D frames, adaptive mode on and off.

The two pyramids differ by up to a few 1e-4 gray levels (a few resize
weights an ulp apart, products rounded in another order), so a FAST
response near its threshold can flip on levels > 0 and the comparison
is statistical: keypoints are paired by octave and position, then their
descriptors and backprojections must agree."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as P
from aslam_tpu.config import small_config
from aslam_tpu.models import frame as jframe
from aslam_tpu.ops import pyramid as jpyr
from aslam_tpu.utils import synthetic
from aslam_tpu_torch import convert
from aslam_tpu_torch.models import frame as tframe
from aslam_tpu_torch.ops import orb as torb


def _pairs(jf, tf):
    """For each JAX valid keypoint, the nearest port valid keypoint at the
    same octave -> (jax index, port index, distance px) of paired ones."""
    jv, tv = np.asarray(jf.feat.valid), P.n(tf.feat.valid)
    jxy, txy = np.asarray(jf.feat.xy), P.n(tf.feat.xy)
    joct, toct = np.asarray(jf.feat.octave), P.n(tf.feat.octave)
    ji, ti = np.nonzero(jv)[0], np.nonzero(tv)[0]
    d = np.linalg.norm(jxy[ji, None] - txy[None, ti], axis=-1)
    d = np.where(joct[ji, None] == toct[None, ti], d, np.inf)
    best = d.argmin(1)
    dist = d[np.arange(len(ji)), best]
    return ji, ti[best], dist


def _pair_margins(img, jf, ji, cfg):
    """|I(p1') - I(p2')| of every rBRIEF test of the JAX keypoints `ji`, read
    in the JAX package's own blurred pyramid level -> [len(ji), 256]."""
    levels = jpyr.build_pyramid(jnp.asarray(img, jnp.float32),
                                cfg.extractor.n_levels, cfg.extractor.scale_factor)
    xy = np.asarray(jf.feat.xy)[ji]
    octave = np.asarray(jf.feat.octave)[ji]
    bins = P.n(torb.angle_bins(P.t(jf.feat.angle)))[ji]
    table = torb._binned_pair_index()[bins]                     # [K,256,2]
    out = np.zeros((len(ji), 256), np.float32)
    for o in np.unique(octave):
        s = octave == o
        blur = np.asarray(jpyr.gaussian_blur(levels[o]))
        xy_l = xy[s] / cfg.extractor.scale_factors[o]
        flat = P.n(torb.extract_patches(P.t(blur), P.t(xy_l))).reshape(s.sum(), -1)
        pix = np.take_along_axis(flat[:, None, :], table[s], axis=2)
        out[s] = np.abs(pix[..., 0] - pix[..., 1])
    return out


@pytest.mark.parametrize("adaptive", [True, False])
def test_make_frame_matches_reference(adaptive):
    cfg = small_config()
    cfg = cfg.replace(extractor=dataclasses.replace(cfg.extractor,
                                                    adaptive=adaptive))
    cam = cfg.camera
    imgs, depths, _, _ = synthetic.make_sequence(n_frames=3, n_points=500, seed=3)
    img = np.clip(imgs[2], 0, 255).astype(np.uint8)
    depth = np.clip(depths[2] / cam.depth_factor, 0, 65535).astype(np.uint16)
    grid = np.array([[20.0, 14.0, 26.0], [17.0, 20.0, 9.0], [31.0, 20.0, 12.0]],
                    np.float32)

    jf, jgrid = jframe._make_frame_impl(jnp.asarray(img), jnp.asarray(depth),
                                        jnp.asarray(grid), cfg, *img.shape)
    tf, tgrid = tframe._make_frame_impl(P.t(img), P.t(depth),
                                        convert.grid_thresholds(grid, "cpu"),
                                        P.port_config(cfg))

    np.testing.assert_allclose(P.n(tgrid), np.asarray(jgrid), atol=1e-6)
    if not adaptive:
        np.testing.assert_array_equal(P.n(tgrid), grid)
    np.testing.assert_array_equal(P.n(tf.depth_map), np.asarray(jf.depth_map))

    n_valid = int(np.asarray(jf.feat.valid).sum())
    assert n_valid > 150
    ji, ti, dist = _pairs(jf, tf)
    paired = dist <= 0.5
    assert paired.mean() >= 0.95, paired.mean()
    ji, ti = ji[paired], ti[paired]

    jbits = P.n(torb.unpack_bits(P.t(jf.feat.desc)))[ji]
    tbits = P.n(torb.unpack_bits(tf.feat.desc))[ti]
    octave = np.asarray(jf.feat.octave)[ji]
    # level 0 is the same image on both sides: the same bits
    base = octave == 0
    assert base.sum() > 30
    assert (jbits[base] == tbits[base]).mean() >= 0.99
    # on resized levels a bit compares two pixels that can be equal up to
    # float rounding (the flat background of the synthetic scene); there the
    # small pyramid difference decides the bit.  So: most bits agree, and
    # every bit that differs is such a near tie in the reference's image.
    assert (jbits == tbits).mean() >= 0.9
    margin = _pair_margins(img, jf, ji, cfg)
    same_bin = (P.n(torb.angle_bins(P.t(jf.feat.angle)))[ji]
                == P.n(torb.angle_bins(tf.feat.angle))[ti])
    differ = (jbits != tbits) & same_bin[:, None]
    assert differ[base].sum() == 0
    assert (margin[differ] <= 0.01).all(), margin[differ].max()

    jd, td = np.asarray(jf.has_depth)[ji], P.n(tf.has_depth)[ti]
    both = jd & td
    assert both.mean() >= 0.9 * jd.mean()
    np.testing.assert_allclose(P.n(tf.p3d)[ti][both], np.asarray(jf.p3d)[ji][both],
                               atol=1e-3)

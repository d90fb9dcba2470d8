"""Parity of the port's front-end ops (pyramid, blur, FAST, NMS, adaptive
grid, grid top-k, sub-pixel, IC angle, rBRIEF) with the JAX package.

The pyramid is compared within 1e-2 gray levels: the port builds its
resize weights in the float32 arithmetic JAX's jitted resize uses, but a
few of them sit an ulp apart and the products round in another order, so
the two are a few 1e-4 apart, not bit-identical.  Every other op is given the SAME numpy level image (taken
from the JAX pyramid), and then integer outputs must be equal and float
outputs equal to float32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as P
from aslam_tpu.ops import fast as jfast
from aslam_tpu.ops import orb as jorb
from aslam_tpu.ops import pyramid as jpyr
from aslam_tpu.ops import select as jsel
from aslam_tpu.utils import synthetic
from aslam_tpu_torch.ops import fast as tfast
from aslam_tpu_torch.ops import orb as torb
from aslam_tpu_torch.ops import pyramid as tpyr
from aslam_tpu_torch.ops import select as tsel

GRID = np.array([[20.0, 15.0, 25.0], [10.0, 20.0, 30.0], [7.0, 12.0, 18.0]],
                np.float32)
N_LEVELS, SCALE = 4, 1.2


@pytest.fixture(scope="module")
def frame():
    imgs, _, _, _ = synthetic.make_sequence(n_frames=2, n_points=500, seed=3)
    return np.array(imgs[1], np.float32)


@pytest.fixture(scope="module")
def levels(frame):
    return [np.asarray(l) for l in
            jpyr.build_pyramid(jnp.asarray(frame), N_LEVELS, SCALE)]


@pytest.fixture(scope="module")
def level_ops(levels):
    """FAST -> NMS -> interior -> grid top-k on JAX level 1, as numpy."""
    img = levels[1]
    h, w = img.shape
    th = np.asarray(jfast.threshold_map_from_grid(jnp.asarray(GRID), h, w))
    raw = np.asarray(jfast.fast_response(jnp.asarray(img), jnp.asarray(th)))
    nms = np.asarray(jfast.nms_3x3(jnp.asarray(raw)))
    b = jorb.PATCH_RADIUS + 1
    interior = np.zeros_like(nms, bool)
    interior[b:h - b, b:w - b] = True
    nms = np.where(interior, nms, 0.0).astype(np.float32)
    xy, resp, valid = (np.asarray(a) for a in
                       jsel.grid_topk(jnp.asarray(nms), 32, 8, 200))
    return dict(img=img, th=th, raw=raw, nms=nms, xy=xy, resp=resp, valid=valid)


def test_build_pyramid_matches_reference(frame, levels):
    out = tpyr.build_pyramid(P.t(frame), N_LEVELS, SCALE)
    assert [tuple(o.shape) for o in out] == [l.shape for l in levels]
    for o, l in zip(out, levels):
        np.testing.assert_allclose(P.n(o), l, atol=1e-2)


@pytest.mark.parametrize("level", [0, 1, 3])
def test_gaussian_blur_matches_reference(levels, level):
    img = levels[level]
    ref = np.asarray(jpyr.gaussian_blur(jnp.asarray(img)))
    np.testing.assert_allclose(P.n(tpyr.gaussian_blur(P.t(img))), ref, atol=1e-4)


@pytest.mark.parametrize("level", [0, 1, 3])
def test_fast_response_matches_reference(levels, level):
    img = levels[level]
    h, w = img.shape
    th = np.asarray(jfast.threshold_map_from_grid(jnp.asarray(GRID), h, w))
    ref = np.asarray(jfast.fast_response(jnp.asarray(img), jnp.asarray(th)))
    out = P.n(tfast.fast_response(P.t(img), P.t(th)))
    assert (ref > 0).sum() > 50
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # scalar threshold
    ref_s = np.asarray(jfast.fast_response(jnp.asarray(img), 20.0))
    np.testing.assert_allclose(P.n(tfast.fast_response(P.t(img), 20.0)), ref_s,
                               atol=1e-4)


def test_nms_matches_reference(level_ops):
    raw = level_ops["raw"].copy()
    raw[50:53, 60:63] = 7.0            # a flat plateau: raster tie break
    ref = np.asarray(jfast.nms_3x3(jnp.asarray(raw)))
    np.testing.assert_array_equal(P.n(tfast.nms_3x3(P.t(raw))), ref)


@pytest.mark.parametrize("shape", [(240, 320), (139, 185), (47, 61)])
def test_threshold_map_matches_reference(shape):
    ref = np.asarray(jfast.threshold_map_from_grid(jnp.asarray(GRID), *shape))
    np.testing.assert_array_equal(
        P.n(tfast.threshold_map_from_grid(P.t(GRID), *shape)), ref)


def test_counts_and_adaptive_update_match_reference(level_ops):
    nms = level_ops["nms"]
    ref = np.asarray(jfast.counts_per_grid_cell(jnp.asarray(nms), 3, 3))
    out = P.n(tfast.counts_per_grid_cell(P.t(nms), 3, 3))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    counts = np.array([[0, 66, 200], [67, 113, 114], [1000, 5, 80]], np.int32)
    grid = GRID.copy()
    grid[0, 0], grid[2, 0] = 2.5, 79.0   # drive the clamps
    kw = dict(min_count=600 / 9, max_count=1020 / 9, down=0.7, up=1.3,
              th_min=2.0, th_max=80.0)
    ref_g = np.asarray(jfast.adaptive_threshold_update(
        jnp.asarray(grid), jnp.asarray(counts), **kw))
    out_g = P.n(tfast.adaptive_threshold_update(P.t(grid), P.t(counts), **kw))
    np.testing.assert_array_equal(out_g, ref_g)


@pytest.mark.parametrize("k_cell,n_out", [(8, 200), (2, 40), (8, 2000)])
def test_grid_topk_matches_reference(level_ops, k_cell, n_out):
    nms = level_ops["nms"].copy()
    nms[40, 40] = nms[40, 48] = nms[41, 60] = 9.0      # equal responses tie
    ref = [np.asarray(a) for a in jsel.grid_topk(jnp.asarray(nms), 32, k_cell, n_out)]
    out = [P.n(a) for a in tsel.grid_topk(P.t(nms), 32, k_cell, n_out)]
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


def test_subpixel_refine_matches_reference(level_ops):
    ref = np.asarray(jsel.subpixel_refine(jnp.asarray(level_ops["raw"]),
                                          jnp.asarray(level_ops["xy"])))
    out = P.n(tsel.subpixel_refine(P.t(level_ops["raw"]), P.t(level_ops["xy"])))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_orb_angles_and_descriptors_match_reference(level_ops):
    blur = np.asarray(jpyr.gaussian_blur(jnp.asarray(level_ops["img"])))
    xy = level_ops["xy"][level_ops["valid"]]
    assert len(xy) > 100
    patches_j = jorb.extract_patches(jnp.asarray(blur), jnp.asarray(xy))
    patches_t = torb.extract_patches(P.t(blur), P.t(xy))
    np.testing.assert_array_equal(P.n(patches_t), np.asarray(patches_j))

    ang_j = np.asarray(jorb.ic_angle(patches_j))
    ang_t = torb.ic_angle(patches_t)
    two_pi = 2.0 * np.pi
    bins_j = np.mod(np.round(np.mod(ang_j, two_pi) / two_pi * 30).astype(np.int32), 30)
    bins_t = P.n(torb.angle_bins(ang_t))
    agree = bins_j == bins_t
    assert agree.mean() >= 0.99, agree.mean()

    bits_j = np.asarray(jorb.brief_descriptors(patches_j, jnp.asarray(ang_j)))
    bits_t = P.n(torb.brief_descriptors(patches_t, ang_t))
    np.testing.assert_array_equal(bits_t[agree], bits_j[agree])

    # the reference's bins given to both: every bit equal
    bits_t_ref_angle = P.n(torb.brief_descriptors(patches_t, P.t(ang_j)))
    np.testing.assert_array_equal(bits_t_ref_angle, bits_j)


def test_pack_unpack_match_reference():
    rng = np.random.default_rng(5)
    bits = rng.random((64, 256)) > 0.5
    bits[0] = True                      # bit 31 of every word set
    ref = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    out = torb.pack_bits(P.t(bits))
    np.testing.assert_array_equal(P.words(out), P.words(ref))
    np.testing.assert_array_equal(P.n(torb.unpack_bits(out)), bits)
    np.testing.assert_array_equal(
        P.n(torb.unpack_bits(P.t(ref))), np.asarray(jorb.unpack_bits(jnp.asarray(ref))))

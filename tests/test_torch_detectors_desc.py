"""Parity of the port's detector and descriptor families with the JAX package,
on the CPU, on the same numpy images: `ops/detectors.py` (every response, the
box sum, the registry), `ops/desc.py` (the seeded patterns, every
descriptor), the float L2 path of `ops/hamming.py` and `ops/matching.py`, and
`models/extractor.py::extract_features` for five detector x descriptor pairs.

Tolerances: box sums and binary descriptor bits exact; responses to rtol 1e-5
with equal masks (a pixel whose raw response lies within 1e-3 of the
threshold may fall either way); SIFT descriptors and L2 distances to 1e-5.
The fixtures are those of tests/test_detectors_desc.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.config import ExtractorConfig, small_config
from aslam_tpu.models import extractor as jext
from aslam_tpu.ops import desc as jdesc
from aslam_tpu.ops import detectors as jdet
from aslam_tpu.ops import hamming as jham
from aslam_tpu.ops import matching as jmatch
from aslam_tpu.ops import pyramid as jpyr
from aslam_tpu.utils import synthetic
from aslam_tpu_torch.models import extractor as text
from aslam_tpu_torch.ops import desc as tdesc
from aslam_tpu_torch.ops import detectors as tdet
from aslam_tpu_torch.ops import hamming as tham
from aslam_tpu_torch.ops import matching as tmatch

FAMILIES = ["FAST", "GFTT", "HARRIS", "DOG", "HESSIAN", "STAR"]
DESCRIPTORS = ["ORB", "BRIEF", "FREAK", "LATCH", "SIFT"]


# ---------------------------------------------------------------- fixtures

def checkerboard(h=120, w=160, sq=20, lo=40.0, hi=220.0):
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.where(((ys // sq) + (xs // sq)) % 2 == 0, lo, hi)
    return img.astype(np.float32)


def blob_image(h=120, w=160, centers=((40, 50), (80, 110)), sigma=3.0):
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.full((h, w), 60.0)
    for (cy, cx) in centers:
        img += 160.0 * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))
    return img.astype(np.float32)


def textured(h=160, w=200, seed=3):
    """Smooth random texture with enough structure for every detector."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))
    img += rng.normal(0, 2.0, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


IMAGES = {"checkerboard": checkerboard, "blobs": blob_image,
          "textured": textured}


def _threshold_map(img, seed=0):
    """A per-pixel threshold map of 3x3 cells, as the adaptive grid makes."""
    rng = np.random.default_rng(seed)
    grid = rng.uniform(1.0, 6.0, (3, 3)).astype(np.float32)
    h, w = img.shape
    rows = np.minimum(np.arange(h) * 3 // h, 2)
    cols = np.minimum(np.arange(w) * 3 // w, 2)
    return grid[rows[:, None], cols[None, :]]


def _keypoints(img, n=300, seed=1):
    rng = np.random.default_rng(seed)
    h, w = img.shape
    return np.stack([rng.uniform(16, w - 17, n),
                     rng.uniform(16, h - 17, n)], 1).astype(np.float32)


# ---------------------------------------------------------------- detectors

@pytest.mark.parametrize("n", [3, 5, 9, 13, 17, 25])
def test_box_sum_matches_reference(n):
    img = textured()
    ref = np.asarray(jdet._box_sum(jnp.asarray(img), n))
    np.testing.assert_array_equal(P.n(tdet._box_sum(P.t(img), n)), ref)


def test_sobel_and_structure_tensor_match_reference():
    img = textured()
    for a, b in zip(tdet.sobel_gradients(P.t(img)),
                    jdet.sobel_gradients(jnp.asarray(img))):
        np.testing.assert_array_equal(P.n(a), np.asarray(b))
    for a, b in zip(tdet.structure_tensor(P.t(img)),
                    jdet.structure_tensor(jnp.asarray(img))):
        np.testing.assert_allclose(P.n(a), np.asarray(b), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("image", sorted(IMAGES))
@pytest.mark.parametrize("family", FAMILIES)
def test_response_matches_reference(family, image):
    img = IMAGES[image]()
    thr = _threshold_map(img)
    ref = np.asarray(jdet.response(family, jnp.asarray(img), jnp.asarray(thr)))
    out = P.n(tdet.response(family, P.t(img), P.t(thr)))
    differ = (ref > 0) != (out > 0)
    # a flipped pixel is one whose response sits on the threshold
    raw = np.maximum(ref, out)
    assert (np.abs(raw[differ] - thr[differ]) <= 1e-3 * thr[differ]).all()
    both = (ref > 0) & (out > 0)
    if image == "textured":   # FAST, rightly, finds no X-corner
        assert both.sum() > 100
    np.testing.assert_allclose(out[both], ref[both], rtol=1e-5, atol=1e-5)


def test_fast_detect_matches_reference():
    from aslam_tpu.ops import fast as jfast
    from aslam_tpu_torch.ops import fast as tfast

    img = textured()
    thr = _threshold_map(img) * 4.0
    ref = np.asarray(jfast.detect(jnp.asarray(img), jnp.asarray(thr)))
    out = P.n(tfast.detect(P.t(img), P.t(thr)))
    assert (ref > 0).sum() > 100
    np.testing.assert_array_equal(out, ref)


def test_registry_matches_reference():
    assert tdet.DETECTOR_DEFAULTS == jdet.DETECTOR_DEFAULTS
    assert tdet.DETECTOR_ALIASES == jdet.DETECTOR_ALIASES
    for name in ["fast", "Shi_Tomasi", "SIFT", "SURF", "CENSURE", "ORB",
                 "BRISK", "harris"]:
        assert tdet.canonical(name) == jdet.canonical(name)
        assert tdet.defaults(name) == jdet.defaults(name)


def test_unknown_detector_lists_the_families():
    with pytest.raises(ValueError) as ej:
        jdet.canonical("FASTER")
    with pytest.raises(ValueError) as et:
        tdet.canonical("FASTER")
    assert str(et.value) == str(ej.value)
    for fam in FAMILIES:
        assert fam in str(et.value)


@pytest.mark.parametrize("det", ["FAST", "GFTT", "DOG", "SURF"])
def test_detector_params_match_reference(det):
    cfg = ExtractorConfig(detector=det, fast_threshold=17.0)
    pcfg = P.port_config(small_config().replace(extractor=cfg)).extractor
    assert text.detector_params(pcfg) == jext.detector_params(cfg)
    grid = text.init_grid_thresholds(pcfg, "cpu")
    np.testing.assert_array_equal(
        P.n(grid), np.asarray(jext.init_adaptive_state(cfg).grid_thresholds))
    st = text.init_adaptive_state(pcfg, "cpu")
    assert torch.equal(st.grid_thresholds, grid)


# ---------------------------------------------------------------- descriptors

def test_patterns_match_reference():
    for a, b in zip(tdesc._freak_pattern(), jdesc._freak_pattern()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert np.array_equal(tdesc._latch_pattern(), jdesc._latch_pattern())
    for a, b in zip(tdesc._sift_grid(), jdesc._sift_grid()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert tdesc.SIFT_DIM == jdesc.SIFT_DIM
    assert tdesc.DESCRIPTOR_ALIASES == jdesc.DESCRIPTOR_ALIASES


@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("family", DESCRIPTORS)
def test_descriptor_matches_reference(family, level):
    """The same blurred level image on both sides (level 0, and level 2 of the
    reference's pyramid): binary bits exact; SIFT to 1e-5 except on keypoints
    where the two sides' IC angles (equal to ~1e-6) round a steered sample
    onto different pixels (`steered_index` differs)."""
    img = textured()
    if level:
        img = np.asarray(jpyr.build_pyramid(jnp.asarray(img), 3, 1.2)[level])
    blur = np.asarray(jpyr.gaussian_blur(jnp.asarray(img)))
    xy = _keypoints(blur)
    dj, aj = jdesc.describe(family, jnp.asarray(blur), jnp.asarray(xy))
    dt, at = tdesc.describe(family, P.t(blur), P.t(xy))
    np.testing.assert_allclose(P.n(at), np.asarray(aj), atol=1e-5)
    if tdesc.is_binary(family):
        assert dt.dtype == torch.int32 and dt.shape == (len(xy), 8)
        np.testing.assert_array_equal(P.n(dt), P.words(dj))
    else:
        assert dt.dtype == torch.float32 and dt.shape == (len(xy), 128)
        ties = P.n((tdesc.steered_index(family, P.t(np.asarray(aj)))
                    != tdesc.steered_index(family, at)).any(1))
        assert ties.mean() < 0.05
        np.testing.assert_allclose(P.n(dt)[~ties], np.asarray(dj)[~ties],
                                   atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(P.n(dt), axis=1), 1.0,
                                   atol=1e-5)


# ---------------------------------------------------------------- L2 matching

def _sift_sets(n_q=90, n_t=110, seed=2):
    img = textured(seed=seed)
    blur = np.asarray(jpyr.gaussian_blur(jnp.asarray(img)))
    xy = _keypoints(blur, n=n_q + n_t, seed=seed)
    d = P.n(tdesc.describe_sift(P.t(blur), P.t(xy))[0])
    rng = np.random.default_rng(seed)
    q = d[:n_q]
    # targets: noisy copies of the first 60 queries among fresh descriptors
    t = d[n_q:].copy()
    t[:60] = q[rng.permutation(60)] + rng.normal(0, 0.01, (60, 128))
    return q.astype(np.float32), t.astype(np.float32)


def test_l2_distance_matrix_matches_reference():
    q, t = _sift_sets()
    ref = np.asarray(jham.l2_distance_matrix(jnp.asarray(q), jnp.asarray(t)))
    out = P.n(tham.l2_distance_matrix(P.t(q), P.t(t)))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # the dtype dispatch: float descriptors take the L2 path, words Hamming
    np.testing.assert_array_equal(P.n(tham.distance_matrix(P.t(q), P.t(t))),
                                  out)
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, (20, 8), dtype=np.uint32)
    np.testing.assert_array_equal(
        P.n(tham.distance_matrix(P.t(w), P.t(w))),
        np.asarray(jham.distance_matrix(jnp.asarray(w), jnp.asarray(w))))


def test_float_knn_ratio_match_matches_reference():
    q, t = _sift_sets()
    vq = np.ones(len(q), bool)
    vt = np.ones(len(t), bool)
    vt[5] = False
    mj = jmatch.knn_ratio_match(jnp.asarray(q), jnp.asarray(vq),
                                jnp.asarray(t), jnp.asarray(vt), ratio=0.8,
                                max_dist=100.0)
    mt = tmatch.knn_ratio_match(P.t(q), P.t(vq), P.t(t), P.t(vt), ratio=0.8,
                                max_dist=100.0)
    np.testing.assert_array_equal(P.n(mt.target_idx), np.asarray(mj.target_idx))
    np.testing.assert_array_equal(P.n(mt.valid), np.asarray(mj.valid))
    np.testing.assert_allclose(P.n(mt.distance), np.asarray(mj.distance),
                               atol=1e-5)
    assert int(P.n(mt.valid).sum()) >= 50


# ---------------------------------------------------------------- extractor

@pytest.mark.parametrize("det,des", [("GFTT", "BRIEF"), ("DOG", "SIFT"),
                                     ("HARRIS", "FREAK"), ("HESSIAN", "LATCH"),
                                     ("STAR", "ORB")])
def test_extract_features_matches_reference(det, des):
    """Two frames through `extract_features` with the adaptive state carried:
    the grids after each call equal, the level-0 keypoints equal (sub-pixel
    to 1e-4) with the same descriptors, as many valid keypoints."""
    cfg = small_config()
    ec = dataclasses.replace(cfg.extractor, detector=det, descriptor=des)
    pec = P.port_config(cfg.replace(extractor=ec)).extractor
    imgs, _, _, _ = synthetic.make_sequence(n_frames=3, n_points=500, seed=3)
    sj = st = None
    for i in (1, 2):
        img = np.clip(imgs[i], 0, 255).astype(np.float32)
        fj, sj = jext.extract_features(jnp.asarray(img), ec, sj)
        ft, st = text.extract_features(P.t(img), pec, st)
        np.testing.assert_allclose(P.n(st.grid_thresholds),
                                   np.asarray(sj.grid_thresholds), rtol=1e-6)
    jv, tv = np.asarray(fj.valid), P.n(ft.valid)
    assert jv.sum() == tv.sum() > 100
    j0 = jv & (np.asarray(fj.octave) == 0)
    t0 = tv & (P.n(ft.octave) == 0)
    assert j0.sum() == t0.sum() > 30
    np.testing.assert_allclose(P.n(ft.xy)[t0], np.asarray(fj.xy)[j0], atol=1e-4)
    if tdesc.is_binary(des):
        np.testing.assert_array_equal(P.n(ft.desc)[t0], P.words(fj.desc)[j0])
    else:
        assert ft.desc.shape == (pec.max_keypoints, 128)
        np.testing.assert_allclose(P.n(ft.desc)[t0], np.asarray(fj.desc)[j0],
                                   atol=1e-5)


def test_extractor_facade_carries_the_state():
    cfg = small_config()
    ec = dataclasses.replace(cfg.extractor, detector="GFTT", descriptor="LATCH")
    pec = P.port_config(cfg.replace(extractor=ec)).extractor
    imgs, _, _, _ = synthetic.make_sequence(n_frames=2, n_points=500, seed=3)
    ej, et = jext.Extractor(ec), text.Extractor(pec, "cpu")
    for img in imgs:
        img = np.clip(img, 0, 255).astype(np.float32)
        fj = ej.extract(jnp.asarray(img))
        ft = et.extract(img)
    np.testing.assert_allclose(P.n(et.state.grid_thresholds),
                               np.asarray(ej.state.grid_thresholds), rtol=1e-6)
    assert int(P.n(ft.valid).sum()) == int(np.asarray(fj.valid).sum())

"""Parity of the port's bag-of-words module (`aslam_tpu_torch/ops/bow.py`)
with the JAX package's `aslam_tpu/ops/bow.py`, on the CPU.

Training is the same numpy code on both sides: seed 0 must give the same
tree bit for bit.  Words, word presence and shared-word counts are integers
and must be equal; `bow_vector` and `l1_scores` agree to 1e-6.  The port's
copy of the shipped vocabulary is byte-equal to the reference's and loads
from the port's own `assets/`.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from aslam_tpu.ops import bow as jbow
from aslam_tpu_torch import config as tconfig
from aslam_tpu_torch import convert
from aslam_tpu_torch.models import loopclosing as tlc
from aslam_tpu_torch.ops import bow as tbow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _descs(seed, n):
    """Clustered descriptors: 40 random centres, a few bits flipped each."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    d = centres[rng.integers(0, 40, n)]
    flips = (rng.random((n, 8, 32)) < 0.04)
    return d ^ (flips * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)


@pytest.fixture(scope="module")
def vocabs():
    train = _descs(0, 1500)
    vj = jbow.train_vocabulary(train, branching=10, depth=3)
    vt = tbow.train_vocabulary(train.view(np.int32), branching=10, depth=3)
    return train, vj, vt


def test_train_vocabulary_gives_the_same_tree(vocabs):
    train, vj, vt = vocabs
    assert (vt.branching, vt.depth, vt.n_words) == (10, 3, 1000) \
        == (vj.branching, vj.depth, vj.n_words)
    for a, b in zip(vt.level_cents, vj.level_cents):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(P.n(a), P.words(b))
    np.testing.assert_array_equal(P.n(vt.idf), np.asarray(vj.idf))
    # the reference's vocabulary, carried across, is the port's
    vc = convert.vocabulary(P.tree_np(vj), "cpu")
    for a, b in zip(vc.level_cents, vt.level_cents):
        assert torch.equal(a, b)
    assert torch.equal(vc.idf, vt.idf)


def test_transform_words_equal_with_ties(vocabs):
    train, vj, vt = vocabs
    q = _descs(1, 700)
    # ties: a centroid's own children compete with equal distances once two
    # children of the root are made the same
    tied = vt._replace(level_cents=(
        torch.cat([vt.level_cents[0][:, :1]] * 2
                  + [vt.level_cents[0][:, 2:]], 1),) + vt.level_cents[1:])
    tied_j = vj._replace(level_cents=(
        jnp.concatenate([vj.level_cents[0][:, :1]] * 2
                        + [vj.level_cents[0][:, 2:]], 1),) + vj.level_cents[1:])
    for v_t, v_j in ((vt, vj), (tied, tied_j)):
        wj = np.asarray(jbow.transform(v_j, jnp.asarray(q)))
        wt = tbow.transform(v_t, P.t(q))
        assert wt.dtype == torch.int32
        np.testing.assert_array_equal(P.n(wt), wj)
    assert not (P.n(tbow.transform(tied, P.t(q))) // 100 == 1).any()
    # batched over leading dims = row by row
    wb = tbow.transform(vt, P.t(q).reshape(7, 100, 8))
    np.testing.assert_array_equal(P.n(wb).reshape(-1), P.n(tbow.transform(vt, P.t(q))))


def test_bow_vector_scores_and_shared_words_match_reference(vocabs):
    train, vj, vt = vocabs
    rng = np.random.default_rng(2)
    K, M = 6, 256
    descs = _descs(3, K * M).reshape(K, M, 8)
    valid = rng.random((K, M)) > 0.2
    words = P.n(tbow.transform(vt, P.t(descs)))
    vec_j = np.stack([np.asarray(jbow.bow_vector(
        vj, jnp.asarray(words[k]), jnp.asarray(valid[k]))) for k in range(K)])
    vec_t = tbow.bow_vector(vt, P.t(words), P.t(valid))
    np.testing.assert_allclose(P.n(vec_t), vec_j, atol=1e-6)
    np.testing.assert_allclose(P.n(vec_t).sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        P.n(tbow.bow_vector(vt, P.t(words[0]), P.t(valid[0]))), vec_j[0],
        atol=1e-6)

    s_j = np.asarray(jbow.l1_scores(jnp.asarray(vec_j[0]), jnp.asarray(vec_j)))
    s_t = tbow.l1_scores(vec_t[0], vec_t)
    np.testing.assert_allclose(P.n(s_t), s_j, atol=1e-6)
    assert abs(float(s_t[0]) - 1.0) < 1e-6

    hist = P.n(tlc._word_presence(P.t(words), P.t(valid), vt.n_words))
    c_j = np.asarray(jbow.shared_word_counts(
        jnp.asarray(words[1]), jnp.asarray(valid[1]), jnp.asarray(hist)))
    c_t = tbow.shared_word_counts(P.t(words[1]), P.t(valid[1]), P.t(hist))
    assert c_t.dtype == torch.float32
    np.testing.assert_array_equal(P.n(c_t), c_j)
    assert c_j[1] == len(set(words[1][valid[1]]))


def test_save_and_load_cross_the_packages(vocabs, tmp_path):
    train, vj, vt = vocabs
    tbow.save_vocabulary(str(tmp_path / "t.npz"), vt)
    jbow.save_vocabulary(str(tmp_path / "j.npz"), vj)
    from_j = tbow.load_vocabulary(str(tmp_path / "j"))      # .npz appended
    from_t = jbow.load_vocabulary(str(tmp_path / "t.npz"))
    for a, b, c in zip(from_j.level_cents, vt.level_cents, from_t.level_cents):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(P.words(c), P.n(b))
    assert torch.equal(from_j.idf, vt.idf)


def test_shipped_vocabulary_is_the_ports_own_copy():
    cfg = tconfig.SystemConfig()
    path = tlc._default_vocab_path(cfg)
    assert os.path.relpath(path, REPO) == os.path.join(
        "aslam_tpu_torch", "assets", "vocab_10_4.npz")
    assert filecmp.cmp(path, os.path.join(REPO, "aslam_tpu", "assets",
                                          "vocab_10_4.npz"), shallow=False)
    vt = tbow.load_vocabulary(path)
    vj = jbow.load_vocabulary(path)
    assert (vt.branching, vt.depth, vt.n_words) == (10, 4, 10**4)
    q = _descs(5, 300)
    np.testing.assert_array_equal(
        P.n(tbow.transform(vt, P.t(q))),
        np.asarray(jbow.transform(vj, jnp.asarray(q))))
    # LoopClosing loads it when the config asks for the pretrained one
    import dataclasses
    lc = tlc.LoopClosing(cfg.replace(
        map=dataclasses.replace(cfg.map, max_keyframes=4, max_landmarks=64),
        loop=dataclasses.replace(cfg.loop, use_pretrained_vocab=True)), "cpu")
    assert lc.vocab is not None and lc.vocab.n_words == 10**4
    assert lc.trained_on_kfs == 10**9

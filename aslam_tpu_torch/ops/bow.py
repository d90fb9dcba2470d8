"""Binary bag-of-words place recognition: vocabulary training, batched tree
descent, tf-idf scoring, common-word counts.

Port of `aslam_tpu/ops/bow.py`.  The k-ary tree is a tuple of dense tensors
[B^l, B, 8] of packed centroids (int32 words holding uint32 bit patterns,
like every descriptor of the port); `transform` descends all descriptors of
any batch shape at once, gathering each one's B children per level.  Keyframe
BoW vectors live in a dense [K, n_words] matrix, so a database query is one
L1 score against every keyframe.

Training is the reference's host code, kept as it is (numpy, hierarchical
binary k-medians): the same descriptors and seed give the same tree.  Files
written by `save_vocabulary` hold uint32 arrays, so either package loads the
other's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aslam_tpu_torch.ops.hamming import _popcount32


class Vocabulary(NamedTuple):
    """Complete k-ary tree of binary centroids, depth D, branching B.

    level_cents[l]: [B^l, B, 8] int32, the children centroids per node.
    idf: [B^D] float32 inverse-document-frequency weights.
    """

    level_cents: tuple
    idf: torch.Tensor

    @property
    def branching(self) -> int:
        return self.level_cents[0].shape[1]

    @property
    def depth(self) -> int:
        return len(self.level_cents)

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,8] x [M,8] -> [N,M] popcount distances (host, numpy)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """Majority vote per bit -> one packed centroid [8]."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)   # [N,256]
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs: np.ndarray, k: int, rng: np.random.Generator,
              iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-medians: returns (centroids [k,8], assignment [N])."""
    n = len(descs)
    if n == 0:
        return rng.integers(0, 2**32, (k, 8), dtype=np.uint32), np.zeros(0, np.int64)
    cents = descs[rng.choice(n, size=min(k, n), replace=False)]
    if len(cents) < k:
        extra = rng.integers(0, 2**32, (k - len(cents), 8), dtype=np.uint32)
        cents = np.concatenate([cents, extra])
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(descs, cents)
        assign = d.argmin(1)
        for c in range(k):
            members = descs[assign == c]
            if len(members) > 0:
                cents[c] = _bit_majority(members)
            else:
                cents[c] = descs[rng.integers(n)]  # reseed empty cluster
    return cents, assign


def _as_u32(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _vocab_from_numpy(levels, idf, device) -> Vocabulary:
    return Vocabulary(
        level_cents=tuple(
            torch.from_numpy(np.ascontiguousarray(c).view(np.int32).copy())
            .to(device) for c in levels),
        idf=torch.from_numpy(np.asarray(idf, np.float32).copy()).to(device))


def train_vocabulary(
    descriptors: np.ndarray, branching: int = 10, depth: int = 3,
    seed: int = 0, device: torch.device | str = "cpu",
) -> Vocabulary:
    """Hierarchical k-medians over packed descriptors [N,8] (uint32, or int32
    words with the same bits), on the host; the tree goes to `device`."""
    descriptors = _as_u32(descriptors)
    rng = np.random.default_rng(seed)
    levels = []
    # groups of descriptor indices per node at the current level
    groups = [np.arange(len(descriptors))]
    for level in range(depth):
        n_nodes = branching ** level
        cents_level = np.empty((n_nodes, branching, 8), np.uint32)
        next_groups = []
        for node in range(n_nodes):
            idx = groups[node] if node < len(groups) else np.zeros(0, np.int64)
            cents, assign = _kmedians(descriptors[idx], branching, rng)
            cents_level[node] = cents
            for c in range(branching):
                next_groups.append(idx[assign == c] if len(idx) else idx)
        groups = next_groups
        levels.append(cents_level)

    # idf from training leaf occupancy
    counts = np.array([len(g) for g in groups], np.float64)
    n_docs = max(len(descriptors), 1)
    idf = np.log(n_docs / np.maximum(counts, 1.0)).astype(np.float32)
    return _vocab_from_numpy(levels, idf, device)


def save_vocabulary(path: str, vocab: Vocabulary) -> None:
    """Persist the vocabulary as a small npz of uint32 centroids and idf."""
    arrays = {f"level_{i}": _as_u32(c.cpu().numpy())
              for i, c in enumerate(vocab.level_cents)}
    arrays["idf"] = vocab.idf.cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_vocabulary(path: str, device: torch.device | str = "cpu") -> Vocabulary:
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    levels = []
    while f"level_{len(levels)}" in data:
        levels.append(data[f"level_{len(levels)}"])
    return _vocab_from_numpy(levels, data["idf"], device)


# ----------------------------------------------------------------- device ops

def transform(vocab: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """Descend descriptors [...,8] through the tree -> word ids [...] int32.
    At each level a descriptor goes to the nearest child centroid, the
    lowest index on ties (`torch.argmin` returns the first minimum)."""
    B = vocab.branching
    d = desc.to(torch.int64)[..., None, :]                      # [...,1,8]
    node = torch.zeros(desc.shape[:-1], dtype=torch.int64, device=desc.device)
    for cents_l in vocab.level_cents:
        x = d ^ cents_l[node].to(torch.int64)                   # [...,B,8]
        dist = torch.sum(_popcount32(x), dim=-1)
        node = node * B + torch.argmin(dist, dim=-1)
    return node.to(torch.int32)


def bow_vector(vocab: Vocabulary, words: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """tf-idf, L1-normalized BoW vectors [...,n_words] from word ids [...,M]."""
    W = vocab.idf.shape[0]
    tgt = torch.where(valid, words.to(torch.int64), W)
    tf = torch.zeros(words.shape[:-1] + (W + 1,), dtype=torch.float32,
                     device=words.device)
    tf.scatter_add_(-1, tgt, torch.ones_like(tgt, dtype=torch.float32))
    v = tf[..., :W] * vocab.idf
    return v / torch.clamp(torch.sum(torch.abs(v), dim=-1, keepdim=True),
                           min=1e-9)


def l1_scores(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """L1 similarity s = 1 - 0.5 |v1 - v2|_1 of L1-normalized vectors.
    query [W] vs db [K,W] -> [K]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(query[None, :] - db), dim=-1)


def shared_word_counts(query_words: torch.Tensor, query_valid: torch.Tensor,
                       db_hist: torch.Tensor) -> torch.Tensor:
    """Number of distinct words a query (word ids [M]) shares with each
    database row of word presence [K,W] -> [K] float32.  Counted over the
    query's presence mask (the reference's matmul of 0/1 values gives the
    same integers)."""
    W = db_hist.shape[1]
    tgt = torch.where(query_valid, query_words.to(torch.int64), W)
    present = torch.zeros(W + 1, dtype=torch.bool, device=db_hist.device)
    present.scatter_(0, tgt, torch.ones_like(tgt, dtype=torch.bool))
    return torch.sum(db_hist & present[None, :W], dim=-1).to(torch.float32)

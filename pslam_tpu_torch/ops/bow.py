"""Hierarchical bag-of-words over 256-bit ORB descriptors (port of
``pslam_tpu/ops/bow.py``).

Replaces DBoW2 (reference Thirdparty/DBoW2: TemplatedVocabulary.h, FORB.cpp,
BowVector.cpp, FeatureVector.cpp, ScoringObject.cpp): a k^L vocabulary tree,
an L1-normalized tf-idf BoW vector per frame, and the L1 score and shared-word
count over a dense (K, W) database.

The descent gathers each descriptor's k children at every level, an
(N, k, 32) index, and takes the argmin of their Hamming distances, lowest
child first on ties. That gives the words of the JAX package, which builds a
masked (N, n_nodes) Hamming matrix per level instead. The term counts are an
exact integer ``bincount``.

The packaged vocabulary is this package's own copy of the JAX package's
``data/vocab_orb.npz`` (10^4 words trained on ORB descriptors of rendered
scenes by ``scripts/train_vocab.py``). The numpy trainer below is the
fallback for a shape the packaged file does not hold.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

PACKAGED_VOCAB = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "vocab_orb.npz")

# Set bits of every byte value: Hamming distance = sum of _POPCOUNT[a ^ b].
_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


class Vocabulary(NamedTuple):
    """k^L tree. Level l (0-based) holds k^(l+1) node descriptors; the
    children of node j at level l are rows j*k .. j*k+k-1 of level l+1.

    node_desc: tuple of (k^(l+1), 32) uint8 tensors, one per level.
    idf: (W,) float32 word weights (W = k^L leaves).
    """

    node_desc: tuple
    idf: torch.Tensor

    @property
    def k(self) -> int:
        return self.node_desc[0].shape[0]

    @property
    def levels(self) -> int:
        return len(self.node_desc)

    @property
    def n_words(self) -> int:
        return self.node_desc[-1].shape[0]

    @property
    def device(self):
        return self.idf.device


def vocabulary_from_arrays(level_desc, idf, device) -> Vocabulary:
    return Vocabulary(
        node_desc=tuple(torch.from_numpy(np.array(d, np.uint8)).to(device) for d in level_desc),
        idf=torch.from_numpy(np.array(idf, np.float32)).to(device),
    )


# ---------------------------------------------------------------------------
# Training (host, numpy): a copy of the JAX package's trainer
# ---------------------------------------------------------------------------


def _bit_majority(desc_bits: np.ndarray) -> np.ndarray:
    """(N, 256) {0,1} -> (256,) majority-vote centroid bits."""
    return (desc_bits.sum(axis=0) * 2 >= desc_bits.shape[0]).astype(np.uint8)


def _hamming_np(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """(Na, 256) x (Nb, 256) {0,1} -> (Na, Nb) int32."""
    return (a_bits[:, None, :] != b_bits[None, :, :]).sum(-1).astype(np.int32)


def _kmedians(bits: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8):
    """Binary k-medians with k-means++ seeding. Returns (centroids (k,256),
    assignment (N,)). Pads with duplicated centroids if N < k."""
    n = len(bits)
    if n == 0:
        return np.zeros((k, 256), np.uint8), np.zeros(0, np.int64)
    first = int(rng.integers(n))
    cents = [bits[first]]
    d = _hamming_np(bits, bits[first : first + 1])[:, 0].astype(np.float64)
    for _ in range(1, min(k, n)):
        p = d * d
        s = p.sum()
        idx = int(rng.integers(n)) if s <= 0 else int(rng.choice(n, p=p / s))
        cents.append(bits[idx])
        d = np.minimum(d, _hamming_np(bits, bits[idx : idx + 1])[:, 0])
    C = np.stack(cents)
    for _ in range(iters):
        assign = _hamming_np(bits, C).argmin(axis=1)
        newC = C.copy()
        for j in range(len(C)):
            sel = assign == j
            if sel.any():
                newC[j] = _bit_majority(bits[sel])
        if (newC == C).all():
            C = newC
            break
        C = newC
    assign = _hamming_np(bits, C).argmin(axis=1)
    if len(C) < k:  # pad: repeat the last centroid (it never wins argmin ties)
        C = np.concatenate([C, np.tile(C[-1:], (k - len(C), 1))])
    return C, assign


def train_vocabulary(descs_u8: np.ndarray, k: int = 10, levels: int = 3, seed: int = 0,
                     device="cuda") -> Vocabulary:
    """Build a k^levels vocabulary from packed (N, 32) uint8 descriptors
    (TemplatedVocabulary::create: recursive k-means++ clustering, idf word
    weights from the training set)."""
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(descs_u8, axis=-1, bitorder="little")
    n = len(bits)
    level_desc = []
    groups = np.zeros(n, np.int64)
    n_nodes = 1
    for _ in range(levels):
        out = np.zeros((n_nodes * k, 256), np.uint8)
        new_groups = np.zeros(n, np.int64)
        for node in range(n_nodes):
            sel = np.flatnonzero(groups == node)
            C, assign = _kmedians(bits[sel], k, rng)
            out[node * k : node * k + k] = C
            new_groups[sel] = node * k + assign
        level_desc.append(np.packbits(out, axis=-1, bitorder="little"))
        groups = new_groups
        n_nodes *= k
    # idf = log(N / n_i) over the training corpus (DBoW2 leaf weights).
    counts = np.bincount(groups, minlength=n_nodes).astype(np.float64)
    idf = np.log(max(n, 1) / np.maximum(counts, 1.0)).astype(np.float32)
    idf[counts == 0] = 0.0
    return vocabulary_from_arrays(level_desc, idf, device)


def save_vocabulary(vocab: Vocabulary, path: str):
    """Serialize a vocabulary to the JAX package's compressed ``.npz``
    (``level<l>`` packed node descriptors and ``idf``), which
    ``load_vocabulary`` of either package reads."""
    arrs = {f"level{l}": d.cpu().numpy() for l, d in enumerate(vocab.node_desc)}
    arrs["idf"] = vocab.idf.cpu().numpy()
    np.savez_compressed(path, **arrs)


def load_vocabulary(path: str, device="cuda") -> Vocabulary:
    data = np.load(path)
    levels = sorted(int(k.removeprefix("level")) for k in data.files if k.startswith("level"))
    return vocabulary_from_arrays([data[f"level{l}"] for l in levels], data["idf"], device)


def default_vocabulary(k: int = 10, levels: int = 4, n_train: int = 16384, seed: int = 3,
                       device="cuda") -> Vocabulary:
    """The packaged vocabulary when its shape matches, else the JAX package's
    deterministic fallback: trained on random bitstrings from ``seed``."""
    if os.path.exists(PACKAGED_VOCAB):
        vocab = load_vocabulary(PACKAGED_VOCAB, device)
        if vocab.k == k and vocab.levels == levels:
            return vocab
    rng = np.random.default_rng(seed)
    descs = rng.integers(0, 256, size=(n_train, 32), dtype=np.uint8)
    return train_vocabulary(descs, k=k, levels=levels, seed=seed, device=device)


# ---------------------------------------------------------------------------
# Transform + scoring (device)
# ---------------------------------------------------------------------------


def transform(vocab: Vocabulary, desc_u8, valid, levelsup: int = 1):
    """Descend all descriptors through the tree at once.

    Returns (bow (W,) float32 l1-normalized tf-idf, word (N,) int64 leaf ids,
    node (N,) int64 node ids ``levelsup`` levels above the leaves, the
    FeatureVector grouping of SearchByBoW). Invalid features get word = -1
    and contribute nothing."""
    k = vocab.k
    dev = desc_u8.device
    n = desc_u8.shape[0]
    popcount = torch.from_numpy(_POPCOUNT.astype(np.int32)).to(dev)
    child = torch.arange(k, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    node_up = torch.zeros(n, dtype=torch.int64, device=dev)
    for lvl, lvl_desc in enumerate(vocab.node_desc):
        cand = node[:, None] * k + child  # (N, k) this node's children
        x = torch.bitwise_xor(desc_u8[:, None, :], lvl_desc[cand])  # (N, k, 32)
        d = popcount[x.long()].sum(-1)
        node = cand.gather(1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
        if lvl == len(vocab.node_desc) - 1 - levelsup:
            node_up = node
    word = torch.where(valid, node, -1)
    W = vocab.n_words
    tf = torch.bincount(torch.where(valid, node, W), minlength=W + 1)[:W].to(torch.float32)
    bow = tf * vocab.idf
    bow = bow / torch.clamp(torch.sum(torch.abs(bow)), min=1e-12)
    return bow, word, torch.where(valid, node_up, -1)


def score_l1(bow_q, bow_db):
    """DBoW2 L1 score (ScoringObject.cpp L1Scoring): 1 - 0.5*|q-d|_1, which
    for L1-normalized nonnegative vectors equals sum_i min(q_i, d_i).
    bow_q: (W,); bow_db: (K, W). Returns (K,) scores in [0, 1]."""
    return torch.sum(torch.minimum(bow_q[None, :], bow_db), dim=-1)


def shared_words(bow_q, bow_db):
    """(K,) count of words present in both the query and each DB row (the
    inverted-file common-word count, KeyFrameDatabase.cc:84-103)."""
    return torch.sum((bow_db > 0) & (bow_q[None, :] > 0), dim=-1).to(torch.int32)


def bow_group_mask(node_a, node_b):
    """(Na,) x (Nb,) FeatureVector node ids -> (Na, Nb) same-bucket mask (the
    SearchByBoW candidate restriction, ORBmatcher.cc:159-288)."""
    return (node_a[:, None] == node_b[None, :]) & (node_a[:, None] >= 0)

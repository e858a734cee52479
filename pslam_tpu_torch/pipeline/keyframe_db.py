"""Keyframe place-recognition database over BoW vectors (port of
``pslam_tpu/pipeline/keyframe_db.py``).

Replaces KeyFrameDatabase (reference src/KeyFrameDatabase.cc): the reference
keeps an inverted file (word -> list of KFs) and walks it per query; here the
database is a dense (K, W) tf-idf matrix so "shared word counting" and L1
scoring over every keyframe are two vectorized ops (ops/bow.py), and only the
covisibility-group accumulation stays as host logic (it reads the mutable
covisibility graph).
"""

from __future__ import annotations

import numpy as np
import torch

from pslam_tpu_torch.models.map_state import MapState
from pslam_tpu_torch.ops import bow as bow_ops
from pslam_tpu_torch.ops.bow import Vocabulary


class KeyFrameDatabase:
    def __init__(self, vocab: Vocabulary, max_keyframes: int, n_feat: int):
        self.vocab = vocab
        W = vocab.n_words
        self.bow = np.zeros((max_keyframes, W), np.float32)
        self.word = np.full((max_keyframes, n_feat), -1, np.int32)
        self.node = np.full((max_keyframes, n_feat), -1, np.int32)
        self.present = np.zeros(max_keyframes, bool)

    def add(self, kf_idx: int, bow, word, node):
        """KeyFrameDatabase::add (KeyFrameDatabase.cc:45)."""
        self.bow[kf_idx] = np.asarray(bow)
        self.word[kf_idx] = np.asarray(word)
        self.node[kf_idx] = np.asarray(node)
        self.present[kf_idx] = True

    def erase(self, kf_idx: int):
        self.present[kf_idx] = False

    # ------------------------------------------------------------------

    def _scores(self, bow_q: np.ndarray, n_kf: int):
        db = self.bow[:n_kf]
        common = ((db > 0) & (bow_q[None, :] > 0)).sum(axis=1).astype(np.int32)
        score = np.minimum(db, bow_q[None, :]).sum(axis=1)
        common[~self.present[:n_kf]] = 0
        return common, score

    def detect_relocalization_candidates(
        self, bow_q: np.ndarray, map_state: MapState
    ) -> np.ndarray:
        """Mirror KeyFrameDatabase::DetectRelocalizationCandidates
        (KeyFrameDatabase.cc:199-311): keep KFs sharing > 0.8*max common
        words; accumulate scores over each candidate's best-10 covisibility
        group; return the best KF of every group whose accumulated score
        > 0.75 * best accumulated score."""
        n_kf = map_state.n_kf
        if n_kf == 0:
            return np.zeros(0, np.int64)
        common, score = self._scores(bow_q, n_kf)
        max_common = common.max(initial=0)
        if max_common == 0:
            return np.zeros(0, np.int64)
        min_common = int(0.8 * max_common)
        cand = np.flatnonzero(common > min_common)
        return self._group_accumulate(cand, score, map_state, ratio=0.75)

    def detect_loop_candidates(
        self, kf_query: int, min_score: float, map_state: MapState
    ) -> np.ndarray:
        """Mirror KeyFrameDatabase::DetectLoopCandidates
        (KeyFrameDatabase.cc:76-197): exclude the query's covisible
        neighbours, require BoW score >= min_score, then the same
        covisibility-group accumulation."""
        n_kf = map_state.n_kf
        if n_kf == 0:
            return np.zeros(0, np.int64)
        bow_q = self.bow[kf_query]
        common, score = self._scores(bow_q, n_kf)
        connected = set(int(j) for j in map_state.covisible_kfs(kf_query))
        connected.add(kf_query)
        mask = np.ones(n_kf, bool)
        mask[list(connected)] = False
        common = np.where(mask, common, 0)
        max_common = common.max(initial=0)
        if max_common == 0:
            return np.zeros(0, np.int64)
        min_common = int(0.8 * max_common)
        cand = np.flatnonzero((common > min_common) & (score >= min_score))
        return self._group_accumulate(cand, score, map_state, ratio=0.75)

    def _group_accumulate(self, cand, score, map_state, ratio: float):
        if len(cand) == 0:
            return np.zeros(0, np.int64)
        cand_set = set(int(c) for c in cand)
        acc_scores = []
        best_kfs = []
        for c in cand:
            group = [int(c)] + [
                int(j) for j in map_state.best_covisible(int(c), 10)
            ]
            members = [j for j in group if j in cand_set]
            acc = float(score[members].sum())
            best = members[int(np.argmax(score[members]))]
            acc_scores.append(acc)
            best_kfs.append(best)
        acc_scores = np.asarray(acc_scores)
        th = ratio * acc_scores.max()
        keep = acc_scores >= th
        out = np.unique(np.asarray(best_kfs, np.int64)[keep])
        return out

    # ------------------------------------------------------------------

    def compute_bow(self, desc_u8, valid):
        """BoW transform of one frame's descriptors on the vocabulary's
        device; returns host (bow, word, node)."""
        dev = self.vocab.device
        bow, word, node = bow_ops.transform(
            self.vocab, torch.as_tensor(np.asarray(desc_u8)).to(dev),
            torch.as_tensor(np.asarray(valid)).to(dev),
        )
        return bow.cpu().numpy(), word.cpu().numpy(), node.cpu().numpy()

"""Keyframe database: BoW place-recognition queries, on the host.

A sparse inverted file over the vocabulary, as the reference's
`KeyFrameDatabase`, with numpy posting-list accumulation in place of
serial candidate walks. Memory is O(total observed words), independent of
the vocabulary's size, and a query touches only its own words' posting
lists.

The reference's two-stage candidate logic:
- loop candidates: exclude covisible keyframes, a floor on shared words
  (0.8·max), scores accumulated over covisibility groups, 0.75·best cut;
- relocalization candidates: the same without the exclusion.
"""
from __future__ import annotations

import numpy as np

from ..frontend.keypoints import Keypoints
from ..mapping.mapstore import MapStore
from .vocab import Vocabulary, descend_np


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary, store: MapStore):
        self.voc = voc
        self.store = store
        # per-KF sparse BoW: sorted word ids + L1-normalized weights
        self.kf_word_ids: dict[int, np.ndarray] = {}
        self.kf_word_wts: dict[int, np.ndarray] = {}
        # inverted file: word -> (kf ids, weights); append-only, erased
        # keyframes are masked at query time
        self._inv_kfs: dict[int, list] = {}
        self._inv_wts: dict[int, list] = {}
        self.registered: set[int] = set()

    # ------------------------------------------------------------------
    def transform_frame(self, kp: Keypoints):
        return transform_sparse(self.voc, kp)

    def add_keyframe(self, kf: int, kp: Keypoints):
        ids, wts = self.transform_frame(kp)
        self.kf_word_ids[kf] = ids
        self.kf_word_wts[kf] = wts
        for w, wt in zip(ids.tolist(), wts.tolist()):
            self._inv_kfs.setdefault(w, []).append(kf)
            self._inv_wts.setdefault(w, []).append(wt)
        self.registered.add(kf)

    def erase_keyframe(self, kf: int):
        self.registered.discard(kf)
        self.kf_word_ids.pop(kf, None)
        self.kf_word_wts.pop(kf, None)

    # ------------------------------------------------------------------
    def _accumulate(self, q_ids: np.ndarray, q_wts: np.ndarray):
        """Walk the posting lists of the query's words: (common word
        count, l1 score) over keyframe ids [0, n_kf)."""
        n = self.store.n_kf
        common = np.zeros(n, np.int32)
        score = np.zeros(n, np.float32)
        kf_chunks, s_chunks = [], []
        for w, qw in zip(q_ids.tolist(), q_wts.tolist()):
            kfs = self._inv_kfs.get(w)
            if not kfs:
                continue
            kf_chunks.append(np.asarray(kfs, np.int64))
            s_chunks.append(np.minimum(np.asarray(self._inv_wts[w],
                                                  np.float32), qw))
        if not kf_chunks:
            return common, score
        kf_all = np.concatenate(kf_chunks)
        s_all = np.concatenate(s_chunks)
        inb = kf_all < n
        np.add.at(common, kf_all[inb], 1)
        np.add.at(score, kf_all[inb], s_all[inb])
        return common, score

    def _active_mask(self):
        store = self.store
        active = np.zeros(store.n_kf, bool)
        if self.registered:
            reg = np.fromiter(self.registered, np.int64)
            active[reg[reg < store.n_kf]] = True
        return active & store.kf_valid[: store.n_kf]

    def pair_score(self, a: int, b: int) -> float:
        """L1 BoW similarity of two registered keyframes."""
        ia, ib = self.kf_word_ids.get(a), self.kf_word_ids.get(b)
        if ia is None or ib is None:
            return 0.0
        common, ca, cb = np.intersect1d(ia, ib, assume_unique=True,
                                        return_indices=True)
        if common.size == 0:
            return 0.0
        return float(np.minimum(self.kf_word_wts[a][ca],
                                self.kf_word_wts[b][cb]).sum())

    def _group_best(self, cands, scores, common=None):
        """Per candidate: its covisibility group's (top-10 neighbours)
        accumulated score and the group's best keyframe."""
        acc, best_of_group = [], []
        for c in cands:
            group = np.concatenate(
                [[c], self.store.covisible_kfs(int(c), top_n=10)]
            ).astype(np.int64)
            gs = scores[group]
            if common is not None:
                gs = gs * (common[group] > 0)
            acc.append(gs.sum())
            best_of_group.append(group[np.argmax(gs)])
        return np.array(acc), np.array(best_of_group)

    # ------------------------------------------------------------------
    def detect_loop_candidates(self, kf: int, min_score: float):
        store = self.store
        ids = self.kf_word_ids.get(kf)
        if ids is None:
            return np.zeros(0, np.int64)
        active = self._active_mask()
        active[kf] = False
        # exclude covisible keyframes: the loop must close a long cycle
        connected = store.covis[kf, : store.n_kf] >= 15
        cand_mask = active & ~connected
        if not cand_mask.any():
            return np.zeros(0, np.int64)
        common, scores = self._accumulate(ids, self.kf_word_wts[kf])
        common[~cand_mask] = 0
        max_common = common.max(initial=0)
        if max_common < 1:
            return np.zeros(0, np.int64)
        min_common = max(int(0.8 * max_common), 1)
        ok = cand_mask & (common >= min_common) & (scores >= min_score)
        cands = np.nonzero(ok)[0]
        if len(cands) == 0:
            return np.zeros(0, np.int64)
        acc, best_of_group = self._group_best(cands, scores, common)
        return np.unique(best_of_group[acc > 0.75 * acc.max()])

    def detect_relocalization_candidates(self, kp: Keypoints):
        q_ids, q_wts = self.transform_frame(kp)
        active = self._active_mask()
        if not active.any():
            return np.zeros(0, np.int64)
        common, scores = self._accumulate(q_ids, q_wts)
        common[~active] = 0
        max_common = common.max(initial=0)
        if max_common < 1:
            return np.zeros(0, np.int64)
        min_common = max(int(0.8 * max_common), 1)
        cands = np.nonzero(active & (common >= min_common))[0]
        if len(cands) == 0:
            return np.zeros(0, np.int64)
        acc, best_of_group = self._group_best(cands, scores)
        keep = acc > 0.75 * acc.max()
        order = np.argsort(-acc[keep], kind="stable")
        return np.unique(best_of_group[keep][order])[:10]

    # ------------------------------------------------------------------
    def min_covisible_score(self, kf: int) -> float:
        """The reference's loop gate: the least BoW score between kf and
        its covisible neighbours."""
        neighbors = self.store.covisible_kfs(kf, min_weight=15)
        if len(neighbors) == 0:
            return 0.0
        return min(self.pair_score(kf, int(n)) for n in neighbors)


def transform_sparse(voc: Vocabulary, kp: Keypoints):
    """Descriptor batch -> sparse L1-normalized tf-idf BoW (sorted unique
    word ids, weights), by the host descent, never materializing the
    (n_words,) dense vector. `kp` holds host (numpy) arrays."""
    desc_u8 = np.asarray(kp.desc_u8)
    valid = np.asarray(kp.valid)
    pm1 = (np.unpackbits(desc_u8, axis=-1, bitorder="little")
           .astype(np.int8) * 2 - 1)
    words = descend_np(voc, pm1)
    w = words[valid & (words >= 0)]
    if w.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    ids, counts = np.unique(w, return_counts=True)
    wts = (voc.weights[ids] * counts).astype(np.float32)
    s = wts.sum()
    if s > 0:
        wts /= s
    return ids.astype(np.int64), wts

"""Hierarchical bag-of-words vocabulary for binary descriptors.

Replaces DBoW2's TemplatedVocabulary:
- the tree is flat per-node centroid tables (±1 int8, kept as numpy on
  the host); descriptor→word descent is L rounds of batched Hamming argmin,
  each round one ±1 product against the gathered children;
- training is hierarchical k-majority (binary k-means): centroids are
  bitwise majority votes of their cluster;
- scoring uses L1-normalized tf-idf BoW vectors with the DBoW2 L1 score
  s(v,w) = Σ_i min(v_i, w_i) (= 1 − ½|v−w|₁ for L1-normalized vectors).

The keyframe database descends on the host (`descend_np`); `_descend` is
the same descent in torch, on whatever device the descriptors are.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Vocabulary(NamedTuple):
    branching: int            # k
    depth: int                # L
    centroids: np.ndarray     # (n_internal_nodes, k, 256) int8 ±1
    weights: np.ndarray       # (n_words,) f32 idf weights
    n_words: int

    def save(self, path: str):
        np.savez_compressed(
            path, branching=self.branching, depth=self.depth,
            centroids=np.asarray(self.centroids),
            weights=np.asarray(self.weights))

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        k, L = int(z["branching"]), int(z["depth"])
        return Vocabulary(k, L, np.asarray(z["centroids"], np.int8),
                          np.asarray(z["weights"], np.float32), k ** L)


def _offsets(k: int, L: int) -> np.ndarray:
    """Flat index of the first node of each level."""
    return np.cumsum([0] + [k ** l for l in range(L)])


def descend_np(voc: Vocabulary, desc_pm1_np: np.ndarray) -> np.ndarray:
    """Host descriptor→word descent; (N,256) ±1 -> word ids (N,). Per
    level, the (N,k,256) gathered children times the descriptors in f32
    (exact: every dot is an integer of magnitude ≤ 256); np.argmax takes
    the first maximum."""
    k, L = voc.branching, voc.depth
    N = desc_pm1_np.shape[0]
    offsets = _offsets(k, L)
    cents = voc.centroids
    node = np.zeros(N, np.int32)
    d = desc_pm1_np.astype(np.float32)[:, :, None]   # (N,256,1)
    for l in range(L):
        c = cents[offsets[l] + node]      # (N,k,256), the gathered slice only
        dots = np.matmul(c.astype(np.float32), d)[:, :, 0]
        node = node * k + np.argmax(dots, 1).astype(np.int32)
    return node


def _kmajority(desc_pm1: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-means via bitwise majority; desc (N,256) ±1 int8."""
    N = desc_pm1.shape[0]
    if N == 0:
        return np.ones((k, 256), np.int8)
    init = rng.choice(N, size=min(k, N), replace=False)
    cents = desc_pm1[init].astype(np.int8)
    if len(init) < k:
        cents = np.concatenate(
            [cents, np.tile(cents[-1:], (k - len(init), 1))], 0)
    x = desc_pm1.astype(np.int32)
    for _ in range(iters):
        # hamming = (256 - dot)/2: assign to the argmax dot
        assign = np.argmax(x @ cents.T.astype(np.int32), 1)
        new = np.empty_like(cents)
        for c in range(k):
            members = desc_pm1[assign == c]
            if len(members) == 0:
                new[c] = desc_pm1[rng.integers(N)]
            else:
                s = members.astype(np.int32).sum(0)
                maj = np.where(s > 0, 1, -1).astype(np.int8)
                maj[s == 0] = cents[c][s == 0]
                new[c] = maj
        if np.array_equal(new, cents):
            break
        cents = new
    return cents


def train_vocabulary(desc_pm1: np.ndarray, branching: int = 8,
                     depth: int = 3, seed: int = 0,
                     max_train: int = 30000,
                     iters: int = 8) -> Vocabulary:
    """Train a k^L-word tree from (N,256) ±1 descriptors, breadth first."""
    rng = np.random.default_rng(seed)
    if len(desc_pm1) > max_train:
        desc_pm1 = desc_pm1[rng.choice(len(desc_pm1), max_train,
                                       replace=False)]
    k, L = branching, depth
    offsets = _offsets(k, L)
    centroids = np.ones((offsets[-1], k, 256), np.int8)
    clusters = {0: desc_pm1}  # node index within the level
    for l in range(L):
        next_clusters = {}
        for j in range(k ** l):
            data = clusters.get(j, np.zeros((0, 256), np.int8))
            cents = _kmajority(data, k, rng, iters=iters)
            centroids[offsets[l] + j] = cents
            if len(data):
                assign = np.argmax(
                    data.astype(np.int32) @ cents.T.astype(np.int32), 1)
                for c in range(k):
                    next_clusters[j * k + c] = data[assign == c]
        clusters = next_clusters
    # idf weights from the training data's word occupancy
    n_words = k ** L
    counts = np.array([len(clusters.get(w, ())) for w in range(n_words)],
                      np.float64)
    N = max(len(desc_pm1), 1)
    idf = np.log(N / np.maximum(counts, 1.0)).astype(np.float32)
    idf[counts == 0] = 0.0
    return Vocabulary(k, L, centroids, idf, n_words)


def load_dbow2_text(path: str) -> Vocabulary:
    """Import a DBoW2 text vocabulary (`ORBvoc.txt`). Layout: header
    `k L scoring weighting`, then one line per non-root node in creation
    (BFS) order: `parent_id is_leaf b0..b31 weight`."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        body = f.read()
    flat = np.array(body.split(), dtype=np.float64)
    if flat.size == 0:
        raise ValueError(f"empty vocabulary file {path}")
    ncols = 2 + 32 + 1
    if flat.size % ncols:
        raise ValueError(f"{path}: not a DBoW2 text vocabulary "
                         f"({flat.size} values not divisible by {ncols})")
    rows = flat.reshape(-1, ncols)
    return _relayout_dbow2(k, L, rows[:, 0].astype(np.int64), rows[:, 1] != 0,
                           rows[:, 2:34].astype(np.uint8),
                           rows[:, 34].astype(np.float32))


def load_dbow2_binary(path: str) -> Vocabulary:
    """Import a DBoW2 binary vocabulary. Header: uint32 nb_nodes, uint32
    size_node, int32 k, int32 L, int32 scoring, int32 weighting; then one
    41-byte record per non-root node in BFS order: int32 parent | 32-byte
    descriptor | float32 weight | 1-byte is_leaf."""
    raw = np.fromfile(path, np.uint8)
    if raw.size < 24:
        raise ValueError(f"{path}: too short for a DBoW2 binary vocabulary")
    nb_nodes, size_node = np.frombuffer(raw[:8].tobytes(), "<u4")
    k, L = np.frombuffer(raw[8:16].tobytes(), "<i4")
    if size_node != 4 + 32 + 4 + 1:
        raise ValueError(f"{path}: node record size {size_node} != 41 "
                         "(not an ORB/FORB binary vocabulary)")
    body = raw[24:]
    n = body.size // size_node
    if n < max(int(nb_nodes) - 1, 1):
        raise ValueError(f"{path}: truncated ({n} records, header says "
                         f"{nb_nodes} nodes)")
    rec = body[: n * size_node].reshape(n, size_node)
    parents = rec[:, :4].copy().view("<i4")[:, 0].astype(np.int64)
    leaf_weight = rec[:, 36:40].copy().view("<f4")[:, 0].astype(np.float32)
    return _relayout_dbow2(int(k), int(L), parents, rec[:, 40] != 0,
                           rec[:, 4:36].copy(), leaf_weight)


def load_dbow2(path: str) -> Vocabulary:
    """Load a vocabulary file by suffix: .npz native, .bin binary DBoW2,
    anything else DBoW2 text."""
    if path.endswith(".npz"):
        return Vocabulary.load(path)
    if path.endswith(".bin"):
        return load_dbow2_binary(path)
    return load_dbow2_text(path)


def _relayout_dbow2(k, L, parents, is_leaf, desc_u8, leaf_weight):
    """Re-lay a DBoW2 (parent, is_leaf, desc, weight) node table out as
    complete-tree centroid tables. Missing children are copies of the first
    present child (argmax ties go to the lowest index, so descent through a
    padded branch lands on the real child's word); early leaves are
    extended downward by self-copies, their weight on the child-0 path."""
    bits = np.unpackbits(desc_u8, axis=1, bitorder="little")
    pm1 = (bits.astype(np.int8) * 2 - 1).astype(np.int8)

    n_nodes = len(parents)
    node_ids = np.arange(1, n_nodes + 1)          # file order = DBoW2 id
    order = np.argsort(parents, kind="stable")
    child_sorted = node_ids[order]
    parent_sorted = parents[order]
    starts = np.searchsorted(parent_sorted, np.arange(0, n_nodes + 1), "left")
    ends = np.searchsorted(parent_sorted, np.arange(0, n_nodes + 1), "right")

    offsets = _offsets(k, L)
    centroids = np.ones((offsets[-1], k, 256), np.int8)
    weights = np.zeros(k ** L, np.float32)

    # BFS frontier; virtual (padding) nodes carry the (desc, weight) of the
    # early leaf they extend
    frontier = [(0, 0, None, 0.0)]  # (dbow_id | -1, lvl_index, pm1_desc, w)
    for l in range(L):
        nxt = []
        for nid, j, vdesc, vw in frontier:
            if nid >= 0:
                kids = child_sorted[starts[nid]:ends[nid]][:k]
            else:
                kids = np.zeros(0, np.int64)
            cents = np.ones((k, 256), np.int8)
            if len(kids):
                kd = pm1[kids - 1]
                cents[: len(kids)] = kd
                if len(kids) < k:    # pad with the first child
                    cents[len(kids):] = kd[0]
            elif vdesc is not None:  # extending an early leaf downward
                cents[:] = vdesc
            centroids[offsets[l] + j] = cents
            if l + 1 == L:
                for c in range(min(len(kids), k)):
                    weights[j * k + c] = leaf_weight[kids[c] - 1]
                if len(kids) == 0 and vdesc is not None:
                    weights[j * k] = vw
                continue
            for c in range(k):
                if c < len(kids):
                    kid = int(kids[c])
                    if is_leaf[kid - 1] or starts[kid] == ends[kid]:
                        nxt.append((-1, j * k + c, pm1[kid - 1],
                                    leaf_weight[kid - 1]))
                    else:
                        nxt.append((kid, j * k + c, None, 0.0))
                elif len(kids):      # padded copy of the first child
                    nxt.append((-1, j * k + c, cents[c], 0.0))
                elif vdesc is not None:
                    nxt.append((-1, j * k + c, vdesc, vw if c == 0 else 0.0))
        frontier = nxt
    return Vocabulary(k, L, centroids, weights, k ** L)


def _descend(voc: Vocabulary, desc_pm1):
    """(N,256) ±1 tensor -> (word_id (N,), node_ids_per_level (L,N)), on
    the descriptors' device. The ±1 product runs in f32 with TF32 off
    (package-wide), exact for integers up to 2^24; each row's argmax is
    the first maximum, as the reference's (the row-wise form of
    `solvers.ransac.first_argmax`)."""
    k, L = voc.branching, voc.depth
    dev = desc_pm1.device
    N = desc_pm1.shape[0]
    offsets = _offsets(k, L)
    cents_all = torch.as_tensor(voc.centroids, device=dev)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    d = desc_pm1.to(torch.float32)[:, :, None]            # (N,256,1)
    iota = torch.arange(k, device=dev)
    per_level = []
    for l in range(L):
        cents = cents_all[int(offsets[l]) + node].to(torch.float32)
        dots = torch.bmm(cents, d)[:, :, 0]               # (N,k)
        best = torch.where(dots == dots.amax(1, keepdim=True), iota,
                           k).amin(1)
        node = node * k + best
        per_level.append(node)
    return node.to(torch.int32), torch.stack(per_level).to(torch.int32)


def transform(voc: Vocabulary, desc_pm1, valid, levels_up: int = 2):
    """(bow (n_words,) L1-normalized tf-idf, word_ids (N,), node_ids (N,)
    at depth L−levels_up) of one frame's descriptors."""
    word, per_level = _descend(voc, desc_pm1)
    dev = word.device
    weights = torch.as_tensor(voc.weights, device=dev)
    word = torch.where(valid, word, -1)
    wi = torch.clamp(word, min=0).long()
    w = torch.where(valid, weights[wi], 0.0)
    bow = torch.zeros(voc.n_words, dtype=torch.float32, device=dev)
    bow = bow.index_add(0, wi, w)
    bow = bow / torch.clamp(bow.sum(), min=1e-9)
    lvl = max(voc.depth - 1 - levels_up, 0)
    return bow, word, torch.where(valid, per_level[lvl], -1)


def l1_score(bow_a, bow_b):
    """DBoW2 L1 score of L1-normalized vectors: Σ min(v,w), in [0,1]."""
    return torch.sum(torch.minimum(bow_a, bow_b))


def l1_score_matrix(bow_a, bows_b):
    """bow_a (V,) against bows_b (M,V) -> (M,)."""
    return torch.sum(torch.minimum(bow_a[None, :], bows_b), dim=1)

"""DBoW2 text-format vocabulary loader — drop-in word assignment.

Port of `plslam_tpu/vocab/orbvoc.py`. The reference loads `ORBvoc.txt` with
`Thirdparty/DBoW2/TemplatedVocabulary.h:1350` (loadFromTextFile): header
line `k L scoring weighting`, then one node per line
`parent is_leaf d0..d31 weight`, node ids implicit (1-based after the
root, which is node 0), leaves numbered as words in file order
(`TemplatedVocabulary.h:1420-1428`).

Word assignment reproduces `TemplatedVocabulary::transform`'s greedy tree
descent: L steps, each a batched gather of the k candidate children's
descriptors, their Hamming distances and an `argmin` (`torch.argmin`
returns the first minimum, DBoW2's rule: children are visited in ascending
node id, which is file order). The descent tables live on a device as
tensors; a call on another device uses a copy made there once.

BoW vectors use the vocabulary's TF_IDF weighting (`m_weighting == 0` in
every shipped ORBvoc): each feature adds its word's idf weight, then the
histogram is L1-normalized (`BowVector::normalize(L1)`), so `bow.l1_score`
applies unchanged. `bow_vector` adds with an out-of-place `index_add` (in
float64, so its result does not depend on the order of the adds), so it
runs under `torch.func.vmap` and gives the same bits on the CPU and a GPU.

`words_of_np`, `train`, `save_text` and `load_text` are host numpy, as in
the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


class OrbVocabulary:
    """Parsed DBoW2 vocabulary with its descent tables on a device (the
    CPU unless `device` names another)."""

    def __init__(self, k: int, L: int, node_bits: np.ndarray,
                 children: np.ndarray, is_leaf: np.ndarray,
                 word_id: np.ndarray, word_weight: np.ndarray, device=None):
        self.k, self.L = k, L
        self.n_words = int(word_weight.shape[0])
        dev = torch.device("cpu" if device is None else device)
        self._bits = torch.as_tensor(np.asarray(node_bits, np.uint8),
                                     device=dev)               # (n_nodes, 256)
        self._children = torch.as_tensor(np.asarray(children, np.int64),
                                         device=dev)           # (n_nodes, k)
        self._leaf_word = torch.as_tensor(
            np.where(is_leaf, word_id, 0).astype(np.int32), device=dev)
        self._weights = torch.as_tensor(np.asarray(word_weight, np.float32),
                                        device=dev)
        self._copies = {}

    @property
    def device(self) -> torch.device:
        return self._bits.device

    def to(self, device) -> "OrbVocabulary":
        """Move the descent tables to `device` (in place; returns self)."""
        for name in ("_bits", "_children", "_leaf_word", "_weights"):
            setattr(self, name, getattr(self, name).to(device))
        self._copies = {}
        return self

    def _tables(self, device: torch.device):
        # copied to another device once: a copy from host memory waits for
        # the device's queue to drain, which a graph capture cannot do
        if device == self.device:
            return self._bits, self._children, self._leaf_word, self._weights
        key = str(device)
        if key not in self._copies:
            self._copies[key] = tuple(
                t.to(device) for t in (self._bits, self._children,
                                       self._leaf_word, self._weights))
        return self._copies[key]

    def words_of(self, desc_bits):
        """(N, 256) {0,1} -> (N,) int32 word ids via vocabulary-tree
        descent."""
        bits, children, leaf_word, _ = self._tables(desc_bits.device)
        d = desc_bits.to(torch.uint8)                           # (N, 256)
        cur = torch.zeros(d.shape[:-1], dtype=torch.long, device=d.device)
        for _ in range(self.L):
            kids = children[cur]                                # (N, k)
            kb = bits[kids.clamp_min(0)]                        # (N, k, 256)
            dist = (kb != d[..., None, :]).sum(-1)              # (N, k)
            dist = torch.where(kids >= 0, dist, 1 << 16)
            best = torch.gather(kids, -1, dist.argmin(-1, keepdim=True))[..., 0]
            # a node whose children are all padding (leaf) keeps its id
            cur = torch.where(best >= 0, best, cur)
        return leaf_word[cur]

    def bow_vector(self, desc_bits, valid):
        """(N,256),(N,) -> (n_words,) L1-normalized tf-idf histogram.

        The float32 weights are summed in float64, where each word's sum
        is exact in any order and the L1 total rounds far below float32's
        step, so a GPU gives the CPU's bits (the JAX package sums in
        float32, within 1e-6 of this)."""
        weights = self._tables(desc_bits.device)[3]
        w = self.words_of(desc_bits).long()
        add = (valid.to(torch.float32) * weights[w]).to(torch.float64)
        hist = torch.zeros(self.n_words, dtype=torch.float64,
                           device=desc_bits.device).index_add(0, w, add)
        return (hist / hist.sum().clamp_min(1e-9)).to(torch.float32)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def words_of_np(voc: OrbVocabulary, desc_bits: np.ndarray) -> np.ndarray:
    """Host-side greedy descent (training + parity checks for `words_of`)."""
    bits = _host(voc._bits)
    children = _host(voc._children)
    leaf_word = _host(voc._leaf_word)
    out = np.zeros(desc_bits.shape[0], np.int32)
    for i, d in enumerate(desc_bits):
        cur = 0
        for _ in range(voc.L):
            kids = children[cur]
            kids = kids[kids >= 0]
            if kids.size == 0:
                break
            cur = int(kids[np.argmin((bits[kids] != d[None]).sum(-1))])
        out[i] = leaf_word[cur]
    return out


def _majority(bits: np.ndarray) -> np.ndarray:
    """Cluster center of binary descriptors: bitwise majority vote —
    the binary mean `DBoW2::FORB::meanValue` computes bytewise."""
    return (2 * bits.sum(0) >= bits.shape[0]).astype(np.uint8)


def _kmeans_binary(bits: np.ndarray, k: int, rng) -> np.ndarray:
    """k-means++ seeded binary k-means (majority centers); returns the
    per-descriptor cluster assignment. `TemplatedVocabulary::HKmeansStep`."""
    n = bits.shape[0]
    centers = [bits[rng.integers(n)]]
    d2 = (bits != centers[0][None]).sum(-1).astype(np.float64) ** 2
    for _ in range(k - 1):
        p = d2 / max(d2.sum(), 1e-9)
        centers.append(bits[rng.choice(n, p=p)])
        d2 = np.minimum(d2, (bits != centers[-1][None]).sum(-1) ** 2)
    C = np.stack(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(8):
        dist = (bits[:, None, :] != C[None, :, :]).sum(-1)      # (n, k)
        new = dist.argmin(-1)
        if (new == assign).all():
            break
        assign = new
        for j in range(k):
            if (assign == j).any():
                C[j] = _majority(bits[assign == j])
    return assign


def train(per_image_desc: list, k: int = 8, L: int = 3,
          seed: int = 0) -> OrbVocabulary:
    """Build a k^L vocabulary from per-image (Ni, 256) {0,1} descriptor
    arrays — `TemplatedVocabulary::create` (hierarchical binary k-means,
    tf-idf node weights from the training corpus)."""
    rng = np.random.default_rng(seed)
    all_bits = np.concatenate([np.asarray(d, np.uint8) for d in per_image_desc])

    node_bits = [np.zeros(256, np.uint8)]                        # root
    parents, leaf_flags = [-1], [False]

    def expand(subset: np.ndarray, parent: int, level: int) -> None:
        if level == L or subset.shape[0] <= k:
            # leaves below max depth: each remaining descriptor cluster
            # still becomes ONE word at this node (early-out leaf)
            leaf_flags[parent] = True
            return
        assign = _kmeans_binary(subset, k, rng)
        for j in range(k):
            sel = subset[assign == j]
            if sel.shape[0] == 0:
                continue
            node_bits.append(_majority(sel))
            parents.append(parent)
            leaf_flags.append(False)
            expand(sel, len(node_bits) - 1, level + 1)

    expand(all_bits, 0, 0)
    # any childless node is a word
    has_child = np.zeros(len(node_bits), bool)
    for nid, p in enumerate(parents):
        if p >= 0:
            has_child[p] = True
    is_leaf = ~has_child
    is_leaf[0] = False if has_child[0] else True

    children = np.full((len(node_bits), k), -1, np.int32)
    n_children = np.zeros(len(node_bits), np.int32)
    for nid, p in enumerate(parents):
        if p >= 0:
            children[p, n_children[p]] = nid
            n_children[p] += 1

    word_id = np.full(len(node_bits), -1, np.int32)
    word_id[is_leaf] = np.arange(int(is_leaf.sum()))
    voc = OrbVocabulary(k, L, np.stack(node_bits), children, is_leaf,
                        word_id, np.ones(int(is_leaf.sum()), np.float32))

    # idf weights: w_i = log(N_images / n_images_containing_word_i)
    # (`TemplatedVocabulary::setNodeWeights`, IDF part of TF_IDF)
    n_img = len(per_image_desc)
    n_with = np.zeros(voc.n_words, np.int64)
    for d in per_image_desc:
        w = np.unique(words_of_np(voc, np.asarray(d, np.uint8)))
        n_with[w] += 1
    idf = np.where(n_with > 0, np.log(n_img / np.maximum(n_with, 1)), 0.0)
    idf = np.maximum(idf, 1e-3).astype(np.float32)   # keep ubiquitous words
    voc._weights = torch.as_tensor(idf)
    return voc


def save_text(voc: OrbVocabulary, path: str) -> None:
    """Write the DBoW2 text format `load_text` / the reference reads
    (`TemplatedVocabulary.h:1461` saveToTextFile)."""
    bits = _host(voc._bits)
    children = _host(voc._children)
    is_leaf = _host(voc._leaf_word)
    weights = _host(voc._weights)
    parents = np.full(bits.shape[0], -1, np.int64)
    for p in range(children.shape[0]):
        for c in children[p]:
            if c >= 0:
                parents[c] = p
    leaf = np.zeros(bits.shape[0], bool)
    has_child = (children >= 0).any(-1)
    leaf[1:] = ~has_child[1:]
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.L} 0 0\n")
        for nid in range(1, bits.shape[0]):
            byts = np.packbits(bits[nid], bitorder="little")
            w = weights[is_leaf[nid]] if leaf[nid] else 0.0
            f.write(f"{parents[nid]} {int(leaf[nid])} "
                    + " ".join(str(int(b)) for b in byts)
                    + f" {float(w)}\n")


def load_text(path: str) -> OrbVocabulary:
    """Parse the DBoW2 text format (`TemplatedVocabulary.h:1350-1436`)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        rows = [ln.split() for ln in f if ln.strip()]

    n_nodes = len(rows) + 1                                  # + root
    node_bits = np.zeros((n_nodes, 256), np.uint8)
    children = np.full((n_nodes, k), -1, np.int32)
    n_children = np.zeros(n_nodes, np.int32)
    is_leaf = np.zeros(n_nodes, bool)
    word_id = np.full(n_nodes, -1, np.int32)
    weights = []

    for nid, r in enumerate(rows, start=1):
        pid, leaf = int(r[0]), int(r[1])
        children[pid, n_children[pid]] = nid                 # file order ==
        n_children[pid] += 1                                 # ascending id
        byts = np.array([int(v) for v in r[2:34]], np.uint8)
        node_bits[nid] = np.unpackbits(byts, bitorder="little")
        if leaf > 0:
            is_leaf[nid] = True
            word_id[nid] = len(weights)
            weights.append(float(r[34]))

    return OrbVocabulary(k, L, node_bits, children, is_leaf, word_id,
                         np.asarray(weights, np.float32))

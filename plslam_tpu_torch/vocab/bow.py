"""Bag-of-binary-words signatures and scoring.

Port of `plslam_tpu/vocab/bow.py`. By default a word is 12 fixed bit
positions of the 256-bit descriptor (LSH), drawn from the same numpy seed as
the JAX package, and a frame signature is the L1-normalized word histogram.
`set_vocabulary` installs a DBoW2 tree vocabulary (`orbvoc.OrbVocabulary`)
instead: words then come from its tree descent and the histogram from its
idf weights. Keyframe insertion stores the signature in `MapState.kf_bow`;
relocalization and loop detection score against it with the DBoW2 L1
score.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

N_WORDS_BITS = 12            # 4096 words
N_WORDS = 1 << N_WORDS_BITS


def _make_bit_selection(seed: int = 271828) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(256, size=N_WORDS_BITS, replace=False).astype(np.int32)


BIT_SEL = _make_bit_selection()


# Optional drop-in vocabulary (DBoW2 ORBvoc text format, `orbvoc.py`):
# when set, word assignment and weighting go through its tree instead of the
# LSH words. Set it BEFORE any MapState is allocated (`kf_bow` is N_WORDS
# wide at allocation).
_VOCAB = None


def set_vocabulary(voc) -> None:
    """Install an `orbvoc.OrbVocabulary` (or None to restore LSH words)."""
    global _VOCAB, N_WORDS
    _VOCAB = voc
    N_WORDS = voc.n_words if voc is not None else (1 << N_WORDS_BITS)


@functools.lru_cache(maxsize=None)
def _bit_sel(device: torch.device):
    # copied to each device once: a copy from host memory waits for the
    # device's queue to drain
    return torch.as_tensor(BIT_SEL, dtype=torch.long, device=device)


def words_of(desc_bits):
    """(N, 256) {0,1} -> (N,) int32 word ids (LSH, or the installed
    vocabulary's tree)."""
    if _VOCAB is not None:
        return _VOCAB.words_of(desc_bits)
    sel = _bit_sel(desc_bits.device)
    weights = 1 << torch.arange(N_WORDS_BITS, dtype=torch.int32,
                                device=desc_bits.device)
    return torch.sum(desc_bits[..., sel].to(torch.int32) * weights, dim=-1,
                     dtype=torch.int32)


def bow_vector(desc_bits, valid):
    """(N,256),(N,) -> (N_WORDS,) L1-normalized word histogram (tf, or
    the installed vocabulary's tf-idf)."""
    if _VOCAB is not None:
        return _VOCAB.bow_vector(desc_bits, valid)
    w = words_of(desc_bits).long()
    hist = torch.zeros(N_WORDS, dtype=torch.float32, device=desc_bits.device)
    hist = hist.index_add(0, w, valid.to(torch.float32))
    return hist / hist.sum().clamp_min(1e-9)


def l1_score(v, W):
    """DBoW2 L1 similarity of v (N_WORDS,) against the rows of W (K,
    N_WORDS): s = sum_i min(v_i, w_i) in [0, 1] (= 1 - |v - w|_1 / 2 for
    L1-normalized vectors)."""
    return torch.minimum(v[None, :], W).sum(-1)


def detect_candidates(query_bow, kf_bows, kf_mask, exclude_mask,
                      min_score, top_k: int = 8):
    """`KeyFrameDatabase::DetectLoopCandidates` in dense form: score every
    keyframe, drop the excluded ones, keep those >= min_score; returns the
    top-k ids (-1 where the score is not positive) and scores, best first,
    ties to the lower id."""
    scores = l1_score(query_bow, kf_bows)
    ok = kf_mask & ~exclude_mask & (scores >= min_score)
    vals, idx = torch.sort(torch.where(ok, scores, -1.0), descending=True,
                           stable=True)
    k = min(top_k, scores.shape[0])
    vals, idx = vals[:k], idx[:k]
    return torch.where(vals > 0, idx, -1), vals

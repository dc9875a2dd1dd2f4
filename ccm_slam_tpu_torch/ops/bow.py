"""Bag-of-binary-words vocabulary: training, transform, scoring (PyTorch).

Counterpart of ``ccm_slam_tpu/ops/bow.py`` (the reference's DBoW2 with a
flat codebook): a vocabulary is W binary centroids plus idf weights, trained
by binary k-medians (per-bit majority vote); ``transform`` quantizes a
frame's descriptors to their nearest word, tf-idf weights and L1-normalizes
the histogram; ``l1_score`` is DBoW2's 1 - 0.5 |v - w|_1.

Nearest word: the best index of ``hamming_kernels.hamming_top2`` (the CUDA
kernel on the card, its plain version on the CPU), whose lowest-index-first
tie rule is ``jnp.argmin``'s; no [N, W] distance or one-hot matrix is built.
Word counts and per-bit sums are integer sums (exact in any order), and
training draws its initial centroids ``perm`` from ``generator`` when none
are given (``torch.multinomial`` over the valid descriptors, where the
reference calls ``jax.random.choice``).  ``train_vocabulary_large`` is the
trainer at ORBvoc scale (tens of thousands of words), in descriptor blocks.

``VOCAB32K`` is the port's own copy of the reference's 32,768-word
codebook (``data/vocab32k.npz``, byte for byte); ``load_vocabulary()``
reads it when no path is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from . import hamming
from .hamming_kernels import hamming_top2

_CHUNK = 16384  # descriptors per bit-sum pass in training
VOCAB32K = str(Path(__file__).resolve().parents[1] / "data" / "vocab32k.npz")


@dataclass(frozen=True)
class Vocabulary:
    words: torch.Tensor  # [W, 32] uint8 binary centroids
    idf: torch.Tensor    # [W] float32 inverse document frequency weights

    @property
    def n_words(self):
        return self.words.shape[0]


def nearest_word(vocab_words, descs, valid):
    """[N] int64: each descriptor's nearest word (lowest index on ties; 0
    for invalid descriptors)."""
    ones = torch.ones(vocab_words.shape[0], dtype=torch.bool, device=descs.device)
    return hamming_top2(descs.contiguous(), valid.contiguous(), vocab_words.contiguous(),
                        ones)[0].long()


def _idf(counts):
    df = counts / torch.clamp(torch.sum(counts), min=1.0)
    idf = torch.log(1.0 / torch.clamp(df, min=1e-6))
    return torch.where(counts > 0, idf, 0.0)


def _majority_centroid(bits, weights):
    """Binary centroid by weighted per-bit majority vote: bits [N,256] {0,1},
    weights [N] -> [256] uint8 {0,1}."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-9)
    return (torch.sum(bits * w[:, None], dim=0) >= 0.5).to(torch.uint8)


def _em_update(words, descs, valid, assign, n_words):
    """One majority-vote update from an assignment: (words', counts f32)."""
    dev = descs.device
    N = descs.shape[0]
    cnt = torch.zeros(n_words, dtype=torch.int32, device=dev).index_add_(
        0, assign, valid.to(torch.int32))
    sums = torch.zeros(n_words, 256, dtype=torch.int32, device=dev)
    for n0 in range(0, N, _CHUNK):
        bits = hamming.unpack_bits(descs[n0:n0 + _CHUNK]).to(torch.int32)
        bits = bits * valid[n0:n0 + _CHUNK, None].to(torch.int32)
        sums.index_add_(0, assign[n0:n0 + _CHUNK], bits)
    counts = cnt.to(torch.float32)
    mean = sums.to(torch.float32) / torch.clamp(counts[:, None], min=1e-9)
    new_words = hamming.pack_bits((mean >= 0.5).to(torch.uint8))
    # dead clusters keep their previous centroid
    return torch.where(counts[:, None] > 0, new_words, words), counts


def train_vocabulary(descs, valid, n_words: int = 1024, iters: int = 8, perm=None,
                     generator=None) -> Vocabulary:
    """Binary k-medians over a descriptor sample: descs [N,32] uint8, valid
    [N] bool.  ``perm`` [n_words]: the descriptors that seed the centroids
    (else drawn from ``generator`` in proportion to ``valid``, with
    replacement only when N < n_words; with fewer valid descriptors than
    words, all valid ones and then invalid ones in index order).  Clusters left empty keep their
    centroid; idf comes from the last assignment's word frequencies."""
    N = descs.shape[0]
    dev = descs.device
    if perm is None:
        n_valid = int(torch.sum(valid))
        if N >= n_words > n_valid:
            # fewer valid descriptors than words (one frame's features): every
            # valid one in random order, then the invalid ones in index order,
            # as jax.random.choice without replacement orders them
            idx = torch.arange(N, device=dev)
            live = idx[valid]
            live = live[torch.randperm(n_valid, generator=generator, device=dev)]
            perm = torch.cat([live, idx[~valid]])[:n_words]
        else:
            p = valid.to(torch.float32) / torch.clamp(torch.sum(valid), min=1)
            perm = torch.multinomial(p, n_words, replacement=N < n_words, generator=generator)
    words = descs[perm.long()]
    counts = torch.zeros(n_words, dtype=torch.float32, device=dev)
    for _ in range(iters):
        words, counts = _em_update(words, descs, valid, nearest_word(words, descs, valid),
                                   n_words)
    return Vocabulary(words=words, idf=_idf(counts))


def train_vocabulary_large(descs, n_words: int = 32768, iters: int = 6, block: int = 8192,
                           perm=None, generator=None) -> Vocabulary:
    """Binary k-medians at ORBvoc scale over ALL of ``descs`` [N,32] (a
    pre-filtered sample): each iteration assigns ``block`` descriptors per
    nearest-word call, so no [N, W] matrix is formed.  ``perm`` [n_words]
    seeds the centroids (else drawn uniformly from ``generator``, with
    replacement only when N < n_words, as ``jax.random.choice``)."""
    N = descs.shape[0]
    dev = descs.device
    if perm is None:
        p = torch.ones(N, dtype=torch.float32, device=dev)
        perm = torch.multinomial(p, n_words, replacement=N < n_words, generator=generator)
    words = descs[perm.long()]
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    counts = torch.zeros(n_words, dtype=torch.float32, device=dev)
    for _ in range(iters):
        assign = torch.cat([nearest_word(words, descs[n0:n0 + block], valid[n0:n0 + block])
                            for n0 in range(0, N, block)])
        words, counts = _em_update(words, descs, valid, assign, n_words)
    return Vocabulary(words=words, idf=_idf(counts))


def save_vocabulary(path: str, vocab: Vocabulary):
    """Persist the codebook as an npz (the ORBvoc.txt analogue)."""
    np.savez_compressed(path, words=vocab.words.cpu().numpy(), idf=vocab.idf.cpu().numpy())


def load_vocabulary(path: str = None, device=None) -> Vocabulary:
    """A saved codebook (the port's ``VOCAB32K`` when ``path`` is None) on
    ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    z = np.load(VOCAB32K if path is None else path)
    return Vocabulary(words=torch.as_tensor(z["words"]).to(dev),
                      idf=torch.as_tensor(z["idf"]).to(dev))


def transform_batch(vocab: Vocabulary, descs, valid):
    """Frame descriptors -> (bow [B,W] tf-idf L1-normalized, word_id [B,N]):
    descs [B,N,32], valid [B,N], all frames in one nearest-word call."""
    B, N = valid.shape
    W = vocab.n_words
    word = nearest_word(vocab.words, descs.reshape(B * N, 32), valid.reshape(-1)).reshape(B, N)
    slot = torch.arange(B, device=word.device)[:, None] * W + torch.where(valid, word, 0)
    tf = torch.zeros(B * W, dtype=torch.int32, device=word.device).index_add_(
        0, slot.reshape(-1), valid.reshape(-1).to(torch.int32)).reshape(B, W)
    v = tf.to(torch.float32) * vocab.idf
    v = v / torch.clamp(torch.sum(torch.abs(v), -1, keepdim=True), min=1e-9)
    return v, torch.where(valid, word, -1).to(torch.int32)


def transform(vocab: Vocabulary, descs, valid):
    """One frame: descs [N,32], valid [N] -> (bow [W], word_id [N])."""
    v, word = transform_batch(vocab, descs[None], valid[None])
    return v[0], word[0]


def l1_score(v1, v2):
    """DBoW2 L1 score in [0,1]: 1 - 0.5 |v1 - v2|_1 (vectors L1-normalized),
    batched over leading dims of either argument."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)


def score_against_database(v, db_vectors, db_valid):
    """One BoW vector against a bank of stored vectors: [K] scores (-1 where
    the bank row is not valid)."""
    return torch.where(db_valid, l1_score(v[None, :], db_vectors), -1.0)

"""Vocabulary tree with inverted file and Bayesian loop filtering.

Port of ``slslam_tpu/loopclosure/voctree.py`` (the reference's
voctree_bf.h, template voctree_t<K=40, L=3, D=72>; see the JAX module's
docstring for the semantics and the reference lines).  The per-query work
runs as dense tensor operations on the tree's device, in float32 as in the
JAX package: the batched greedy descent (``_descend``), the tf-idf L1
scoring of a query against every document plus the virtual average
document (``_score_query``), and the Gaussian-transition posterior update
(``_posterior_update``).  The insertion bookkeeping (quarantine queue,
leaf populations, the document table) stays on the host, as there.

Ties follow JAX's rule, the first index: the descent's argmax and every
other argmax here select the lowest index among equal values explicitly.
The numpy vocabulary training (``_kmeans``, ``build_vocabulary``) is a copy
of voctree.py:484-555.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.ransac import first_argmax

BRANCH_FACTOR = 40
LEVELS = 3
DESC_DIM = 72

_FEAT_BUCKETS = (32, 64, 128, 256, 512, 1024)
_GAUSS_REACH = 10      # trans_prob cuts the Gaussian at dist >= 10 (:584)
_DESCEND_CHUNK = 4096  # features per descent step (bounds the (F,K,D) gather)


def _bucket(n, buckets=_FEAT_BUCKETS):
    """Capacity bucket of n (voctree.py:63-73): past the last bucket, the
    next power of two."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class VocTreeParams:
    """The indoor preset (voctree_bf.h:24-29); the outdoor variants
    (:31-43) through the factory classmethods (voctree.py:76-104)."""

    non_consider_recent: int = 40
    sigma: float = 1.0
    threshold: float = 0.7
    consider_seq_length: int = 10
    num_avg_words: int = 50

    @classmethod
    def indoor(cls) -> "VocTreeParams":
        """voctree_bf.h:24-29 (the compiled-in default)."""
        return cls()

    @classmethod
    def outdoor(cls) -> "VocTreeParams":
        """voctree_bf.h:31-36."""
        return cls(non_consider_recent=100, sigma=0.8, threshold=0.8,
                   consider_seq_length=15)

    @classmethod
    def outdoor_long_loop(cls) -> "VocTreeParams":
        """voctree_bf.h:38-43."""
        return cls(non_consider_recent=300, sigma=0.8, threshold=0.5,
                   consider_seq_length=5)


def gauss_taps(sigma, device):
    """Gaussian taps (voctree_bf.h:156-160) for |i-j| < _GAUSS_REACH,
    float32."""
    d = np.abs(np.arange(-(_GAUSS_REACH - 1), _GAUSS_REACH))
    return torch.as_tensor(1.0 / math.sqrt(2 * math.pi * sigma * sigma)
                           * np.exp(-(d * d) / (2 * sigma * sigma)),
                           dtype=torch.float32, device=device)


def _descend(centroids, feats, valid):
    """Batched greedy tree descent (voctree.py:105-121): centroids
    (num_int, K, D), feats (F, D) normalized, valid (F,) -> (F,) leaf
    indices in global node numbering, -1 where not valid.  The dot
    products are elementwise products and sums (no reduced-precision
    matmul path)."""
    K = centroids.shape[1]
    out = []
    for s in range(0, feats.shape[0], _DESCEND_CHUNK):
        f = feats[s:s + _DESCEND_CHUNK]
        idx = torch.zeros(f.shape[0], dtype=torch.int64, device=f.device)
        for _ in range(LEVELS):
            # dist = 1 - dot  =>  argmin dist == argmax dot
            dots = torch.sum(centroids[idx] * f[:, None, :], dim=-1)
            idx = idx * K + first_argmax(dots, dim=1) + 1
        out.append(idx)
    idx = torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                 device=feats.device)
    return torch.where(valid, idx, torch.full_like(idx, -1))


def _score_query(doc_leaves, doc_weights, doc_valid, q_leaves, q_counts,
                 q_valid, leaf_pop, avg_leaves, have_avg, doc_size, featcnt,
                 num_avg):
    """tf-idf L1 scoring of one query against every document and the
    virtual average document (voctree.py:124-201), float32 dense masked
    reductions.  Returns (scores (D,), avg_score, hit (D,), likelihood
    (D,), avg_likelihood)."""
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=doc_weights.device)
    q_safe = torch.clamp_min(q_leaves, 0).long()
    in_avg = torch.any(q_leaves[:, None] == avg_leaves[None, :], dim=1)
    n_docs_leaf = leaf_pop[q_safe] + (in_avg & have_avg).to(leaf_pop.dtype)
    has_docs = q_valid & (n_docs_leaf > 0)

    n_docs_total = doc_size + have_avg.to(torch.int32)
    idf = torch.log10(n_docs_total.to(f32)
                      / torch.clamp_min(n_docs_leaf, 1).to(f32))
    idf = torch.where(has_docs, idf, zero)
    n_idf = (q_counts.to(f32) / featcnt.to(f32)) * idf          # (Q,)

    eq = ((q_leaves[:, None, None] == doc_leaves[None, :, :])
          & has_docs[:, None, None])                              # (Q,D,F)
    m = torch.sum(torch.where(eq, doc_weights[None, :, :], zero), dim=2)
    m = m * idf[:, None]                                          # (Q,D)
    touched = torch.any(eq, dim=2)
    n_b = n_idf[:, None]
    l1 = torch.where(touched, -(torch.abs(n_b - m) - n_b - m), zero)
    scores = torch.sum(l1, dim=0) * doc_valid.to(f32)
    hit = torch.any(touched, dim=0) & doc_valid

    eq_a = (q_leaves[:, None] == avg_leaves[None, :]) & has_docs[:, None]
    m_a = torch.sum(torch.where(eq_a, torch.full((), 1.0 / num_avg,
                                                 dtype=f32,
                                                 device=zero.device), zero),
                    dim=1) * idf
    touched_a = torch.any(eq_a, dim=1)
    l1_a = torch.where(touched_a, -(torch.abs(n_idf - m_a) - n_idf - m_a),
                       zero)
    avg_score = torch.sum(l1_a) * have_avg.to(f32)
    avg_hit = have_avg & torch.any(touched_a)

    # mean fill-in for untouched docs (n_docs_hit starts at 1, :446)
    total = torch.sum(scores) + avg_score
    n_hit = 1 + torch.sum(hit.to(torch.int32)) + avg_hit.to(torch.int32)
    mean_fill = total / n_hit.to(f32)
    scores = torch.where(doc_valid & ~hit, mean_fill, scores)
    avg_score = torch.where(have_avg & ~avg_hit, mean_fill, avg_score)

    # likelihood transform (:517-534) over {avg} + every real doc
    nd = torch.sum(doc_valid.to(f32)) + have_avg.to(f32)
    nd = torch.clamp_min(nd, 1.0)
    s_sum = (torch.sum(torch.where(doc_valid, scores, zero))
             + torch.where(have_avg, avg_score, zero))
    s_sq = (torch.sum(torch.where(doc_valid, scores * scores, zero))
            + torch.where(have_avg, avg_score * avg_score, zero))
    mean = s_sum / nd
    std = torch.sqrt(torch.clamp_min(s_sq / nd - mean * mean, 0.0))

    def lhood(s):
        take = (s > mean + 2.0 * std) & (mean != 0.0)
        return torch.where(take, (s - 2.0 * std) / mean,
                           torch.ones_like(s))

    return scores, avg_score, hit, lhood(scores), lhood(avg_score)


def convolve_same(p, gauss):
    """``jnp.convolve(p, gauss, mode="same")`` for a symmetric odd-length
    kernel no longer than p: out[i] = sum_d p[i + d] gauss[R + d]."""
    R = (gauss.shape[0] - 1) // 2
    n = p.shape[0]
    padded = torch.cat([p.new_zeros(R), p, p.new_zeros(R)])
    out = torch.zeros_like(p)
    for d in range(gauss.shape[0]):
        out = out + padded[d:d + n] * gauss[d]
    return out


def _posterior_update(prev, lhood_docs, lhood_avg, doc_valid, gauss):
    """calc_post_prob (voctree_bf.h:589-706) as one vector update
    (voctree.py:204-229).  prev (D+1,): [state -1, doc 0, doc 1, ...]."""
    f32 = prev.dtype
    dv = doc_valid.to(f32)
    n = torch.clamp_min(torch.sum(dv), 1.0)
    p_no = prev[0]
    p_docs = prev[1:] * dv
    # state -1: 0.9 from -1, 0.1 from any doc (:566-575)
    bel_no = 0.9 * p_no + 0.1 * torch.sum(p_docs)
    # state i: 0.1/n from -1, gauss(|i-j|) from doc j (:577-586)
    bel = p_no * (0.1 / n) + convolve_same(p_docs, gauss)
    post = torch.cat([(lhood_avg * bel_no).reshape(1), lhood_docs * bel])
    mask = torch.cat([torch.ones(1, dtype=f32, device=prev.device), dv])
    post = post * mask
    eta = torch.sum(post)
    uniform = mask / (1.0 + torch.sum(dv))
    return torch.where(eta > 0, post / torch.clamp_min(eta, 1e-300),
                       uniform)


class VocTree:
    def __init__(self, centroids: np.ndarray,
                 params: Optional[VocTreeParams] = None,
                 doc_capacity: int = 128, feat_capacity: int = 256,
                 device="cuda"):
        """centroids: (num_int, K, D) float32; the per-query work runs on
        ``device`` (default the card)."""
        K = BRANCH_FACTOR
        self.num_int = 1 + K + K * K
        self.num_leaf = K ** LEVELS
        if tuple(np.shape(centroids)) != (self.num_int, K, DESC_DIM):
            raise ValueError(f"centroids of shape {np.shape(centroids)}")
        self.device = resolve_device(device)
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32),
                                         device=self.device)
        self.params = params or VocTreeParams()

        # fixed-capacity document table (grows by doubling)
        self._cap_docs = doc_capacity
        self._cap_feat = feat_capacity
        self._doc_leaves = np.full((doc_capacity, feat_capacity), -1,
                                   np.int32)
        self._doc_weights = np.zeros((doc_capacity, feat_capacity),
                                     np.float32)
        self._leaf_pop = np.zeros(self.num_leaf, np.int32)
        self.doc_size = 0
        # quarantine queue of (doc_id, feats)
        self._buffer: List[Tuple[int, np.ndarray]] = []
        self._gauss = gauss_taps(self.params.sigma, self.device)
        # posterior over [no-loop, doc 0, doc 1, ...]; zeros = the
        # reference's empty prior (the first update comes out uniform)
        self._post = None

    # -- persistence (the reference's binary layout, voctree_bf.h:117-143) --

    @staticmethod
    def load(path: str, params: Optional[VocTreeParams] = None,
             device="cuda") -> "VocTree":
        """The raw float32 centroid blocks (num_int, K, D) of ``save``, the
        layout of JAX's ``VocTree.save`` (voctree.py:268-279)."""
        K = BRANCH_FACTOR
        num_int = 1 + K + K * K
        data = np.fromfile(path, dtype=np.float32,
                           count=num_int * K * DESC_DIM)
        if data.size < num_int * K * DESC_DIM:
            raise ValueError(f"truncated vocabulary file: {path}")
        return VocTree(data.reshape(num_int, K, DESC_DIM), params,
                       device=device)

    def save(self, path: str):
        self.centroids.cpu().numpy().astype(np.float32).tofile(path)

    # -- quantization ------------------------------------------------------

    def find_leaves(self, feats: np.ndarray) -> np.ndarray:
        """(F, D) descriptors -> (F,) leaf indices (0-based leaves)."""
        n = len(feats)
        if n == 0:
            return np.zeros(0, np.int32)
        f = torch.as_tensor(np.asarray(feats, np.float32)[:, :DESC_DIM],
                            device=self.device)
        idx = _descend(self.centroids, f,
                       torch.ones(n, dtype=torch.bool, device=self.device))
        return (idx.cpu().numpy() - self.num_int).astype(np.int32)

    # -- document insertion (with quarantine) ------------------------------

    def _grow(self, need_docs):
        while self._cap_docs < need_docs:
            self._cap_docs *= 2
        dl = np.full((self._cap_docs, self._cap_feat), -1, np.int32)
        dw = np.zeros((self._cap_docs, self._cap_feat), np.float32)
        dl[:self.doc_size] = self._doc_leaves[:self.doc_size]
        dw[:self.doc_size] = self._doc_weights[:self.doc_size]
        self._doc_leaves, self._doc_weights = dl, dw
        if self._post is not None:
            p = np.zeros(self._cap_docs + 1, np.float32)
            p[:len(self._post)] = self._post
            self._post = p

    def insert_doc(self, doc_id: Optional[int],
                   feats: np.ndarray) -> Optional[int]:
        """Queue the document; once more than non_consider_recent documents
        are queued, the oldest is inserted (voctree.py:315-355).  Returns
        the doc id that entered the index this call, or None; doc_id=None
        flushes one queued document.  Ids insert in order."""
        if doc_id is not None:
            self._buffer.append((doc_id, np.asarray(feats, np.float32)))

        flush = (len(self._buffer) > self.params.non_consider_recent
                 or (doc_id is None and self._buffer))
        if not flush:
            return None

        ins_id, ins_feats = self._buffer.pop(0)
        if ins_id != self.doc_size:
            raise ValueError(
                f"documents must insert sequentially: got id {ins_id}, "
                f"expected {self.doc_size}")
        if ins_id + 1 > self._cap_docs:
            self._grow(ins_id + 1)
        if len(ins_feats) == 0:
            # featureless keyframe: an empty row keeps the ids dense
            self.doc_size += 1
            return ins_id

        w = 1.0 / len(ins_feats)
        leaves = self.find_leaves(ins_feats)
        uniq, cnt = np.unique(leaves, return_counts=True)
        k = min(len(uniq), self._cap_feat)
        self._doc_leaves[ins_id, :k] = uniq[:k]
        self._doc_weights[ins_id, :k] = cnt[:k] * w
        self._leaf_pop[uniq[:k]] += 1
        self.doc_size += 1
        return ins_id

    # -- querying ----------------------------------------------------------

    def _avg_doc(self):
        """Virtual average document: the top num_avg_words most-populated
        leaves (voctree.py:359-369, numpy)."""
        A = self.params.num_avg_words
        populated = np.flatnonzero(self._leaf_pop > 0)
        if len(populated) <= A:
            return np.full(A, -1, np.int32), False
        top = populated[np.argpartition(-self._leaf_pop[populated], A)[:A]]
        out = np.full(A, -1, np.int32)
        out[:len(top)] = top
        return out, True

    def query(self, feats: np.ndarray):
        """Returns (scores {doc: score}, likelihood {doc: l}); the virtual
        average document is doc -1 (voctree.py:371-413)."""
        if len(feats) == 0 or self.doc_size == 0:
            return {}, {}

        leaves = self.find_leaves(feats)
        uniq, cnt = np.unique(leaves, return_counts=True)
        avg_leaves, have_avg = self._avg_doc()
        doc_valid = np.zeros(self._cap_docs, bool)
        doc_valid[:self.doc_size] = True
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        scores, avg_s, hit, lh, avg_lh = _score_query(
            t(self._doc_leaves), t(self._doc_weights), t(doc_valid),
            t(uniq.astype(np.int32)), t(cnt.astype(np.int32)),
            torch.ones(len(uniq), dtype=torch.bool, device=dev),
            t(self._leaf_pop), t(avg_leaves), t(have_avg),
            t(np.int32(self.doc_size)), t(np.int32(len(feats))),
            self.params.num_avg_words)
        sa, la = scores.cpu().numpy(), lh.cpu().numpy()
        s = {-1: float(avg_s)} if have_avg else {}
        lk = {-1: float(avg_lh)} if have_avg else {}
        for d in range(self.doc_size):
            s[d] = float(sa[d])
            lk[d] = float(la[d])
        return s, lk

    # -- Bayesian temporal filter ------------------------------------------

    def update_posterior(self, likelihood: Dict[int, float]
                         ) -> Dict[int, float]:
        """calc_post_prob (voctree_bf.h:589-706): one vector update on the
        device (voctree.py:417-451)."""
        n = self.doc_size
        if n == 0:
            return {}
        lh = np.ones(self._cap_docs, np.float32)
        for d, v in likelihood.items():
            if 0 <= d < self._cap_docs:
                lh[d] = v
        lh_avg = likelihood.get(-1, 1.0)
        doc_valid = np.zeros(self._cap_docs, bool)
        doc_valid[:n] = True
        if self._post is None or len(self._post) != self._cap_docs + 1:
            p = np.zeros(self._cap_docs + 1, np.float32)
            if self._post is not None:
                p[:len(self._post)] = self._post
            self._post = p
        dev = self.device
        post = _posterior_update(
            torch.as_tensor(self._post, device=dev),
            torch.as_tensor(lh, device=dev),
            torch.tensor(lh_avg, dtype=torch.float32, device=dev),
            torch.as_tensor(doc_valid, device=dev), self._gauss)
        self._post = post.cpu().numpy()
        out = {-1: float(self._post[0])}
        for d in range(n):
            out[d] = float(self._post[1 + d])
        return out

    def is_loop_closing(self, lc_prob: Dict[int, float]) -> Optional[int]:
        """isLoopClosing (voctree_bf.h:708-748; voctree.py:453-473): a run
        of consecutive documents summing >= threshold posterior."""
        p = self.params
        if self.doc_size < p.non_consider_recent:
            return None
        n = self.doc_size
        if self._post is None or n == 0:
            return None
        probs = self._post[1:1 + n].astype(np.float64)
        w = p.consider_seq_length + 1
        if n < w:
            return None
        csum = np.concatenate([[0.0], np.cumsum(probs)])
        window = csum[w:] - csum[:-w]              # sum over [i, i+w)
        best = int(np.argmax(window))
        if window[best] >= p.threshold:
            seg = probs[best:best + w]
            return best + int(np.argmax(seg))
        return None


# ---------------------------------------------------------------------------
# vocabulary training (copy of voctree.py:484-555)
# ---------------------------------------------------------------------------

_MIN_SAMPLES_PER_CLUSTER = 6


def _kmeans(feats: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """Spherical k-means (dist = 1 - dot on normalized vectors); sparse
    nodes cap their cluster count at n // _MIN_SAMPLES_PER_CLUSTER and pad
    the centroid slots with duplicates (voctree.py:487-521 says why)."""
    n = len(feats)
    if n == 0:
        c = rng.standard_normal((k, feats.shape[1] if feats.ndim == 2
                                 else DESC_DIM)).astype(np.float32)
        return c / np.linalg.norm(c, axis=1, keepdims=True)
    k_eff = max(1, min(k, n // _MIN_SAMPLES_PER_CLUSTER))
    centers = feats[rng.choice(n, size=min(k_eff, n),
                               replace=False)].copy()
    for _ in range(iters):
        assign = np.argmax(feats @ centers.T, axis=1)
        for j in range(len(centers)):
            sel = feats[assign == j]
            if len(sel):
                c = sel.mean(axis=0)
                nc = np.linalg.norm(c)
                if nc > 0:
                    centers[j] = c / nc
    if len(centers) < k:
        pad = centers[np.arange(k - len(centers)) % len(centers)]
        centers = np.concatenate([centers, pad])
    return centers


def build_vocabulary(descriptors: np.ndarray, seed: int = 0,
                     kmeans_iters: int = 8) -> np.ndarray:
    """Hierarchical spherical k-means -> (num_int, K, D) centroid table.
    descriptors: (N, 72) normalized training descriptors."""
    K = BRANCH_FACTOR
    rng = np.random.default_rng(seed)
    descriptors = np.asarray(descriptors, np.float32)
    num_int = 1 + K + K * K
    cents = np.zeros((num_int, K, DESC_DIM), np.float32)

    # level 0: root
    cents[0] = _kmeans(descriptors, K, kmeans_iters, rng)
    assign0 = np.argmax(descriptors @ cents[0].T, axis=1)

    # level 1
    for i in range(K):
        node = 0 * K + i + 1
        sel = descriptors[assign0 == i]
        cents[node] = _kmeans(sel, K, kmeans_iters, rng)
    # level 2
    for i in range(K):
        sel_i = descriptors[assign0 == i]
        node_i = i + 1
        assign1 = (np.argmax(sel_i @ cents[node_i].T, axis=1)
                   if len(sel_i) else np.zeros(0, int))
        for j in range(K):
            node = node_i * K + j + 1
            sel = sel_i[assign1 == j] if len(sel_i) else sel_i
            cents[node] = _kmeans(sel, K, kmeans_iters, rng)
    return cents

"""Whole-sequence place recognition on the device (port of
``slslam_tpu/loopclosure/batch.py``).

The replay knows every keyframe's descriptors once it ends, so the whole
recognition timeline runs in one pass: quantization of every descriptor in
one descent, then, per keyframe, the tf-idf scoring against the documents
inserted so far, the quarantine schedule, the Bayesian filter and the
consecutive-sequence acceptance.  Where JAX runs the timeline as one
``lax.scan`` (batch.py:129-262), this port runs a loop over the keyframes
whose state (leaf populations, posterior) stays on the device; the hits
come back to the host once, at the end.  The decisions are the online
path's (``recognizer.PlaceRecognizer``) on the same descriptor stream; the
virtual average document's top-populated leaves follow ``lax.top_k``'s
rule (the lower index first among equal populations).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .recognizer import PlaceRecognizer, _mutual_nn
from ..ops.ransac import first_argmax
from .voctree import (DESC_DIM, VocTree, _bucket, _descend, convolve_same,
                      gauss_taps)


def _quantize_all(tree: VocTree, kf_descs: List[np.ndarray]
                  ) -> List[np.ndarray]:
    """Leaf indices for every keyframe's descriptors, one descent
    (batch.py:44-65)."""
    sizes = [len(d) for d in kf_descs]
    total = sum(sizes)
    if total == 0:
        return [np.zeros(0, np.int32) for _ in kf_descs]
    flat = np.concatenate([np.asarray(d, np.float32)[:, :DESC_DIM]
                           for d in kf_descs if len(d)])
    idx = _descend(tree.centroids,
                   torch.as_tensor(flat, device=tree.device),
                   torch.ones(total, dtype=torch.bool, device=tree.device))
    idx = idx.cpu().numpy() - tree.num_int
    out, off = [], 0
    for n in sizes:
        out.append(idx[off:off + n].astype(np.int32))
        off += n
    return out


def recognize_sequence(tree: VocTree, kf_descs: List[np.ndarray]
                       ) -> np.ndarray:
    """Run the full recognition timeline (batch.py:68-126): (K,) hit doc
    per keyframe, -1 for none, as the online VocTree cycle would give.
    Each keyframe's bag of words is sparse, (K, Q) padded unique compact
    leaf ids and tf weights."""
    p = tree.params
    K = len(kf_descs)
    if K == 0:
        return np.zeros(0, np.int32)

    leaves = _quantize_all(tree, kf_descs)
    all_leaves = (np.concatenate(leaves) if any(len(lv) for lv in leaves)
                  else np.zeros(0, np.int32))
    uni = np.unique(all_leaves)
    U = max(len(uni), 1)
    remap = {int(v): i for i, v in enumerate(uni)}

    rows = []
    featcnt = np.zeros(K, np.int32)
    for k, lv in enumerate(leaves):
        featcnt[k] = len(lv)
        if len(lv) == 0:
            rows.append((np.zeros(0, np.int64), np.zeros(0, np.float32)))
            continue
        u, c = np.unique(lv, return_counts=True)
        cols = np.array([remap[int(x)] for x in u], np.int64)
        rows.append((cols, (c / float(len(lv))).astype(np.float32)))
    Q = _bucket(max((len(r[0]) for r in rows), default=1) or 1,
                buckets=(8, 16, 32, 64, 128, 256, 512, 1024))
    bw_id = np.full((K, Q), -1, np.int32)    # compact leaf id, -1 = pad
    bw_w = np.zeros((K, Q), np.float32)      # tf weight (count / featcnt)
    for k, (cols, w) in enumerate(rows):
        bw_id[k, :len(cols)] = cols
        bw_w[k, :len(cols)] = w

    dev = tree.device
    hits = _recognition_scan(
        torch.as_tensor(bw_id, device=dev), torch.as_tensor(bw_w, device=dev),
        torch.as_tensor(featcnt, device=dev), gauss_taps(p.sigma, dev), U=U,
        ncr=p.non_consider_recent, A=p.num_avg_words,
        w_len=p.consider_seq_length + 1, threshold=float(p.threshold))
    return hits.cpu().numpy().astype(np.int32)


def _recognition_scan(IdJ, WJ, fcJ, gauss, U, ncr, A, w_len, threshold):
    """The timeline (batch.py:129-262), one step per keyframe on the
    device; returns (K,) int hits."""
    K = IdJ.shape[0]
    dev = IdJ.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    karr = torch.arange(K, device=dev)
    pop = torch.zeros(U, dtype=f32, device=dev)
    post = torch.zeros(K + 1, dtype=f32, device=dev)   # the empty prior
    A_eff = min(A, U)
    n_win = K - w_len + 1
    widx = torch.arange(max(n_win, 0), device=dev)
    hits = []
    for k in range(K):
        doc_size = max(k - ncr, 0)
        qid = IdJ[k]                          # (Q,) compact ids, -1 pad
        nq = WJ[k]
        q_has = qid >= 0
        qs = torch.clamp_min(qid, 0).long()

        # --- virtual average document over the top-A populated leaves ---
        n_pop = torch.sum((pop > 0).to(torch.int32))
        have_avg = n_pop > A
        order = torch.sort(pop, descending=True, stable=True)
        topv, topi = order.values[:A_eff], order.indices[:A_eff]
        in_avg_u = torch.zeros(U, dtype=torch.bool, device=dev)
        in_avg_u[topi] = topv > 0
        in_avg = in_avg_u[qs] & q_has & have_avg

        # --- idf over the query's leaves (the avg doc counts as a member)
        pop_q = torch.where(q_has, pop[qs], zero)
        n_docs_leaf = pop_q + in_avg.to(f32)
        has_docs = q_has & (n_docs_leaf > 0)
        n_total = (doc_size + have_avg.to(torch.int32)).to(f32)
        idf = torch.log10(n_total / torch.clamp_min(n_docs_leaf, 1.0))
        idf = torch.where(has_docs, idf, zero)
        n_idf = nq * idf

        # --- every inserted document: 2 idf min(n, w) per shared leaf ---
        doc_valid = karr < doc_size
        eq = (IdJ[:, :, None] == qid[None, None, :]) & (qid >= 0)
        touched_pair = eq & has_docs[None, None, :]
        contrib = 2.0 * idf[None, None, :] * torch.minimum(
            nq[None, None, :], WJ[:, :, None])
        scores = torch.sum(torch.where(touched_pair, contrib, zero),
                           dim=(1, 2))
        scores = scores * doc_valid.to(f32)
        hit = torch.any(touched_pair, dim=(1, 2)) & doc_valid

        # --- the average document's own score ---
        m_a = (1.0 / A) * idf
        touched_a = has_docs & in_avg
        l1_a = torch.where(touched_a,
                           -(torch.abs(n_idf - m_a) - n_idf - m_a), zero)
        avg_score = torch.sum(l1_a) * have_avg.to(f32)
        avg_hit = have_avg & torch.any(touched_a)

        # --- mean fill-in for untouched docs ---
        total = torch.sum(scores) + avg_score
        n_hit = (1 + torch.sum(hit.to(torch.int32))
                 + avg_hit.to(torch.int32)).to(f32)
        mean_fill = total / n_hit
        scores = torch.where(doc_valid & ~hit, mean_fill, scores)
        avg_score = torch.where(have_avg & ~avg_hit, mean_fill, avg_score)

        # --- likelihood transform ---
        nd = torch.clamp_min(doc_size + have_avg.to(f32), 1.0)
        s_sum = (torch.sum(torch.where(doc_valid, scores, zero))
                 + torch.where(have_avg, avg_score, zero))
        s_sq = (torch.sum(torch.where(doc_valid, scores * scores, zero))
                + torch.where(have_avg, avg_score * avg_score, zero))
        mean = s_sum / nd
        std = torch.sqrt(torch.clamp_min(s_sq / nd - mean * mean, 0.0))

        def lhood(x):
            take = (x > mean + 2.0 * std) & (mean != 0.0)
            return torch.where(take, (x - 2.0 * std) / mean,
                               torch.ones_like(x))

        lh = torch.where(doc_valid, lhood(scores), torch.ones_like(scores))
        lh_avg = lhood(avg_score)

        # --- posterior recursion (voctree._posterior_update) ---
        dv = doc_valid.to(f32)
        nf = torch.tensor(float(max(doc_size, 1)), dtype=f32, device=dev)
        p_no = post[0]
        p_docs = post[1:] * dv
        bel_no = 0.9 * p_no + 0.1 * torch.sum(p_docs)
        bel = p_no * (0.1 / nf) + convolve_same(p_docs, gauss)
        new_post = torch.cat([(lh_avg * bel_no).reshape(1), lh * bel])
        mask = torch.cat([torch.ones(1, dtype=f32, device=dev), dv])
        new_post = new_post * mask
        eta = torch.sum(new_post)
        uniform = mask / (1.0 + doc_size)
        new_post = torch.where(eta > 0,
                               new_post / torch.clamp_min(eta, 1e-30),
                               uniform)

        # skip the whole update when the online path would not query
        do = (doc_size > 0) & (fcJ[k] > 0)
        post = torch.where(do, new_post, post)

        # --- acceptance (voctree.is_loop_closing) ---
        ok = do & (doc_size >= ncr) & (doc_size >= w_len)
        if n_win > 0:
            probs = post[1:]
            csum = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                              torch.cumsum(probs, 0)])
            window = csum[w_len:] - csum[:-w_len]
            window = torch.where(widx + w_len <= doc_size, window,
                                 torch.full_like(window, -float("inf")))
            best = first_argmax(window)
            seg = probs[best + torch.arange(w_len, device=dev)]
            cand = best + first_argmax(seg)
            ok = ok & (torch.amax(window) >= threshold)
            hits.append(torch.where(ok, cand, torch.full_like(cand, -1)))
        else:
            hits.append(torch.full((), -1, dtype=torch.int64, device=dev))

        # --- end-of-step insertion of doc (k - ncr) ---
        ins = k - ncr
        if ins >= 0:
            iid = IdJ[ins]
            inc = ((iid >= 0) & (fcJ[ins] > 0)).to(f32)
            pop = pop.index_put((torch.clamp_min(iid, 0).long(),), inc,
                                accumulate=True)
    return torch.stack(hits)


class BatchPlaceRecognizer:
    """Drop-in for PlaceRecognizer on the replay path (batch.py:273-341):
    the recognition timeline in one pass, and every hit's mutual-NN
    descriptor match in one batched call."""

    def __init__(self, tree: VocTree, min_matches: int = 8,
                 min_similarity: float = 0.8):
        self._online = PlaceRecognizer(tree, min_matches, min_similarity)
        self.tree = tree
        self.stats = self._online.stats

    def recognize_all(self, kf_ids: List[int],
                      feat_ids_list: List[List[int]],
                      descs: List[np.ndarray]
                      ) -> List[Optional[Tuple[int, dict]]]:
        hits = recognize_sequence(self.tree, descs)
        self._online.docs = [(kf, list(f), np.asarray(d, np.float32))
                             for kf, f, d in zip(kf_ids, feat_ids_list,
                                                 descs)]
        out: List[Optional[Tuple[int, dict]]] = [None] * len(kf_ids)
        pairs = [(k, int(h)) for k, h in enumerate(hits)
                 if 0 <= int(h) < len(kf_ids)
                 and len(descs[k]) and len(descs[int(h)])]
        for k, h in enumerate(hits):
            # empty-descriptor hits keep the online path's stats exactly
            if 0 <= int(h) < len(kf_ids) and (k, int(h)) not in pairs:
                self.stats["queries"] += 1
                self.stats["filter_hits"] += 1
                self.stats["match_fails"] += 1
        if not pairs:
            return out

        H = len(pairs)
        A = _bucket(max(len(descs[k]) for k, _ in pairs),
                    buckets=(32, 64, 128, 256, 512, 1024))
        B = _bucket(max(len(descs[h]) for _, h in pairs),
                    buckets=(32, 64, 128, 256, 512, 1024))
        da = np.zeros((H, A, DESC_DIM), np.float32)
        db = np.zeros((H, B, DESC_DIM), np.float32)
        for i, (k, h) in enumerate(pairs):
            da[i, :len(descs[k])] = np.asarray(descs[k],
                                               np.float32)[:, :DESC_DIM]
            db[i, :len(descs[h])] = np.asarray(descs[h],
                                               np.float32)[:, :DESC_DIM]
        dev = self.tree.device
        dots, a2b, b2a = (x.cpu().numpy() for x in _mutual_nn(
            torch.as_tensor(da, device=dev), torch.as_tensor(db, device=dev)))

        min_sim = self._online.min_similarity
        for i, (k, h) in enumerate(pairs):
            self.stats["queries"] += 1
            self.stats["filter_hits"] += 1
            old_kf, old_ids, _ = self._online.docs[h]
            fi = feat_ids_list[k]
            match_result = {}
            for a in range(len(descs[k])):
                b = int(a2b[i, a])
                if b < len(old_ids) and int(b2a[i, b]) == a \
                        and dots[i, a, b] >= min_sim:
                    match_result[fi[a]] = old_ids[b]
            if len(match_result) < self._online.min_matches:
                self.stats["match_fails"] += 1
            else:
                self.stats["detections"] += 1
                out[k] = (old_kf, match_result)
        return out

"""Place recognition over the vocabulary tree (port of
``slslam_tpu/loopclosure/recognizer.py``; the reference's stubbed
SLAM::place_recognized, slam.cpp:1088-1104, as its commented body
intends).  Per keyframe: query the tree, run the Bayesian filter and the
consecutive-sequence acceptance, and on acceptance match the current
descriptors against the recognized keyframe's by mutual nearest neighbour
on the tree's device; each keyframe enters the index after the quarantine
window.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.ransac import first_argmax
from .voctree import VocTree


def _mutual_nn(desc_a, desc_b):
    """Mutual nearest-neighbour scores (recognizer.py:31-37): (A, D) x
    (B, D) -> dots (A, B), best b per a, best a per b, first index on
    ties.  Zero (padded) rows dot to 0, below any similarity gate.  The
    dots are elementwise products and sums (no reduced-precision matmul
    path); batched over a leading dimension if there is one."""
    dots = torch.sum(desc_a[..., :, None, :] * desc_b[..., None, :, :],
                     dim=-1)
    return dots, first_argmax(dots, dim=-1), first_argmax(dots, dim=-2)


def _pad_bucket(a, buckets=(32, 64, 128, 256, 512, 1024)):
    """Rows padded with zeros to a capacity bucket (recognizer.py:40-47):
    the padded rows take part in the argmaxes, as in the JAX package."""
    n = len(a)
    for b in buckets:
        if n <= b:
            break
    out = np.zeros((b, a.shape[1]), a.dtype)
    out[:n] = a
    return out


class PlaceRecognizer:
    def __init__(self, tree: VocTree, min_matches: int = 8,
                 min_similarity: float = 0.8):
        self.tree = tree
        self.min_matches = min_matches
        self.min_similarity = min_similarity
        # doc index -> (kf_id, feature ids, descriptors)
        self.docs: List[Tuple[int, List[int], np.ndarray]] = []
        self._doc_of_kf: Dict[int, int] = {}
        self.stats = {"queries": 0, "filter_hits": 0, "match_fails": 0,
                      "detections": 0}

    def query_and_insert(self, kf_id: int, feat_ids: List[int],
                         descriptors: np.ndarray
                         ) -> Optional[Tuple[int, Dict[int, int]]]:
        """Process one keyframe (recognizer.py:63-88): (lc_kf_id,
        match_result) on a detection, else None."""
        descriptors = np.asarray(descriptors, np.float32)

        hit = None
        if self.tree.doc_size > 0 and len(descriptors):
            self.stats["queries"] += 1
            _, likelihood = self.tree.query(descriptors)
            lc_prob = self.tree.update_posterior(likelihood)
            doc = self.tree.is_loop_closing(lc_prob)
            if doc is not None and 0 <= doc < len(self.docs):
                self.stats["filter_hits"] += 1
                hit = self._match(doc, feat_ids, descriptors)
                if hit is None:
                    self.stats["match_fails"] += 1
                else:
                    self.stats["detections"] += 1

        doc_idx = len(self.docs)
        self.docs.append((kf_id, list(feat_ids), descriptors))
        self._doc_of_kf[kf_id] = doc_idx
        self.tree.insert_doc(doc_idx, descriptors)
        return hit

    def _match(self, doc: int, feat_ids: List[int], descriptors: np.ndarray
               ) -> Optional[Tuple[int, Dict[int, int]]]:
        old_kf, old_ids, old_desc = self.docs[doc]
        if len(old_desc) == 0 or len(descriptors) == 0:
            return None
        dev = self.tree.device
        dots, a2b, b2a = _mutual_nn(
            torch.as_tensor(_pad_bucket(descriptors), device=dev),
            torch.as_tensor(_pad_bucket(old_desc), device=dev))
        dots, a2b, b2a = (x.cpu().numpy() for x in (dots, a2b, b2a))

        match_result: Dict[int, int] = {}
        for a in range(len(descriptors)):
            b = a2b[a]
            if b < len(old_ids) and b2a[b] == a \
                    and dots[a, b] >= self.min_similarity:
                match_result[feat_ids[a]] = old_ids[b]
        if len(match_result) < self.min_matches:
            return None
        return old_kf, match_result

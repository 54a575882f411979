"""The port's place recognition (slslam_tpu_torch/loopclosure) vs JAX's.

On the CPU, on the sequences of tests/test_loopclosure.py and
tests/test_batch_recognizer.py.  Both packages compute in float32, so the
scores, likelihoods and posteriors agree to float32 rounding (rtol 1e-5);
every decision agrees exactly: the leaves of the tree descent, the
quarantine's inserted ids, the recognizers' hits and their descriptor
matches, and the batch timeline against both online paths."""

import numpy as np
import pytest
import torch

from slslam_tpu.loopclosure import PlaceRecognizer as JRec
from slslam_tpu.loopclosure import VocTree as JTree
from slslam_tpu.loopclosure import build_vocabulary
from slslam_tpu.loopclosure.batch import BatchPlaceRecognizer as JBatchRec
from slslam_tpu.loopclosure.batch import recognize_sequence as j_sequence
from slslam_tpu.loopclosure.voctree import VocTreeParams as JParams
from slslam_tpu_torch.loopclosure import (BatchPlaceRecognizer,
                                          PlaceRecognizer, VocTree,
                                          VocTreeParams)
from slslam_tpu_torch.loopclosure import recognizer as trec
from slslam_tpu_torch.loopclosure.batch import recognize_sequence
from slslam_tpu_torch.ops.ransac import first_argmax

from test_batch_recognizer import _make_stream, _online_hits
from test_loopclosure import synth_descriptors

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def vocab():
    rng = np.random.default_rng(0)
    return build_vocabulary(synth_descriptors(rng, 1500), seed=0,
                            kmeans_iters=2)


@pytest.fixture(scope="module")
def stream():
    return _make_stream()


def _trees(vocab, **kw):
    return (JTree(vocab, JParams(**kw)),
            VocTree(vocab, VocTreeParams(**kw), device="cpu"))


def test_first_argmax_takes_the_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert first_argmax(x, dim=1).tolist() == [1, 0]
    assert first_argmax(x, dim=0).tolist() == [1, 0, 0, 1]


def test_descent_matches_jax(vocab):
    """Leaves of random descriptors, of the centroids themselves, and of
    an all-zero descriptor (every dot ties: the first child wins)."""
    j, t = _trees(vocab)
    rng = np.random.default_rng(1)
    feats = np.concatenate([synth_descriptors(rng, 200), vocab[0, :5],
                            vocab[7, :3], np.zeros((1, 72), np.float32)])
    np.testing.assert_array_equal(t.find_leaves(feats),
                                  j.find_leaves(feats))
    assert t.find_leaves(feats)[-1] == 0


def test_quarantine_and_documents_match_jax(vocab):
    j, t = _trees(vocab, non_consider_recent=5)
    rng = np.random.default_rng(2)
    for i in range(12):
        d = synth_descriptors(rng, 30)
        assert t.insert_doc(i, d) == j.insert_doc(i, d)
    assert t.insert_doc(None, None) == j.insert_doc(None, None)
    assert t.doc_size == j.doc_size == 8
    np.testing.assert_array_equal(t._doc_leaves, j._doc_leaves)
    np.testing.assert_array_equal(t._doc_weights, j._doc_weights)
    np.testing.assert_array_equal(t._leaf_pop, j._leaf_pop)


def test_query_ranking_and_posterior_match_jax(vocab):
    """Scores, likelihoods and the posterior over 30 queries against a
    growing index (the average document switches on part-way), and the
    acceptance decision of every step."""
    kw = dict(non_consider_recent=3, consider_seq_length=3, threshold=0.3,
              num_avg_words=10)
    j, t = _trees(vocab, **kw)
    rng = np.random.default_rng(5)
    world = synth_descriptors(rng, 400)
    for k in range(30):
        ids = (np.arange(30) + 7 * (k % 12)) % 400
        d = world[ids] + rng.standard_normal((30, 72)) * 0.01
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        if j.doc_size:
            sj, lj = j.query(d)
            st, lt = t.query(d)
            assert sorted(st) == sorted(sj)
            np.testing.assert_allclose([st[x] for x in sj],
                                       [sj[x] for x in sj], **F32)
            np.testing.assert_allclose([lt[x] for x in lj],
                                       [lj[x] for x in lj], **F32)
            # the query ranks itself-like documents the same way
            assert max(st, key=st.get) == max(sj, key=sj.get)
            pj, pt = j.update_posterior(lj), t.update_posterior(lj)
            np.testing.assert_allclose([pt[x] for x in pj],
                                       [pj[x] for x in pj], **F32)
            assert t.is_loop_closing(pt) == j.is_loop_closing(pj)
        assert t.insert_doc(k, d) == j.insert_doc(k, d)


def _revisit_frames():
    """tests/test_loopclosure.py's revisit: 20 places, then places 0-9."""
    rng = np.random.default_rng(5)
    world = synth_descriptors(rng, 800)
    out = []
    for kf, place in [(k, k) for k in range(20)] + [(100 + k, k)
                                                    for k in range(10)]:
        ids = [place * 40 + k for k in range(40)]
        d = world[ids] + rng.standard_normal((40, 72)) * 0.01
        out.append((kf, ids, (d / np.linalg.norm(d, axis=1, keepdims=True)
                              ).astype(np.float32)))
    return out


def test_place_recognizer_hits_match_jax(vocab):
    kw = dict(non_consider_recent=3, consider_seq_length=3, threshold=0.5,
              num_avg_words=10)
    j, t = _trees(vocab, **kw)
    rj = JRec(j, min_matches=8, min_similarity=0.8)
    rt = PlaceRecognizer(t, min_matches=8, min_similarity=0.8)
    hits = 0
    for kf, ids, d in _revisit_frames():
        a, b = rj.query_and_insert(kf, ids, d), rt.query_and_insert(kf, ids,
                                                                    d)
        assert b == a
        hits += a is not None
    assert hits > 0
    assert rt.stats == rj.stats


def test_mutual_nn_padding_and_ties():
    """Zero (padded) rows take part in the argmaxes, and ties go to the
    first index, as jnp.argmax."""
    a = np.zeros((32, 72), np.float32)
    a[0, 0] = a[1, 0] = 1.0          # two identical rows: a tie for b 0
    a[2, 1] = -1.0                   # all its dots <= 0: a padded b wins
    b = np.zeros((32, 72), np.float32)
    b[0, 0] = 1.0
    b[1, 1] = 1.0
    dots, a2b, b2a = trec._mutual_nn(torch.as_tensor(a), torch.as_tensor(b))
    assert int(b2a[0]) == 0 and int(a2b[1]) == 0
    assert int(a2b[2]) == 0          # dot 0 with b 0 and with every pad
    assert int(b2a[1]) == 0          # a 2's -1 loses to the zero rows


@pytest.mark.parametrize("ncr,seqlen", [(10, 4), (6, 3)])
def test_batch_sequence_matches_jax_and_online(stream, ncr, seqlen):
    descs, vocab = stream
    kw = dict(non_consider_recent=ncr, sigma=1.0, threshold=0.25,
              consider_seq_length=seqlen, num_avg_words=20)
    j = j_sequence(JTree(vocab, JParams(**kw)), descs)
    t = recognize_sequence(VocTree(vocab, VocTreeParams(**kw),
                                   device="cpu"), descs)
    online = _online_hits(VocTree(vocab, VocTreeParams(**kw), device="cpu"),
                          descs)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, online)
    assert np.any(t >= 0)


def test_batch_sequence_with_empty_frames_matches_jax():
    descs, vocab = _make_stream(K=30, revisit_at=20)
    descs[5] = np.zeros((0, 72), np.float32)
    descs[21] = np.zeros((0, 72), np.float32)
    kw = dict(non_consider_recent=6, threshold=0.25, consider_seq_length=3,
              num_avg_words=20)
    j = j_sequence(JTree(vocab, JParams(**kw)), descs)
    t = recognize_sequence(VocTree(vocab, VocTreeParams(**kw),
                                   device="cpu"), descs)
    np.testing.assert_array_equal(t, j)


def test_batch_recognizer_matches_jax(stream):
    """BatchPlaceRecognizer.recognize_all: the same (old_kf, matches) per
    keyframe and the same stats as JAX's."""
    descs, vocab = stream
    kw = dict(non_consider_recent=10, threshold=0.25,
              consider_seq_length=4, num_avg_words=20)
    kf_ids = list(range(len(descs)))
    fids = [[(k, i) for i in range(len(d))] for k, d in enumerate(descs)]
    rj = JBatchRec(JTree(vocab, JParams(**kw)), min_matches=8,
                   min_similarity=0.8)
    rt = BatchPlaceRecognizer(VocTree(vocab, VocTreeParams(**kw),
                                      device="cpu"), min_matches=8,
                              min_similarity=0.8)
    a = rj.recognize_all(kf_ids, fids, descs)
    b = rt.recognize_all(kf_ids, fids, descs)
    assert b == a
    assert any(h is not None for h in b)
    assert rt.stats == rj.stats


def test_cuda_without_a_card_raises(vocab):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        VocTree(vocab)

"""The port's embeddings (``transmogrifai_tpu_torch/ops/embeddings.py``) and
``utils.prng.gamma`` against the JAX package's, on the CPU: the same
numpy-seeded corpora through both.

Tolerances, each measured first on these cases (jax 0.9.0, torch 2.13 CPU,
one thread) and stated:

* ``prng.gamma`` EQUAL ``jax.random.gamma`` as a jitted program with a
  constant ``a`` computes it (the LDA start's form), at α = 100 (LDA's), two
  α < 1 (the boost through ``powf``, and α = 0.5 whose exponent 2 XLA
  rewrites to a square) and a generic α; the LDA and SGNS starts EQUAL the
  reference's jitted programs;
* ``SGNS_RTOL`` = 2e-6 on the input vectors after 1-100 SGD steps,
  relative to the largest |w| (measured: 0 after one step, 3.7e-8 after
  10, 1.9e-7 after 50, 2.2e-7 after 100: the reference's autodiff
  log-sigmoid and scatter against the closed-form gradient and
  ``index_add_``); ``SGNS_LONG_RTOL`` = 1e-4 after 1500 steps (measured
  1.1e-6), where the neighbor precision@10 is held at the reference's
  floor (>= 0.8; both measure 1.0); ``SGNS_CLIP_RTOL`` = 1e-4 after 5
  steps where the norm clip engages (measured 3.6e-6 after two steps,
  1.0e-5 after five: at lr 8 the clipped steps amplify the last-ulp
  differences, 4.3e-5 after 10 and 3.5e-3 after 30);
* ``LDA_RTOL`` = 2e-5 on ``topic_word`` relative to its largest entry and
  ``LDA_THETA_ATOL`` = 2e-5 on theta (measured 3.8e-6 and 3.2e-6 after two
  EM iterations, 1.5e-7 and 1.8e-7 after twenty: XLA's digamma against
  ``torch.digamma``), every document's argmax topic EQUAL; the transform
  the same.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.ops import embeddings as JE
from transmogrifai_tpu_torch.ops import embeddings as PE
from transmogrifai_tpu_torch.utils import prng

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import baseline_cpu as BC  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "port_pairs", os.path.join(HERE, "torch_fixtures", "port_pairs.py"))
PP = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PP)

SGNS_RTOL = 2e-6
SGNS_CLIP_RTOL = 1e-4
SGNS_LONG_RTOL = 1e-4
LDA_RTOL = 2e-5
LDA_THETA_ATOL = 2e-5

ON_CARD = torch.cuda.is_available()


@pytest.fixture(scope="module", autouse=True)
def _compile_cache(tmp_path_factory):
    """The JAX package's AOT bank writes into a temporary directory."""
    old = os.environ.get("TPTPU_COMPILE_CACHE")
    os.environ["TPTPU_COMPILE_CACHE"] = str(tmp_path_factory.mktemp("aot"))
    yield
    if old is None:
        os.environ.pop("TPTPU_COMPILE_CACHE", None)
    else:
        os.environ["TPTPU_COMPILE_CACHE"] = old


def corpus(n_docs=200, n_topics=4, words_per_topic=30, doc_len=20):
    vocab, ids, topics = BC.make_topic_corpus(
        n_docs=n_docs, n_topics=n_topics, words_per_topic=words_per_topic,
        doc_len=doc_len)
    counts = np.zeros((len(ids), len(vocab)))
    for d, row in enumerate(ids):
        np.add.at(counts[d], row, 1.0)
    return vocab, ids, topics, counts


def rel_err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(a)).max())


# -------------------------------------------------------------- the draws
@pytest.mark.parametrize("a,seed,shape", [
    (100.0, 42, (10, 2000)), (100.0, 0, (3, 700)), (100.0, 7, ()),
    (0.3, 42, (5000,)), (0.5, 3, (4, 500)), (2.5, 11, (3000,)),
])
def test_gamma_equals_jax(a, seed, shape):
    want = np.asarray(jax.jit(lambda k: jax.random.gamma(k, a, shape))(
        jax.random.PRNGKey(seed)))
    got = prng.gamma(prng.prng_key(seed), a, shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,v,seed", [(10, 2000, 42), (4, 50, 0), (3, 13, 7)])
def test_lda_start_equals_the_reference(k, v, seed):
    """The reference's jitted EM at zero iterations returns its start."""
    lam, _ = JE._make_lda_scan()(
        jnp.ones((2, v), jnp.float32), jnp.float32(0.1), jnp.float32(0.1),
        jnp.int32(seed), k=k, iters=0, e_iters=1)
    np.testing.assert_array_equal(PE.lda_start(k, v, seed), np.asarray(lam))


@pytest.mark.parametrize("v,d,seed", [(2000, 100, 42), (37, 16, 3)])
def test_sgns_start_equals_the_reference(v, d, seed):
    """The reference's jitted SGD at zero steps returns its start."""
    z = jnp.zeros((0, 4), jnp.int32)
    w = JE._make_sgns_scan()(z, z, jnp.zeros((0, 4, 5), jnp.int32),
                             jnp.zeros((0,), jnp.float32), jnp.int32(seed),
                             vocab_size=v, dim=d)
    np.testing.assert_array_equal(PE.sgns_start(v, d, seed), np.asarray(w))


# ------------------------------------------------------------------- SGNS
@pytest.mark.parametrize("steps", [1, 10, 50, 100])
def test_sgns_agrees_with_the_reference(steps):
    vocab, ids, _, _ = corpus()
    pairs = BC._w2v_pairs(ids, window=5)
    want = JE._sgns_train(pairs, vocab_size=len(vocab), dim=16, steps=steps,
                          seed=42)
    got = PE.sgns_train(pairs, vocab_size=len(vocab), dim=16, steps=steps,
                        seed=42, device="cpu")
    assert rel_err(want, got) <= SGNS_RTOL


def test_sgns_clips_like_the_reference():
    """A few distinct pairs resampled into the batch pile duplicate
    gradients onto each row: the global-norm clip engages."""
    pairs = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
    want = JE._sgns_train(pairs, vocab_size=4, dim=8, steps=5, seed=5)
    got = PE.sgns_train(pairs, vocab_size=4, dim=8, steps=5, seed=5,
                        device="cpu")
    assert np.isfinite(got).all()
    assert rel_err(want, got) <= SGNS_CLIP_RTOL


def test_sgns_full_length_recovers_topics_like_the_reference():
    vocab, ids, _, _ = corpus(n_docs=600, n_topics=5, words_per_topic=60,
                              doc_len=30)
    pairs = BC._w2v_pairs(ids, window=5)
    want = JE._sgns_train(pairs, vocab_size=len(vocab), dim=64, steps=1500,
                          seed=42)
    got = PE.sgns_train(pairs, vocab_size=len(vocab), dim=64, steps=1500,
                        seed=42, device="cpu")
    assert rel_err(want, got) <= SGNS_LONG_RTOL
    p_port = BC.w2v_neighbor_precision(vocab, got, 60)
    p_ref = BC.w2v_neighbor_precision(vocab, want, 60)
    assert p_port >= 0.8 and abs(p_port - p_ref) <= 0.02, (p_port, p_ref)


# -------------------------------------------------------------------- LDA
@pytest.mark.parametrize("k,iters,seed", [(4, 2, 0), (4, 20, 0), (3, 5, 9)])
def test_lda_agrees_with_the_reference(k, iters, seed):
    _, _, _, counts = corpus()
    lam_j, theta_j = JE._lda_fit(counts, k, iters=iters, seed=seed)
    lam_p, theta_p = PE.lda_fit(counts, k, iters=iters, seed=seed,
                                device="cpu")
    assert rel_err(lam_j, lam_p) <= LDA_RTOL
    np.testing.assert_allclose(theta_p, theta_j, rtol=0, atol=LDA_THETA_ATOL)
    np.testing.assert_array_equal(theta_p.argmax(1), np.asarray(theta_j).argmax(1))


def test_lda_recovers_topics_like_the_reference():
    _, _, topics, counts = corpus(n_docs=600, n_topics=5, words_per_topic=60,
                                  doc_len=30)
    lam_p, theta_p = PE.lda_fit(counts, 5, iters=20, seed=0, device="cpu")
    lam_j, theta_j = JE._lda_fit(counts, 5, iters=20, seed=0)
    purity, acc = BC.lda_quality(lam_p, theta_p, topics, 60)
    assert purity >= 0.7 and acc >= 0.7
    assert (purity, acc) == BC.lda_quality(lam_j, theta_j, topics, 60)


# ------------------------------------------------------- through the stages
def _stage_run(pkg, make, type_name, col_of):
    if pkg == "jax":
        import transmogrifai_tpu.types as T
        from transmogrifai_tpu.ops import embeddings as E
        from transmogrifai_tpu.types.columns import ListColumn, VectorColumn
        from transmogrifai_tpu.stages.metadata import VectorMetadata
    else:
        import transmogrifai_tpu_torch.types as T
        from transmogrifai_tpu_torch.ops import embeddings as E
        from transmogrifai_tpu_torch.types.columns import ListColumn, VectorColumn
        from transmogrifai_tpu_torch.stages.metadata import VectorMetadata
    col = col_of(T, ListColumn, VectorColumn, VectorMetadata)
    out, model = PP.run_typed(pkg, make(E), [type_name], [col])
    return out, model, col


def _docs(T, ListColumn, *_):
    vocab, ids, _, _ = corpus()
    docs = np.empty(len(ids), dtype=object)
    for d, row in enumerate(ids):
        docs[d] = [vocab[i] for i in row]
    docs[3] = []
    return ListColumn(T.TextList, docs)


def _counts(T, _L, VectorColumn, VectorMetadata):
    return VectorColumn(T.OPVector, corpus()[3].astype(np.float32),
                        VectorMetadata("f0", ()))


def test_word2vec_stage_agrees_and_crosses_over():
    outs = {pkg: _stage_run(pkg, lambda E: E.OpWord2Vec(
        vector_size=16, min_count=2, steps=60, **(
            {} if pkg == "jax" else {"device": "cpu"})), "TextList", _docs)
        for pkg in ("jax", "port")}
    (jo, jm, jc), (po, pm, pc) = outs["jax"], outs["port"]
    assert jm.vocab == pm.vocab and jm.metadata == pm.metadata
    assert rel_err(jm.vectors, pm.vectors) <= SGNS_RTOL
    np.testing.assert_allclose(po.values, jo.values, rtol=0,
                               atol=SGNS_RTOL * np.abs(jm.vectors).max())
    assert PP.metas(jo) == PP.metas(po)
    # the JAX-fitted model, loaded by the port, transforms EQUAL (host
    # segment mean over the same vectors)
    entry, arrays = PP.saved_entry("jax", jm)
    from transmogrifai_tpu_torch.features import FeatureBuilder
    loaded = PP.load_entry("port", entry, arrays,
                           [FeatureBuilder.TextList("f0").as_predictor()])
    PP.same_columns(loaded.transform_columns(pc, num_rows=len(pc)), jo)


def test_lda_stage_agrees_and_crosses_over():
    outs = {pkg: _stage_run(pkg, lambda E: E.OpLDA(k=4, max_iter=5, **(
        {} if pkg == "jax" else {"device": "cpu"})), "OPVector", _counts)
        for pkg in ("jax", "port")}
    (jo, jm, jc), (po, pm, pc) = outs["jax"], outs["port"]
    assert jm.metadata == pm.metadata
    assert rel_err(jm.topic_word, pm.topic_word) <= LDA_RTOL
    np.testing.assert_allclose(po.values, jo.values, rtol=0, atol=LDA_THETA_ATOL)
    np.testing.assert_array_equal(po.values.argmax(1), jo.values.argmax(1))
    assert PP.metas(jo) == PP.metas(po)
    # each package's fitted model loads in the other: the port runs the
    # JAX package's topic_word within the stated tolerance, and the JAX
    # package the port's
    from transmogrifai_tpu.features import FeatureBuilder as JFB
    from transmogrifai_tpu_torch.features import FeatureBuilder as PFB
    entry, arrays = PP.saved_entry("jax", jm)
    loaded = PP.load_entry("port", entry, arrays,
                           [PFB.OPVector("f0").as_predictor()]).to("cpu")
    np.testing.assert_array_equal(loaded.topic_word, jm.topic_word)
    got = loaded.transform_columns(pc, num_rows=len(pc)).values
    np.testing.assert_allclose(got, jo.values, rtol=0, atol=LDA_THETA_ATOL)
    np.testing.assert_array_equal(got.argmax(1), jo.values.argmax(1))
    entry, arrays = PP.saved_entry("port", pm)
    loaded = PP.load_entry("jax", entry, arrays,
                           [JFB.OPVector("f0").as_predictor()])
    np.testing.assert_array_equal(loaded.topic_word, pm.topic_word)
    np.testing.assert_allclose(
        loaded.transform_columns(jc, num_rows=len(jc)).values, po.values,
        rtol=0, atol=LDA_THETA_ATOL)


# ----------------------------------------------------------------- the card
def test_sgns_two_fits_bit_equal_on_the_card():
    if not ON_CARD:
        pytest.skip("no CUDA device")
    vocab, ids, _, _ = corpus()
    pairs = BC._w2v_pairs(ids, window=5)
    a = PE.sgns_train(pairs, vocab_size=len(vocab), dim=16, steps=50, seed=42)
    b = PE.sgns_train(pairs, vocab_size=len(vocab), dim=16, steps=50, seed=42)
    np.testing.assert_array_equal(a, b)
    cpu = PE.sgns_train(pairs, vocab_size=len(vocab), dim=16, steps=50,
                        seed=42, device="cpu")
    assert rel_err(cpu, a) <= SGNS_RTOL


def test_lda_on_the_card():
    if not ON_CARD:
        pytest.skip("no CUDA device")
    _, _, _, counts = corpus()
    lam_c, theta_c = PE.lda_fit(counts, 4, iters=20, seed=0)
    lam_p, theta_p = PE.lda_fit(counts, 4, iters=20, seed=0, device="cpu")
    assert rel_err(lam_p, lam_c) <= LDA_RTOL
    np.testing.assert_allclose(theta_c, theta_p, rtol=0, atol=LDA_THETA_ATOL)
    np.testing.assert_array_equal(theta_c.argmax(1), theta_p.argmax(1))
    got = PE.lda_transform(counts, lam_c)
    want = PE.lda_transform(counts, lam_c, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=LDA_THETA_ATOL)

"""Embedding stages, the port of the JAX package's ``ops/embeddings.py``:
Word2Vec (skip-gram with negative sampling) and LDA (batch variational EM),
fitted on the card.

Reference: core/.../stages/impl/feature/OpWord2Vec.scala (Spark Word2Vec;
model.transform = the average of the document's word vectors) and
OpLDA.scala (k topics; transform = per-document topic distribution).

Both trainers are plain PyTorch on the device, the JAX package's XLA loops
written out:

* SGNS (``sgns_train``): the host pre-samples every step's batch and
  negatives with numpy ``default_rng(seed)``, as the reference does; the
  start ``w_in`` is ``jax.random.normal(PRNGKey(seed), (V, D)) / D`` bit for
  bit (``utils.prng.normal``; XLA folds ``/ D`` into the constant
  ``sqrt(2) / D``). Each step gathers the rows, takes the mean-reduced
  log-sigmoid loss's gradient in closed form, adds the duplicate rows'
  gradients in a fixed order (on the card a one-hot product through
  cuBLAS, no atomics, so two fits are bit-equal; on the CPU ``index_add_``
  in index order), clips the global norm at 1.0 and takes the SGD step at
  the linearly decayed rate. Nothing leaves the device inside the loop.
* LDA (``lda_fit``): the topic-word start is ``jax.random.gamma(PRNGKey(
  seed), 100.0, (k, V)) * 0.01`` bit for bit (``utils.prng.gamma``); 20 EM
  iterations of 10 E-steps over the whole ``[N, K, V]`` corpus tensor,
  ``torch.digamma`` and a softmax over K.
* ``OpLDAModel``'s transform keeps its own arithmetic (10 iterations,
  ``alpha = 1/k``, a max-subtract softmax) and runs on the model's device;
  ``OpWord2VecModel``'s transform is the host segment mean
  (``featurize/kernels.segment_mean_f32``), as in the JAX package.

``device`` (the estimators' constructor argument, ``None`` the card) is
where the fits run; a fitted model transforms on the device ``to()`` placed
it on, else on its fit's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..stages.base import Estimator, Model
from ..stages.metadata import ColumnMeta, VectorMetadata
from ..types import OPVector, TextList
from ..types.columns import Column, ListColumn, VectorColumn
from ..utils import prng
from ..utils.device import resolve_device


def sgns_batches(pairs: np.ndarray, vocab_size: int, steps: int,
                 batch: int = 1024, num_neg: int = 5, lr: float = 8.0,
                 seed: int = 42) -> tuple:
    """The host's pre-sampled steps, as the reference draws them: (centers
    [steps, B], contexts [steps, B], negatives [steps, B, G], the linearly
    decayed float32 rates [steps])."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(pairs), size=(steps, batch))
    neg = rng.integers(0, vocab_size, size=(steps, batch, num_neg))
    lr_sched = (lr * (1.0 - np.arange(steps) / steps)).astype(np.float32)
    return pairs[idx, 0], pairs[idx, 1], neg, lr_sched


def sgns_start(vocab_size: int, dim: int, seed: int) -> np.ndarray:
    """The reference's start ``normal(PRNGKey(seed), (V, D)) / D`` as its
    jitted program computes it: ``erfinv(u) * (sqrt(2) * (1 / D))``."""
    return prng.normal(prng.prng_key(seed), (vocab_size, dim),
                       scale=np.float32(1) / np.float32(dim))


def sgns_steps(w_in: torch.Tensor, centers, contexts, neg, lr_sched
               ) -> torch.Tensor:
    """Run the SGD steps from ``w_in`` ([V, D] float32 on the device; the
    output table starts at zero) over the pre-sampled steps (int64 tensors
    [S, B], [S, B], [S, B, G] and float32 rates [S], on the same device);
    returns the input vectors."""
    vocab, dim = w_in.shape
    steps, batch = centers.shape
    num_neg = neg.shape[2]
    dev = w_in.device
    w_in = w_in.clone()
    w_out = torch.zeros_like(w_in)
    inv_b = 1.0 / batch  # the batch is a power of two in the reference's use
    on_card = dev.type == "cuda"
    if on_card:
        hot_in = torch.empty((batch, vocab), dtype=torch.float32, device=dev)
        hot_out = torch.empty((batch * (1 + num_neg), vocab),
                              dtype=torch.float32, device=dev)
        ones_in = torch.ones((batch, 1), dtype=torch.float32, device=dev)
        ones_out = torch.ones((hot_out.shape[0], 1), dtype=torch.float32,
                              device=dev)
    # filled on the device: a tensor built from a host scalar is a
    # blocking upload
    tiny = torch.full((), 1e-30, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for t in range(steps):
        c, ctx, ng = centers[t], contexts[t], neg[t]
        v = w_in[c]                                    # [B, D]
        u_pos = w_out[ctx]                             # [B, D]
        u_neg = w_out[ng]                              # [B, G, D]
        pos = (v * u_pos).sum(-1)                      # [B]
        negs = torch.bmm(u_neg, v.unsqueeze(2)).squeeze(2)  # [B, G]
        # d/dpos of -mean(log sigmoid(pos)); d/dneg of
        # -mean(sum_g log sigmoid(-neg))
        g_pos = torch.sigmoid(-pos).mul_(-inv_b)
        g_neg = torch.sigmoid(negs).mul_(inv_b)
        g_v = torch.addcmul(torch.bmm(g_neg.unsqueeze(1), u_neg).squeeze(1),
                            g_pos.unsqueeze(1), u_pos)
        g_u = torch.cat([g_pos.unsqueeze(1) * v,
                         (g_neg.unsqueeze(2) * v.unsqueeze(1)).reshape(-1, dim)])
        rows_u = torch.cat([ctx, ng.reshape(-1)])
        if on_card:
            # the duplicate rows' gradients add up through a one-hot
            # product: one GEMM in a fixed order, where a scatter-add
            # would race
            hot_in.zero_().scatter_(1, c.unsqueeze(1), ones_in)
            hot_out.zero_().scatter_(1, rows_u.unsqueeze(1), ones_out)
            g_in = hot_in.T @ g_v
            g_out = hot_out.T @ g_u
        else:
            # the CPU's index_add_ adds in index order
            g_in = torch.zeros_like(w_in).index_add_(0, c, g_v)
            g_out = torch.zeros_like(w_out).index_add_(0, rows_u, g_u)
        norm = torch.sqrt((g_in * g_in).sum() + (g_out * g_out).sum())
        scale = lr_sched[t] * torch.minimum(one, 1.0 / torch.maximum(norm, tiny))
        w_in.sub_(g_in * scale)
        w_out.sub_(g_out * scale)
    return w_in


def sgns_train(pairs: np.ndarray, vocab_size: int, dim: int, num_neg: int = 5,
               steps: int = 2000, batch: int = 1024, lr: float = 8.0,
               seed: int = 42, device=None) -> np.ndarray:
    """Skip-gram negative sampling on ``device`` (``None``: the card):
    the reference's ``_sgns_train``, [V, D] float32 input vectors."""
    dev = resolve_device(device)
    centers, contexts, neg, lr_sched = sgns_batches(
        pairs, vocab_size, steps, batch, num_neg, lr, seed)
    w_in = torch.from_numpy(sgns_start(vocab_size, dim, seed)).to(dev)
    out = sgns_steps(
        w_in,
        torch.from_numpy(np.ascontiguousarray(centers, np.int64)).to(dev),
        torch.from_numpy(np.ascontiguousarray(contexts, np.int64)).to(dev),
        torch.from_numpy(np.ascontiguousarray(neg, np.int64)).to(dev),
        torch.from_numpy(lr_sched).to(dev))
    return out.cpu().numpy()


class OpWord2Vec(Estimator):
    """TextList → OPVector: average of learned word vectors
    (OpWord2Vec.scala; Spark defaults vectorSize 100, minCount 5,
    windowSize 5)."""

    input_types = (TextList,)
    output_type = OPVector

    def __init__(
        self,
        vector_size: int = 100,
        min_count: int = 5,
        window_size: int = 5,
        max_vocab: int = 10_000,
        steps: int | None = None,
        epochs: int = 2,
        seed: int = 42,
        device=None,
        uid: str | None = None,
    ):
        super().__init__("w2v", uid=uid)
        self.vector_size = vector_size
        self.min_count = min_count
        self.window_size = window_size
        self.max_vocab = max_vocab
        #: steps=None scales with the corpus: ceil(epochs·pairs/batch); an
        #: explicit value pins the budget
        self.steps = steps
        self.epochs = epochs
        self.seed = seed
        self.device = device

    def get_params(self):
        return {
            "vector_size": self.vector_size,
            "min_count": self.min_count,
            "window_size": self.window_size,
            "max_vocab": self.max_vocab,
            "steps": self.steps,
            "epochs": self.epochs,
            "seed": self.seed,
        }

    def vocabulary_and_pairs(self, col: ListColumn) -> tuple[list, np.ndarray]:
        """The fit's vocabulary (descending count, ties by the token, at
        least ``min_count``, at most ``max_vocab``) and its skip-gram
        pairs [P, 2] int32 (center, context), in the reference's order."""
        from ..featurize.interning import interned_of

        tc = interned_of(col)
        code_counts = (
            np.bincount(tc.codes, minlength=len(tc.vocab))
            if len(tc.vocab) else np.zeros(0, int)
        )
        # zero-count vocab entries (tokens an upstream stage filtered out
        # of every row) never count
        counts = {
            t: int(c) for t, c in zip(tc.vocab, code_counts) if c > 0
        }
        vocab = [
            t for t, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            if c >= self.min_count
        ][: self.max_vocab]
        index = {t: i for i, t in enumerate(vocab)}
        pairs = []
        w = self.window_size
        for toks in col.values:
            ids = [index[t] for t in toks if t in index]
            for i, c in enumerate(ids):
                for j in range(max(0, i - w), min(len(ids), i + w + 1)):
                    if j != i:
                        pairs.append((c, ids[j]))
        return vocab, np.asarray(pairs, dtype=np.int32).reshape(-1, 2)

    def fit_model(self, dataset) -> "OpWord2VecModel":
        col = dataset[self.input_names[0]]
        assert isinstance(col, ListColumn)
        vocab, pairs = self.vocabulary_and_pairs(col)
        self.metadata["vocabSize"] = len(vocab)
        if not vocab or not len(pairs):
            return OpWord2VecModel([], np.zeros((0, self.vector_size), np.float32))
        steps = self.steps
        if steps is None:
            steps = max(200, -(-self.epochs * len(pairs) // 1024))
        self.metadata["trainSteps"] = int(steps)
        vectors = sgns_train(
            pairs, vocab_size=len(vocab), dim=self.vector_size,
            steps=int(steps), seed=self.seed, device=self.device,
        )
        return OpWord2VecModel(vocab, vectors)


class OpWord2VecModel(Model):
    output_type = OPVector

    def __init__(self, vocab: list[str], vectors: np.ndarray, uid=None):
        super().__init__("w2v", uid=uid)
        self.vocab = list(vocab)
        self.vectors = np.asarray(vectors, dtype=np.float32)
        self._index = {t: i for i, t in enumerate(self.vocab)}

    def get_params(self):
        return {"vocab": self.vocab}

    def get_arrays(self):
        return {"vectors": self.vectors}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(params["vocab"], arrays["vectors"])

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        from ..featurize import kernels as FK
        from ..featurize.interning import interned_of

        col = cols[0]
        assert isinstance(col, ListColumn)
        dim = self.vectors.shape[1] if self.vectors.size else 0
        # resolve each DISTINCT token against the learned vocabulary once,
        # drop unknowns with one vectorized filter, then a segment mean
        # over the CSR layout
        tc = interned_of(col)
        idx = self._index
        code_to_vec = np.fromiter(
            (idx.get(t, -1) for t in tc.vocab), np.int64, len(tc.vocab)
        )
        if dim and tc.num_tokens:
            mapped = code_to_vec[tc.codes]
            keep = mapped >= 0
            kept_cum = np.zeros(len(keep) + 1, dtype=np.int64)
            np.cumsum(keep, out=kept_cum[1:])
            values = FK.segment_mean_f32(
                self.vectors, mapped[keep], kept_cum[tc.offsets]
            )
        else:
            values = np.zeros((num_rows, dim), dtype=np.float32)
        f = self.input_features[0]
        metas = tuple(
            ColumnMeta(
                parent_names=(f.name,),
                parent_type=f.ftype.__name__,
                grouping=f.name,
                index=i,
            )
            for i in range(dim)
        )
        return VectorColumn(OPVector, values, VectorMetadata(self.output_name, metas))


def lda_start(k: int, vocab_size: int, seed: int) -> np.ndarray:
    """The reference's topic-word start ``gamma(PRNGKey(seed), 100.0, (k,
    V)) * 0.01``, bit for bit."""
    lam = prng.gamma(prng.prng_key(seed), 100.0, (k, vocab_size))
    return (lam * np.float32(0.01)).astype(np.float32)


def _e_log(t: torch.Tensor) -> torch.Tensor:
    """E[log] of Dirichlet rows: digamma(t) - digamma(row sums)."""
    return torch.digamma(t) - torch.digamma(t.sum(1, keepdim=True))


def _e_step(x: torch.Tensor, e_log_beta: torch.Tensor, alpha: float,
            e_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    n, k = x.shape[0], e_log_beta.shape[0]
    gamma = torch.ones((n, k), dtype=torch.float32, device=x.device)
    xcol = x.unsqueeze(2)
    for _ in range(e_iters):
        # phi_nk ∝ exp(E[log θ_nk] + E[log β_k,w]) over words
        phi = torch.softmax(_e_log(gamma).unsqueeze(2) + e_log_beta, dim=1)
        gamma = torch.bmm(phi, xcol).squeeze(2).add_(alpha)
    phi = torch.softmax(_e_log(gamma).unsqueeze(2) + e_log_beta, dim=1)
    return gamma, phi


def lda_fit(x, k: int, iters: int = 20, e_iters: int = 10,
            alpha: float | None = None, eta: float | None = None,
            seed: int = 42, device=None) -> tuple[np.ndarray, np.ndarray]:
    """Batch variational EM for LDA on ``device`` (``None``: the card): the
    reference's ``_lda_fit``, (topic_word [k, V], theta [N, k]) float32. The
    whole corpus's E-step is one [N, K, V] tensor iteration."""
    dev = resolve_device(device)
    alpha = alpha if alpha is not None else 1.0 / k
    eta = eta if eta is not None else 1.0 / k
    xt = torch.as_tensor(np.array(x, dtype=np.float32)).to(dev)
    lam = torch.from_numpy(lda_start(k, xt.shape[1], seed)).to(dev)
    xrow = xt.unsqueeze(1)
    for _ in range(iters):
        _, phi = _e_step(xt, _e_log(lam), alpha, e_iters)
        lam = phi.mul_(xrow).sum(0).add_(eta)
        del phi
    gamma, _ = _e_step(xt, _e_log(lam), alpha, e_iters)
    theta = gamma / gamma.sum(1, keepdim=True)
    return lam.cpu().numpy(), theta.cpu().numpy()


def lda_transform(x, topic_word, device=None) -> np.ndarray:
    """``OpLDAModel``'s per-document topic distribution [N, k] float32 on
    ``device``: 10 iterations at ``alpha = 1/k`` with a max-subtract
    softmax, as the reference's transform computes it."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.array(x, dtype=np.float32)).to(dev)
    lam = torch.as_tensor(np.array(topic_word, dtype=np.float32)).to(dev)
    k = lam.shape[0]
    e_log_beta = _e_log(lam)
    gamma = torch.ones((xt.shape[0], k), dtype=torch.float32, device=dev)
    xcol = xt.unsqueeze(2)
    for _ in range(10):
        log_phi = _e_log(gamma).unsqueeze(2) + e_log_beta
        phi = torch.exp(log_phi - log_phi.amax(1, keepdim=True))
        phi = phi.div_(phi.sum(1, keepdim=True))
        gamma = torch.bmm(phi, xcol).squeeze(2).add_(1.0 / k)
    return (gamma / gamma.sum(1, keepdim=True)).cpu().numpy()


class OpLDA(Estimator):
    """OPVector (term counts) → OPVector topic distribution (OpLDA.scala;
    Spark defaults k=10, maxIter=20)."""

    input_types = (OPVector,)
    output_type = OPVector

    def __init__(
        self,
        k: int = 10,
        max_iter: int = 20,
        seed: int = 42,
        device=None,
        uid: str | None = None,
    ):
        super().__init__("lda", uid=uid)
        self.k = k
        self.max_iter = max_iter
        self.seed = seed
        self.device = device

    def get_params(self):
        return {"k": self.k, "max_iter": self.max_iter, "seed": self.seed}

    def fit_model(self, dataset) -> "OpLDAModel":
        col = dataset[self.input_names[0]]
        assert isinstance(col, VectorColumn)
        x = np.asarray(col.values, dtype=np.float64)
        lam, _ = lda_fit(x, self.k, iters=self.max_iter, seed=self.seed,
                         device=self.device)
        self.metadata["k"] = self.k
        self.metadata["vocabSize"] = int(x.shape[1])
        model = OpLDAModel(lam)
        model.default_device = resolve_device(self.device)
        return model


class OpLDAModel(Model):
    output_type = OPVector

    def __init__(self, topic_word, uid=None):
        super().__init__("lda", uid=uid)
        self.topic_word = np.asarray(topic_word, dtype=np.float32)  # [K, V]
        #: where ``to()`` placed the model; else its fit's device
        self.device: torch.device | None = None
        self.default_device: torch.device | None = None

    def get_arrays(self):
        return {"topic_word": self.topic_word}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["topic_word"])

    def to(self, device) -> "OpLDAModel":
        self.device = torch.device(device)
        return self

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        col = cols[0]
        assert isinstance(col, VectorColumn)
        dev = self.device or self.default_device or resolve_device(None)
        values = lda_transform(np.asarray(col.values), self.topic_word, dev)
        f = self.input_features[0]
        metas = tuple(
            ColumnMeta(
                parent_names=(f.name,),
                parent_type=f.ftype.__name__,
                grouping=f.name,
                descriptor_value=f"topic_{i}",
                index=i,
            )
            for i in range(values.shape[1])
        )
        return VectorColumn(OPVector, values, VectorMetadata(self.output_name, metas))

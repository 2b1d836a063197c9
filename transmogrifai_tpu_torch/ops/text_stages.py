"""Text pipeline stages, the port of the JAX package's ``ops/text_stages.py``:
tokenizer, n-grams, stop words, count / hashing TF, IDF, string indexing,
similarities, language / MIME / email / name detection.

Host numpy, as in the JAX package; vocabularies, orders, tie-breaks,
metadata and output columns equal its own. The term planes ride the port's
interned code arrays (``featurize/interning``) and code-array kernels
(``featurize/kernels``: ``hash_vocab``, ``term_count_block``,
``distinct_pair_bincount``).

Reference stages replaced (core/.../stages/impl/feature/):
  * TextTokenizer.scala — Lucene per-language analyzers → the regex
    tokenizer (utils/text.py) with the same defaults (lowercase, min
    length), or the per-language analyzers (utils/analyzers.py) when a
    language is set or detected.
  * OpNGram.scala — Spark NGram: n-grams joined by spaces.
  * OpStopWordsRemover.scala — Spark StopWordsRemover (english defaults).
  * OpCountVectorizer.scala — Spark CountVectorizer (vocabSize, minDF).
  * OpHashingTF.scala — term hashing to a fixed width (murmur3).
  * (Spark IDF via sparkwrappers) — OpIDF estimator here.
  * OpStringIndexer{,NoFilter}.scala / OpIndexToString{,NoFilter}.scala —
    frequency-ordered label indexing and its inverse: labels sort by
    descending count, ties by the label's own order; ``handle_invalid`` is
    ``"keep"`` (an unseen label maps to the label count), ``"skip"``
    (masked, value 0) or ``"error"``.
  * JaccardSimilarity.scala — |A∩B| / |A∪B| over token sets.
  * NGramSimilarity.scala — character-n-gram similarity (a Jaccard over
    padded char n-grams).
  * LangDetector.scala — nlp/langid.py (script census + function-word /
    diacritic voting, ~55 languages; output RealMap[lang → confidence]).
  * MimeTypeDetector.scala — Tika → magic-byte table over common formats.
  * ValidEmailTransformer.scala — RFC-lite regex validation.
  * HumanNameDetector.scala / NameEntityRecognizer.scala — OpenNLP models →
    dictionary + the character-level name model (nlp/name_model.py) +
    shape heuristics, emitting the same NameStats / entity-map shapes.
"""
from __future__ import annotations

import base64
import binascii
import re
from functools import lru_cache as _lru_cache
from typing import Any

import numpy as np

from ..featurize.interning import (
    InternedTextList,
    TokenCodes,
    intern_values,
    interned_of,
    tokenize_text_column,
)
from ..stages.base import Estimator, Model, Transformer
from ..stages.metadata import ColumnMeta, VectorMetadata
from ..types import (
    Binary,
    MultiPickListMap,
    NameStats,
    OPVector,
    PickListMap,
    RealMap,
    RealNN,
    Text,
    TextList,
)
from ..types.columns import (
    Column,
    ListColumn,
    MapColumn,
    NumericColumn,
    TextColumn,
    VectorColumn,
)
from ..utils.text import tokenize


class TextTokenizer(Transformer):
    """Text → TextList (TextTokenizer.scala; defaults ToLowercase=true,
    MinTokenLength=1, AutoDetectLanguage=false, DefaultLanguage=Unknown →
    the standard analyzer).

    With ``language`` set (or ``auto_detect_language``), tokens run through
    the per-language analyzer — stopword filter + stemmer matching the
    reference's Lucene analyzers for its 7 shipped languages
    (utils/analyzers.py; LuceneTextAnalyzer.scala:1-236)."""

    input_types = (Text,)
    output_type = TextList

    def __init__(
        self,
        to_lowercase: bool = True,
        min_token_length: int = 1,
        language: str | None = None,
        auto_detect_language: bool = False,
        uid: str | None = None,
    ):
        super().__init__("tokenized", uid=uid)
        self.to_lowercase = to_lowercase
        self.min_token_length = min_token_length
        self.language = language
        self.auto_detect_language = auto_detect_language

    def get_params(self):
        return {
            "to_lowercase": self.to_lowercase,
            "min_token_length": self.min_token_length,
            "language": self.language,
            "auto_detect_language": self.auto_detect_language,
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> ListColumn:
        col = cols[0]
        assert isinstance(col, TextColumn)
        if self.language or self.auto_detect_language:
            from ..utils.analyzers import analyze

            out = [
                analyze(
                    v, language=self.language,
                    auto_detect=self.auto_detect_language,
                    to_lowercase=self.to_lowercase,
                    min_token_length=self.min_token_length,
                ) if v else []
                for v in col.values
            ]
            return ListColumn(TextList, out)
        # interned hot path: ONE native tokenize+intern pass over the
        # column; downstream text stages consume the code arrays and the
        # list-of-lists view only materializes if something asks for it
        return InternedTextList(
            TextList,
            tokenize_text_column(
                col.values, self.to_lowercase, self.min_token_length
            ),
        )


class OpNGram(Transformer):
    """TextList → TextList of space-joined n-grams (OpNGram.scala; Spark
    NGram default n=2)."""

    input_types = (TextList,)
    output_type = TextList

    def __init__(self, n: int = 2, uid: str | None = None):
        super().__init__("ngram", uid=uid)
        if n < 1:
            raise ValueError("n must be >= 1")
        self.n = n

    def get_params(self):
        return {"n": self.n}

    def transform_columns(self, *cols: Column, num_rows: int) -> ListColumn:
        col = cols[0]
        assert isinstance(col, ListColumn)
        n = self.n
        tc = interned_of(col)
        if n == 1:  # 1-grams are the tokens themselves
            return InternedTextList(TextList, tc)
        counts = tc.row_counts()
        out_counts = np.maximum(counts - (n - 1), 0)
        offsets = np.zeros(tc.num_rows + 1, dtype=np.int64)
        np.cumsum(out_counts, out=offsets[1:])
        total = int(offsets[-1])
        if total == 0:
            return InternedTextList(
                TextList, TokenCodes(np.zeros(0, np.int32), offsets, [])
            )
        # window start positions (global token index per emitted n-gram)
        starts = (
            np.arange(total, dtype=np.int64)
            - np.repeat(offsets[:-1], out_counts)
            + np.repeat(tc.offsets[:-1], out_counts)
        )
        windows = tc.codes[starts[:, None] + np.arange(n, dtype=np.int64)]
        uniq, inverse = np.unique(windows, axis=0, return_inverse=True)
        vocab_arr = tc.vocab_array()
        ngram_vocab = [" ".join(vocab_arr[win]) for win in uniq]
        return InternedTextList(
            TextList,
            TokenCodes(
                inverse.astype(np.int32, copy=False), offsets, ngram_vocab
            ),
        )


# Spark's StopWordsRemover english default list (org.apache.spark.ml.feature,
# itself from the public "Glasgow stop words" set) — abridged to the tokens
# that affect typical feature engineering.
ENGLISH_STOP_WORDS = frozenset("""
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for from
further had hadn't has hasn't have haven't having he he'd he'll he's her here
here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of
off on once only or other ought our ours ourselves out over own same shan't
she she'd she'll she's should shouldn't so some such than that that's the
their theirs them themselves then there there's these they they'd they'll
they're they've this those through to too under until up very was wasn't we
we'd we'll we're we've were weren't what what's when when's where where's
which while who who's whom why why's with won't would wouldn't you you'd
you'll you're you've your yours yourself yourselves
""".split())


class OpStopWordsRemover(Transformer):
    """TextList → TextList without stop words (OpStopWordsRemover.scala;
    Spark default: english, caseSensitive=false)."""

    input_types = (TextList,)
    output_type = TextList

    def __init__(
        self,
        stop_words=ENGLISH_STOP_WORDS,
        case_sensitive: bool = False,
        uid: str | None = None,
    ):
        super().__init__("stopWordsRemoved", uid=uid)
        self.stop_words = frozenset(stop_words)
        self.case_sensitive = case_sensitive
        self._lowered = frozenset(w.lower() for w in self.stop_words)
        #: token -> is-stop-word, filled lazily: the case-insensitive path
        #: lowercases each DISTINCT token at most once per process instead
        #: of every token on every transform call
        self._member_cache: dict[str, bool] = {}

    def get_params(self):
        return {
            "stop_words": sorted(self.stop_words),
            "case_sensitive": self.case_sensitive,
        }

    def _is_stop(self, token: str) -> bool:
        if self.case_sensitive:
            return token in self.stop_words
        got = self._member_cache.get(token)
        if got is None:
            if len(self._member_cache) >= 65536:
                # long-lived serving processes see unbounded distinct
                # tokens — bound the memo instead of leaking
                self._member_cache.clear()
            got = self._member_cache[token] = token.lower() in self._lowered
        return got

    def transform_columns(self, *cols: Column, num_rows: int) -> ListColumn:
        col = cols[0]
        assert isinstance(col, ListColumn)
        tc = interned_of(col)
        # membership is decided once per DISTINCT token (a boolean mask
        # over the batch vocabulary), then the drop is one vectorized
        # filter over the code array
        drop = np.fromiter(
            (self._is_stop(t) for t in tc.vocab), bool, len(tc.vocab)
        )
        if not drop.any():
            return InternedTextList(TextList, tc)
        keep = ~drop[tc.codes]
        kept_cum = np.zeros(len(keep) + 1, dtype=np.int64)
        np.cumsum(keep, out=kept_cum[1:])
        offsets = kept_cum[tc.offsets]
        return InternedTextList(
            TextList, TokenCodes(tc.codes[keep], offsets, tc.vocab)
        )


def _term_vector_metas(output_name: str, feature, vocab: list[str]):
    metas = tuple(
        ColumnMeta(
            parent_names=(feature.name,),
            parent_type=feature.ftype.__name__,
            grouping=feature.name,
            indicator_value=t,
            index=i,
        )
        for i, t in enumerate(vocab)
    )
    return VectorMetadata(output_name, metas)


class OpCountVectorizer(Estimator):
    """TextList → OPVector of term counts with a learned vocabulary
    (OpCountVectorizer.scala; Spark defaults vocabSize 2^18, minDF 1)."""

    input_types = (TextList,)
    output_type = OPVector

    def __init__(
        self,
        vocab_size: int = 1 << 18,
        min_df: float = 1.0,
        binary: bool = False,
        uid: str | None = None,
    ):
        super().__init__("countVectorized", uid=uid)
        self.vocab_size = vocab_size
        self.min_df = min_df
        self.binary = binary

    def get_params(self):
        return {
            "vocab_size": self.vocab_size,
            "min_df": self.min_df,
            "binary": self.binary,
        }

    def fit_model(self, dataset) -> "OpCountVectorizerModel":
        col = dataset[self.input_names[0]]
        assert isinstance(col, ListColumn)
        # interned fit: term frequency is one bincount over the code
        # array; document frequency one bincount over the distinct
        # (row, code) pairs — no per-row/token dict churn
        from ..featurize.kernels import distinct_pair_bincount

        tc = interned_of(col)
        nv = len(tc.vocab)
        tf = np.bincount(tc.codes, minlength=nv) if nv else np.zeros(0, int)
        if tc.num_tokens:
            df = distinct_pair_bincount(tc.row_index(), tc.codes, nv)
        else:
            df = np.zeros(nv, dtype=np.int64)
        n = len(col)
        min_docs = self.min_df if self.min_df >= 1 else self.min_df * n
        # d > 0: the shared interned vocabulary can carry tokens an
        # upstream stage filtered out of every row (e.g. stop words) —
        # the historical per-row df dict never saw those, so min_df <= 0
        # must not admit them
        terms = [t for t, d in zip(tc.vocab, df) if d >= min_docs and d > 0]
        # highest total frequency first, ties lexicographic (stable vocab)
        tf_of = {t: int(c) for t, c in zip(tc.vocab, tf)}
        terms.sort(key=lambda t: (-tf_of[t], t))
        vocab = terms[: self.vocab_size]
        self.metadata["vocabSize"] = len(vocab)
        return OpCountVectorizerModel(vocab, self.binary)


class OpCountVectorizerModel(Model):
    output_type = OPVector

    def __init__(self, vocab: list[str], binary: bool = False, uid: str | None = None):
        super().__init__("countVectorized", uid=uid)
        self.vocab = list(vocab)
        self.binary = binary
        self._index = {t: i for i, t in enumerate(self.vocab)}

    def get_params(self):
        return {"vocab": self.vocab, "binary": self.binary}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(params["vocab"], params.get("binary", False))

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        from ..featurize import kernels as FK

        col = cols[0]
        assert isinstance(col, ListColumn)
        tc = interned_of(col)
        code_to_col = FK.map_vocab(tc.vocab, self._index)
        width = len(self.vocab)
        if width > FK.dense_vocab_max():
            # Spark-default vocab_size is 2^18: a dense [N, 2^18] float32
            # transform allocates ~1 GB per 1k rows — wide vocabularies
            # stay COO (the SparseMatrix path every assembler supports)
            values: Any = FK.term_count_sparse(
                tc, code_to_col, width, binary=self.binary
            )
        else:
            values = FK.term_count_block(
                tc, code_to_col, width, binary=self.binary
            )
        return VectorColumn(
            OPVector, values,
            _term_vector_metas(
                self.output_name, self.input_features[0], self.vocab
            ),
        )


class OpHashingTF(Transformer):
    """TextList → OPVector via term hashing (OpHashingTF.scala). Spark's
    default width is 2^18 over a sparse vector; this column is dense
    ([N, D] float32 shipping to device), so the default follows the
    Transmogrifier text-hash width (512, TransmogrifierDefaults
    DefaultNumOfFeatures) — pass num_features explicitly for more."""

    input_types = (TextList,)
    output_type = OPVector

    def __init__(
        self, num_features: int = 512, binary: bool = False, uid: str | None = None
    ):
        super().__init__("hashingTF", uid=uid)
        self.num_features = num_features
        self.binary = binary

    def get_params(self):
        return {"num_features": self.num_features, "binary": self.binary}

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        from ..featurize import kernels as FK

        col = cols[0]
        assert isinstance(col, ListColumn)
        tc = interned_of(col)
        # each DISTINCT term is murmur3-hashed once; occurrences ride the
        # code array through the native bincount scatter
        bucket_of = FK.hash_vocab(tc.vocab, self.num_features)
        values = FK.term_count_block(
            tc, bucket_of, self.num_features, binary=self.binary
        )
        f = self.input_features[0]
        metas = tuple(
            ColumnMeta(
                parent_names=(f.name,),
                parent_type=f.ftype.__name__,
                grouping=f.name,
                index=i,
            )
            for i in range(self.num_features)
        )
        return VectorColumn(
            OPVector, values, VectorMetadata(self.output_name, metas)
        )


class OpIDF(Estimator):
    """OPVector (term counts) → OPVector (tf·idf); Spark IDF semantics:
    idf = ln((n_docs + 1) / (df + 1)), minDocFreq 0."""

    input_types = (OPVector,)
    output_type = OPVector

    def __init__(self, min_doc_freq: int = 0, uid: str | None = None):
        super().__init__("idf", uid=uid)
        self.min_doc_freq = min_doc_freq

    def get_params(self):
        return {"min_doc_freq": self.min_doc_freq}

    def fit_model(self, dataset) -> "OpIDFModel":
        from ..types.columns import SparseMatrix

        col = dataset[self.input_names[0]]
        assert isinstance(col, VectorColumn)
        if isinstance(col.values, SparseMatrix):
            # document frequency without densifying the wide term plane:
            # one bincount over the distinct (row, term) pairs
            from ..featurize.kernels import distinct_pair_bincount

            sm = col.values
            n, width = sm.shape
            df = distinct_pair_bincount(
                sm.rows, sm.cols, width
            ).astype(np.float64)
        else:
            x = np.asarray(col.values)
            df = (x > 0).sum(axis=0).astype(np.float64)
            n = x.shape[0]
        idf = np.log((n + 1.0) / (df + 1.0))
        idf = np.where(df >= self.min_doc_freq, idf, 0.0)
        return OpIDFModel(idf)


class OpIDFModel(Model):
    output_type = OPVector

    def __init__(self, idf, uid: str | None = None):
        super().__init__("idf", uid=uid)
        self.idf = np.asarray(idf, dtype=np.float64)

    def get_arrays(self):
        return {"idf": self.idf}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["idf"])

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        from ..types.columns import SparseMatrix

        col = cols[0]
        assert isinstance(col, VectorColumn)
        if isinstance(col.values, SparseMatrix):
            # keep the wide term plane COO: accumulate duplicate pairs into
            # counts first so each nonzero is ONE float64 product rounded
            # to float32 — bit-identical to the dense multiply
            sm = col.values
            n, width = sm.shape
            flat = sm.rows.astype(np.int64) * width + sm.cols.astype(np.int64)
            if sm.vals is None:
                uniq, counts = np.unique(flat, return_counts=True)
                weights = counts.astype(np.float64)
            else:
                order = np.argsort(flat, kind="stable")
                uniq, starts = np.unique(flat[order], return_index=True)
                weights = np.add.reduceat(
                    sm.vals[order].astype(np.float64), starts
                ) if len(uniq) else np.zeros(0)
            rows_u = (uniq // width).astype(np.int32)
            cols_u = (uniq % width).astype(np.int32)
            vals = (weights * self.idf[uniq % width]).astype(np.float32)
            return VectorColumn(
                OPVector,
                SparseMatrix(rows_u, cols_u, (n, width), vals),
                col.metadata,
            )
        values = (np.asarray(col.values) * self.idf[None, :]).astype(np.float32)
        return VectorColumn(OPVector, values, col.metadata)


class OpStringIndexer(Estimator):
    """Text -> RealNN index ordered by descending frequency. handle_invalid:
    'error' | 'skip' (masked) | 'keep' (unseen -> num_labels), the
    reference's NoFilter default keeps."""

    input_types = (Text,)
    output_type = RealNN

    def __init__(self, handle_invalid: str = "keep", uid: str | None = None):
        super().__init__("strIdx", uid=uid)
        if handle_invalid not in ("error", "skip", "keep"):
            raise ValueError(f"bad handle_invalid {handle_invalid}")
        self.handle_invalid = handle_invalid

    def get_params(self):
        return {"handle_invalid": self.handle_invalid}

    def fit_model(self, dataset) -> "OpStringIndexerModel":
        col = dataset[self.input_names[0]]
        if not isinstance(col, TextColumn):
            raise TypeError(f"OpStringIndexer needs a text column, got "
                            f"{type(col).__name__}")
        counts: dict[str, int] = {}
        for v in col.values:
            if v is not None:
                counts[v] = counts.get(v, 0) + 1
        labels = sorted(counts, key=lambda t: (-counts[t], t))
        self.metadata["labels"] = labels
        return OpStringIndexerModel(labels, self.handle_invalid)


class OpStringIndexerModel(Model):
    output_type = RealNN

    def __init__(self, labels: list[str], handle_invalid: str = "keep", uid=None):
        super().__init__("strIdx", uid=uid)
        self.labels = list(labels)
        self.handle_invalid = handle_invalid
        self._index = {t: i for i, t in enumerate(self.labels)}

    def get_params(self):
        return {"labels": self.labels, "handle_invalid": self.handle_invalid}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(params["labels"], params.get("handle_invalid", "keep"))

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        col = cols[0]
        if not isinstance(col, TextColumn):
            raise TypeError(f"OpStringIndexerModel needs a text column, got "
                            f"{type(col).__name__}")
        # a label column repeats a few distinct values: intern once, look
        # each distinct value up, then map every row with one gather
        present = np.fromiter((v is not None for v in col.values), bool, num_rows)
        texts = [v for v in col.values if v is not None]
        codes, uniques, _ = intern_values(texts)
        uniq_idx = np.fromiter(
            (-1 if (j := self._index.get(u)) is None else j for u in uniques),
            np.int64, len(uniques),
        )
        mapped = np.full(num_rows, -1, dtype=np.int64)
        if texts:
            mapped[present] = uniq_idx[codes]
        vals = mapped.astype(np.float64)
        mask = np.ones(num_rows, dtype=bool)
        miss = mapped < 0
        if miss.any():
            if self.handle_invalid == "keep":
                vals[miss] = float(len(self.labels))
            elif self.handle_invalid == "skip":
                vals[miss] = 0.0
                mask[miss] = False
            else:
                bad = int(np.nonzero(miss)[0][0])
                raise ValueError(f"Unseen label {col.values[bad]!r}")
        return NumericColumn(RealNN, vals, mask)


class OpIndexToString(Transformer):
    """RealNN index -> Text label; an index out of range or masked maps to
    ``unseen``."""

    input_types = (RealNN,)
    output_type = Text

    def __init__(self, labels: list[str], unseen: str = "UnseenIndex", uid=None):
        super().__init__("idxToStr", uid=uid)
        self.labels = list(labels)
        self.unseen = unseen

    def get_params(self):
        return {"labels": self.labels, "unseen": self.unseen}

    def transform_columns(self, *cols: Column, num_rows: int) -> TextColumn:
        col = cols[0]
        if not isinstance(col, NumericColumn):
            raise TypeError(f"OpIndexToString needs a numeric column, got "
                            f"{type(col).__name__}")
        out = np.empty(num_rows, dtype=object)
        for i, (v, m) in enumerate(zip(col.values, col.mask)):
            j = int(v)
            out[i] = self.labels[j] if m and 0 <= j < len(self.labels) else self.unseen
        return TextColumn(Text, out)


class JaccardSimilarity(Transformer):
    """Two set/list features → RealNN |A∩B|/|A∪B| (JaccardSimilarity.scala;
    both empty → 1.0)."""

    output_type = RealNN

    def __init__(self, uid: str | None = None):
        super().__init__("jacSim", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        a_vals = cols[0].to_list()
        b_vals = cols[1].to_list()
        out = np.zeros(num_rows, dtype=np.float64)
        for i, (a, b) in enumerate(zip(a_vals, b_vals)):
            sa = set(a) if a else set()
            sb = set(b) if b else set()
            if not sa and not sb:
                out[i] = 1.0
            else:
                union = len(sa | sb)
                out[i] = len(sa & sb) / union if union else 1.0
        return NumericColumn(RealNN, out, np.ones(num_rows, dtype=bool))


class NGramSimilarity(Transformer):
    """Two text features → RealNN char-n-gram similarity
    (NGramSimilarity.scala; default n=3; Lucene NGramDistance replaced by
    Jaccard over padded char n-grams — same range, both-empty → 0)."""

    output_type = RealNN

    def __init__(self, n: int = 3, uid: str | None = None):
        super().__init__("ngramSim", uid=uid)
        self.n = n

    def get_params(self):
        return {"n": self.n}

    def _grams(self, s: str) -> set:
        s = f"{'_' * (self.n - 1)}{s.lower()}{'_' * (self.n - 1)}"
        return {s[i : i + self.n] for i in range(len(s) - self.n + 1)}

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        def as_text(v):
            if isinstance(v, list):
                v = " ".join(v)
            return v or ""

        a_vals, b_vals = cols[0].to_list(), cols[1].to_list()
        out = np.zeros(num_rows, dtype=np.float64)
        for i in range(num_rows):
            a, b = as_text(a_vals[i]), as_text(b_vals[i])
            if not a or not b:
                out[i] = 0.0
                continue
            ga, gb = self._grams(a), self._grams(b)
            union = len(ga | gb)
            out[i] = len(ga & gb) / union if union else 0.0
        return NumericColumn(RealNN, out, np.ones(num_rows, dtype=bool))


# ------------------------------------------------------------------ detectors

# language detection lives in nlp/langid.py (script census +
# function-word voting, ~55 languages)


class LangDetector(Transformer):
    """Text → RealMap[language → confidence] (LangDetector.scala; the
    Optimaize profile model is replaced by nlp/langid.py — script census +
    function-word/diacritic voting over ~55 languages; measured per-language
    accuracy in PARITY.md, same output shape/keying)."""

    input_types = (Text,)
    output_type = RealMap

    def __init__(self, uid: str | None = None):
        super().__init__("langDetected", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        from ..nlp.langid import detect_scores

        col = cols[0]
        assert isinstance(col, TextColumn)
        out = [detect_scores(v) if v else {} for v in col.values]
        return MapColumn(RealMap, out)


_MAGIC_BYTES: list[tuple[bytes, str]] = [
    (b"%PDF", "application/pdf"),
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF87a", "image/gif"),
    (b"GIF89a", "image/gif"),
    (b"PK\x03\x04", "application/zip"),
    (b"\x1f\x8b", "application/gzip"),
    (b"BM", "image/bmp"),
    (b"ID3", "audio/mpeg"),
    (b"RIFF", "audio/x-wav"),
    (b"\xd0\xcf\x11\xe0", "application/x-ole-storage"),
    (b"<?xml", "application/xml"),
    (b"<html", "text/html"),
    (b"<!DOCTYPE html", "text/html"),
]


def detect_mime(b64: str | None) -> str | None:
    """Magic-byte MIME detection of a base64 payload (shared by the scalar
    and map detectors); None for missing/undecodable."""
    if not b64:
        return None
    try:
        data = base64.b64decode(b64, validate=True)
    except (binascii.Error, ValueError):
        return None
    if not data:
        return None
    head = data[:32]
    for magic, mime in _MAGIC_BYTES:
        if head.startswith(magic):
            return mime
    try:
        data[:512].decode("utf-8")
        return "text/plain"
    except UnicodeDecodeError:
        return "application/octet-stream"


class MimeTypeDetector(Transformer):
    """Base64 → Text MIME type (MimeTypeDetector.scala; Tika replaced by a
    magic-byte table; undecodable/unknown → 'application/octet-stream',
    decodable text → 'text/plain')."""

    output_type = Text

    def __init__(self, uid: str | None = None):
        super().__init__("mimeDetected", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> TextColumn:
        col = cols[0]
        assert isinstance(col, TextColumn)
        out = np.empty(num_rows, dtype=object)
        out[:] = [detect_mime(v) for v in col.values]
        return TextColumn(Text, out)


class MimeTypeMapDetector(Transformer):
    """Base64Map → PickListMap of MIME types per key
    (RichMapFeature.detectMimeTypes, RichMapFeature.scala:129) — the map
    form of MimeTypeDetector; undetectable values drop out of the row."""

    output_type = PickListMap

    def __init__(self, uid: str | None = None):
        super().__init__("mimeMapDetected", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        col = cols[0]
        assert isinstance(col, MapColumn)
        out = []
        for m in col.to_list():
            if not m:
                out.append({})
                continue
            row = {}
            for k, v in m.items():
                mime = detect_mime(v)
                if mime is not None:
                    row[k] = mime
            out.append(row)
        return MapColumn(PickListMap, out)


_EMAIL_RE = re.compile(
    r"^[A-Za-z0-9.!#$%&'*+/=?^_`{|}~-]+@"
    r"[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?"
    r"(?:\.[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?)+$"
)


class ValidEmailTransformer(Transformer):
    """Email → Binary validity (ValidEmailTransformer.scala)."""

    output_type = Binary

    def __init__(self, uid: str | None = None):
        super().__init__("validEmail", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, TextColumn)
        vals = [
            bool(_EMAIL_RE.match(v)) if v is not None else None
            for v in col.values
        ]
        from ..types.columns import column_from_values

        return column_from_values(Binary, vals)


# A compact sample of high-frequency given names (US census top names,
# public domain). The reference ships full census dictionaries in its
# models module; extend via the `names` ctor arg.
_COMMON_NAMES = frozenset("""
james john robert michael william david richard joseph thomas charles mary
patricia jennifer linda elizabeth barbara susan jessica sarah karen nancy
lisa margaret betty sandra ashley kimberly emily donna michelle carol amanda
daniel matthew anthony mark donald steven paul andrew joshua kenneth kevin
brian george timothy ronald edward jason jeffrey ryan jacob gary nicholas
eric jonathan stephen larry justin scott brandon benjamin samuel gregory
frank alexander raymond patrick jack dennis jerry tyler aaron jose adam
henry nathan douglas zachary peter kyle ethan walter noah jeremy christian
keith roger terry sean austin carl arthur lawrence dylan jesse jordan bryan
emma olivia ava isabella sophia charlotte mia amelia harper evelyn abigail
ella scarlett grace chloe victoria riley aria lily aubrey zoey penelope
lillian addison layla natalie camila hannah brooklyn zoe nora leah savannah
audrey claire eleanor skylar anna caroline maria christopher chad georgia
virginia chelsea sierra india dakota israel francis diana sofia lucas
gabriel julian isaac juan luis carlos miguel antonio angel diego alejandro
""".split())


#: NameDetectUtils.scala:260-262 — honorific tokens (used both for the
#: name decision and for FindHonorific gender detection)
_MALE_HONORIFICS = frozenset({"mr", "mister", "sir"})
_FEMALE_HONORIFICS = frozenset({"ms", "mrs", "miss", "madam"})
_HONORIFICS = _MALE_HONORIFICS | _FEMALE_HONORIFICS


#: tokens that mark a NON-name context (street/geo designators): surnames
#: inside "McDaniel Avenue" / "Phelan Road" must not read as people — the
#: OpenNLP chunker got this from sentence context; measured on the
#: reference's testkit streets/cities/countries in tools/nlp_agreement.py
_NON_NAME_CONTEXT = frozenset(
    """avenue street road lane boulevard blvd drive court plaza terrace
    highway route way circle square expressway freeway parkway alley pike
    city town village county state province republic kingdom united states
    islands island coast bay lake river mount mountains valley beach port
    north south east west upper lower new old fort""".split()
)


def _is_name_token(t: str, names: frozenset, use_model: bool) -> bool:
    """Dictionary OR trained char-model hit (nlp/name_model.py — the
    OpenNLP replacement; the model generalizes to names outside any
    dictionary by character shape)."""
    if t in names or t in _HONORIFICS:
        return True
    if use_model:
        from ..nlp.name_model import is_probable_name

        return is_probable_name(t, threshold=0.7)
    return False


#: all UN-member (plus common observer/territory) country names, tokenized —
#: 'Ecuador' or 'United States' must not read as a person no matter how
#: name-shaped the characters are
_COUNTRY_NAMES = """
afghanistan albania algeria andorra angola antigua barbuda argentina armenia
australia austria azerbaijan bahamas bahrain bangladesh barbados belarus
belgium belize benin bhutan bolivia bosnia herzegovina botswana brazil brunei
bulgaria burkina faso burundi cambodia cameroon canada verde chad chile china
colombia comoros congo costa rica croatia cuba cyprus czechia denmark
djibouti dominica dominican ecuador egypt salvador eritrea estonia eswatini
ethiopia fiji finland france gabon gambia georgia germany ghana greece
grenada guatemala guinea bissau guyana haiti honduras hungary iceland india
indonesia iran iraq ireland israel italy jamaica japan jordan kazakhstan
kenya kiribati korea kosovo kuwait kyrgyzstan laos latvia lebanon lesotho
liberia libya liechtenstein lithuania luxembourg madagascar malawi malaysia
maldives mali malta mauritania mauritius mexico micronesia moldova monaco
mongolia montenegro morocco mozambique myanmar namibia nauru nepal
netherlands zealand nicaragua niger nigeria macedonia norway oman pakistan
palau panama papua paraguay peru philippines poland portugal qatar romania
russia rwanda lucia samoa marino senegal serbia seychelles sierra leone
singapore slovakia slovenia solomon somalia spain lanka sudan suriname
sweden switzerland syria taiwan tajikistan tanzania thailand timor togo
tonga trinidad tobago tunisia turkey turkmenistan tuvalu uganda ukraine
emirates uruguay uzbekistan vanuatu venezuela vietnam yemen zambia zimbabwe
federation swaziland sao tome principe burma zaire czechoslovakia yugoslavia
ivory
""".split()


@_lru_cache(maxsize=1)
def _country_tokens() -> frozenset:
    """Country-name tokens: the authored list above plus the phone plane's
    region → name table (localized spellings like España ride along)."""
    from .phone import DEFAULT_COUNTRY_CODES

    toks = set(_COUNTRY_NAMES)
    for name in DEFAULT_COUNTRY_CODES.values():
        for t in tokenize(name):
            toks.add(t)
    return frozenset(toks)


def _row_is_name(text: str, names: frozenset, use_model: bool) -> bool:
    """Row-level decision: any name token AND no geo/street designator or
    country-name token (context veto — see _NON_NAME_CONTEXT). A token that
    is ALSO a dictionary name never vetoes: 'Jordan Smith' and 'Georgia
    Brown' are people even though Jordan/Georgia are countries (name
    particles like de/la/san were dropped from the veto list for the same
    reason — Hispanic compound surnames must keep their recall)."""
    toks = tokenize(text)
    if not toks:
        return False
    if any(
        (t in _NON_NAME_CONTEXT or t in _country_tokens()) and t not in names
        for t in toks
    ):
        return False
    return any(_is_name_token(t, names, use_model) for t in toks)


class HumanNameDetector(Estimator):
    """Text → NameStats (HumanNameDetector.scala): decides whether a text
    column contains person names (name-token hit-rate >= threshold over
    the data) and emits per-row name stats with FindHonorific gender
    (NameDetectUtils.scala:104-108). The OpenNLP binaries are replaced by
    a dictionary PLUS a trained character-level model
    (nlp/name_model.py) — the model carries names the dictionary misses;
    fixtures in tests/test_nlp_fixture_agreement.py."""

    input_types = (Text,)
    output_type = NameStats

    def __init__(
        self,
        threshold: float = 0.5,
        names: frozenset = _COMMON_NAMES,
        use_model: bool = True,
        uid: str | None = None,
    ):
        super().__init__("humanNameDetector", uid=uid)
        self.threshold = threshold
        self.names = frozenset(n.lower() for n in names)
        self.use_model = use_model

    def get_params(self):
        return {"threshold": self.threshold, "use_model": self.use_model}

    def fit_model(self, dataset) -> "HumanNameDetectorModel":
        col = dataset[self.input_names[0]]
        assert isinstance(col, TextColumn)
        hits = total = 0
        for v in col.values:
            if not v:
                continue
            total += 1
            if _row_is_name(v, self.names, self.use_model):
                hits += 1
        is_name = total > 0 and (hits / total) >= self.threshold
        self.metadata["treatAsName"] = bool(is_name)
        self.metadata["predictedNameProb"] = (hits / total) if total else 0.0
        return HumanNameDetectorModel(
            bool(is_name), self.names, use_model=self.use_model
        )


class HumanNameDetectorModel(Model):
    output_type = NameStats

    def __init__(self, treat_as_name: bool, names: frozenset,
                 use_model: bool = True, uid=None):
        super().__init__("humanNameDetector", uid=uid)
        self.treat_as_name = treat_as_name
        self.names = names
        self.use_model = use_model

    def get_params(self):
        return {"treat_as_name": self.treat_as_name,
                "names": sorted(self.names),
                "use_model": self.use_model}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(params["treat_as_name"], frozenset(params["names"]),
                   params.get("use_model", True))

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        col = cols[0]
        assert isinstance(col, TextColumn)
        out = []
        for v in col.values:
            if not self.treat_as_name or not v:
                out.append({"isName": "false"} if v else {})
                continue
            toks = tokenize(v)
            # same row predicate as fit (context veto included) — fit and
            # transform must agree on what counts as a name row
            is_name = _row_is_name(v, self.names, self.use_model)
            stats = {"isName": "true" if is_name else "false"}
            if is_name:
                first = next(
                    (t for t in toks
                     if _is_name_token(t, self.names, self.use_model)
                     and t not in _HONORIFICS),
                    "",
                )
                if first:
                    stats["firstName"] = first
                # FindHonorific gender (NameDetectUtils.scala:104-108)
                gender = next(
                    (
                        "Male" if t in _MALE_HONORIFICS else "Female"
                        for t in toks
                        if t in _HONORIFICS
                    ),
                    None,
                )
                if gender:
                    stats["gender"] = gender
            out.append(stats)
        return MapColumn(NameStats, out)


class NameEntityRecognizer(Transformer):
    """Text → MultiPickListMap[entity-kind → tokens]
    (NameEntityRecognizer.scala): OpenNLP NER replaced by shape heuristics —
    capitalized token runs become entities, tagged Person when a token is in
    the name dictionary, else Organization/Location by suffix hints."""

    input_types = (Text,)
    output_type = MultiPickListMap

    _ORG_HINTS = ("inc", "corp", "llc", "ltd", "co", "company", "corporation")
    _LOC_HINTS = ("city", "county", "street", "avenue", "lake", "river",
                  "north", "south", "east", "west")
    # capital class matches sentences.py's opener class (A-ZÀ-ÖØ-Þ — the
    # À-Þ range alone would admit × U+00D7) plus Latin-Extended-A capitals
    # (Š, Č, Ł, İ, …) so cs/pl/tr/hr entity runs are detected consistently
    _CAP = "A-ZÀ-ÖØ-Þ" + "".join(
        chr(c) for c in range(0x100, 0x180) if chr(c).isupper()
    )

    def __init__(self, names: frozenset = _COMMON_NAMES,
                 use_model: bool = True, uid: str | None = None):
        super().__init__("nameEntityRecognizer", uid=uid)
        self.names = frozenset(n.lower() for n in names)
        self.use_model = use_model

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        # reference pipeline shape: sentence-split -> tokenize -> find
        # (NameEntityRecognizer.scala with the OpenNLP sentence model —
        # here nlp/sentences.py): a capitalized SENTENCE OPENER is only an
        # entity when the dictionary/char-model recognizes it, which kills
        # the 'every sentence start is a Misc entity' false positives of
        # whole-text capital-run scanning
        from ..nlp.langid import detect
        from ..nlp.sentences import split_sentences

        col = cols[0]
        assert isinstance(col, TextColumn)
        out = []
        for v in col.values:
            if not v:
                out.append({})
                continue
            ents: dict[str, set] = {}
            for sent in split_sentences(v, language=detect(v) or "en"):
                # index of the first non-quote/bracket char: the opener
                # discount must also apply to '"The dog barked."'
                lead = 0
                while lead < len(sent) and sent[lead] in "\"'«“‘([":
                    lead += 1
                for m in re.finditer(
                    rf"[{self._CAP}][\w'-]*(?:\s+(?:(?:van|de|der|den|ter|te|la|del|da|di|von|el)\s+)*[{self._CAP}][\w'-]*)*", sent
                ):
                    toks = m.group(0).split()
                    lows = [t.lower() for t in toks]
                    if (
                        m.start() == lead
                        and len(toks) == 1
                        and not _is_name_token(
                            lows[0], self.names, self.use_model
                        )
                        and lows[0] not in self._ORG_HINTS
                        and lows[0] not in self._LOC_HINTS
                    ):
                        continue  # bare sentence opener, not an entity
                    if any(
                        _is_name_token(t, self.names, self.use_model)
                        for t in lows
                    ):
                        kind = "Person"
                    elif any(t in self._ORG_HINTS for t in lows):
                        kind = "Organization"
                    elif any(t in self._LOC_HINTS for t in lows):
                        kind = "Location"
                    else:
                        kind = "Misc"
                    ents.setdefault(kind, set()).update(lows)
            out.append({k: frozenset(s) for k, s in ents.items()})
        return MapColumn(MultiPickListMap, out)

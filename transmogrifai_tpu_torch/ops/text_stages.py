"""Label indexing: ``OpStringIndexer`` (text label -> RealNN class id by
descending frequency) and its inverse ``OpIndexToString``, the port of the
two stages of the JAX package's ``ops/text_stages.py`` that the multiclass
flow needs (OpStringIndexer{,NoFilter}.scala / OpIndexToString{,NoFilter}
.scala).

Host numpy, as in the reference: labels sort by descending count, ties by
the label's own order; ``handle_invalid`` is ``"keep"`` (an unseen label
maps to the label count), ``"skip"`` (masked, value 0) or ``"error"``.
The rest of that module (tokenizers, TF / IDF, the detectors and
similarities) is ``ROADMAP.md`` A11.
"""
from __future__ import annotations

import numpy as np

from ..featurize.interning import intern_values
from ..stages.base import Estimator, Model, Transformer
from ..types import RealNN, Text
from ..types.columns import Column, NumericColumn, TextColumn


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

"""Small generic transformers: alias, filter, replace, substring, occur,
exists, text length, map filter, the multi-label joiner and its top-N map.

Reference: core/.../stages/impl/feature/{AliasTransformer, FilterTransformer,
ReplaceTransformer, SubstringTransformer, ToOccurTransformer,
ExistsTransformer, TextLenTransformer, FilterMap, MultiLabelJoiner}.scala.
Each is a row-pointwise function lifted to columns, on the host as in
``transmogrifai_tpu/ops/simple.py``. A callable param (a predicate, a match
function, a value filter) is pickled into the saved model
(``utils/serial.py``), so it must be a module-level function.
``TextLenTransformer`` sums each row's token lengths directly: the
reference sums them over its interned token codes, and both are sums of
integers in float64, so they are exact and equal.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from ..featurize.interning import interned_of
from ..stages.base import Transformer
from ..stages.metadata import ColumnMeta, VectorMetadata
from ..types import Binary, OPVector, RealMap, RealNN, Text
from ..types.columns import (
    Column,
    ListColumn,
    MapColumn,
    NumericColumn,
    TextColumn,
    VectorColumn,
    column_from_values,
)
from ..utils.serial import decode_callable, encode_callable


class _IdentityTyped(Transformer):
    """Mixin for stages whose output type IS the input type (alias/filter/
    replace): the reference expresses this as I → I generics."""

    def get_output(self):
        self.output_type = self.input_features[0].ftype
        return super().get_output()


class AliasTransformer(_IdentityTyped):
    """Identity stage that renames its input (AliasTransformer.scala:51)."""

    def __init__(self, name: str, uid: str | None = None):
        super().__init__("alias", uid=uid)
        self.name = name

    def get_params(self):
        return {"name": self.name}

    @property
    def output_name(self) -> str:  # the alias IS the output name
        return self.name

    def transform_columns(self, *cols: Column, num_rows: int) -> Column:
        return cols[0]


class FilterTransformer(_IdentityTyped):
    """Keep values passing a predicate, else a default
    (FilterTransformer.scala:39)."""

    def __init__(
        self,
        predicate: Callable[[Any], bool] | str,
        default: Any = None,
        uid: str | None = None,
    ):
        super().__init__("filter", uid=uid)
        self.predicate = decode_callable(predicate)
        self.default = default

    def get_params(self):
        return {
            "predicate": encode_callable(
                self.predicate, type(self).__name__, "predicate"
            ),
            "default": self.default,
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> Column:
        vals = [
            v if v is not None and self.predicate(v) else self.default
            for v in cols[0].to_list()
        ]
        return column_from_values(cols[0].feature_type, vals)


class ReplaceTransformer(_IdentityTyped):
    """Replace one value with another (ReplaceTransformer.scala:39)."""

    def __init__(self, old_value: Any, new_value: Any, uid: str | None = None):
        super().__init__("replaceValue", uid=uid)
        self.old_value = old_value
        self.new_value = new_value

    def get_params(self):
        return {"old_value": self.old_value, "new_value": self.new_value}

    def transform_columns(self, *cols: Column, num_rows: int) -> Column:
        vals = [
            self.new_value if v == self.old_value else v
            for v in cols[0].to_list()
        ]
        return column_from_values(cols[0].feature_type, vals)


class SubstringTransformer(Transformer):
    """Binary: is input1 a substring of input2 (SubstringTransformer.scala:48).
    Case-insensitive, missing either side → missing."""

    input_types = (Text, Text)
    output_type = Binary

    def __init__(self, uid: str | None = None):
        super().__init__("substring", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        subs, fulls = cols[0].to_list(), cols[1].to_list()
        vals = [
            (s.lower() in f.lower()) if s is not None and f is not None else None
            for s, f in zip(subs, fulls)
        ]
        return column_from_values(Binary, vals)


class ToOccurTransformer(Transformer):
    """Any feature → RealNN 0/1 occurrence (ToOccurTransformer.scala:47).
    Default match: numeric > 0, non-empty text, non-empty collection."""

    output_type = RealNN

    def __init__(
        self,
        match_fn: Callable[[Any], bool] | str | None = None,
        uid: str | None = None,
    ):
        super().__init__("toOccur", uid=uid)
        self.match_fn = decode_callable(match_fn)

    def get_params(self):
        return {
            "match_fn": encode_callable(
                self.match_fn, type(self).__name__, "match_fn"
            )
        }

    def _default_match(self, v: Any) -> bool:
        if v is None:
            return False
        if isinstance(v, bool):
            return v
        if isinstance(v, (int, float)):
            return float(v) > 0.0
        if isinstance(v, str):
            return len(v) > 0
        if isinstance(v, (list, set, frozenset, dict, tuple)):
            return len(v) > 0
        return False

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        fn = self.match_fn or self._default_match
        vals = np.array(
            [1.0 if fn(v) else 0.0 for v in cols[0].to_list()], dtype=np.float64
        )
        return NumericColumn(RealNN, vals, np.ones(num_rows, dtype=bool))


class ExistsTransformer(Transformer):
    """Any feature → Binary non-empty (ExistsTransformer.scala:40)."""

    output_type = Binary

    def __init__(
        self,
        predicate: Callable[[Any], bool] | str | None = None,
        uid: str | None = None,
    ):
        super().__init__("exists", uid=uid)
        self.predicate = decode_callable(predicate)

    def get_params(self):
        return {
            "predicate": encode_callable(
                self.predicate, type(self).__name__, "predicate"
            )
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        pred = self.predicate or (lambda v: v is not None and v != "" and v != [] and v != {} and v != frozenset())
        vals = np.array([bool(pred(v)) for v in cols[0].to_list()], dtype=bool)
        return NumericColumn(Binary, vals, np.ones(num_rows, dtype=bool))


class TextLenTransformer(Transformer):
    """TextList(s) → OPVector of total character lengths
    (TextLenTransformer.scala:45). Sequence stage: N inputs → N columns."""

    output_type = OPVector

    def __init__(self, uid: str | None = None):
        super().__init__("textLen", uid=uid)

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        blocks = []
        metas = []
        for f, col in zip(self.input_features, cols):
            assert isinstance(col, (ListColumn, TextColumn))
            if isinstance(col, ListColumn):
                # the character count of each distinct token once, then
                # one segment sum over the interned CSR layout
                tc = interned_of(col)
                vlen = np.fromiter(map(len, tc.vocab), np.float64, len(tc.vocab))
                csum = np.zeros(tc.num_tokens + 1, dtype=np.float64)
                np.cumsum(vlen[tc.codes], out=csum[1:])
                lens = csum[tc.offsets[1:]] - csum[tc.offsets[:-1]]
            else:
                lens = np.fromiter(
                    (float(len(v)) if v else 0.0 for v in col.values),
                    np.float64, num_rows,
                )
            blocks.append(np.asarray(lens, dtype=np.float32)[:, None])
            metas.append(
                ColumnMeta(
                    parent_names=(f.name,),
                    parent_type=f.ftype.__name__,
                    grouping=f.name,
                    descriptor_value="TextLen",
                    index=len(metas),
                )
            )
        values = np.concatenate(blocks, axis=1)
        meta = VectorMetadata(self.output_name, tuple(metas))
        return VectorColumn(OPVector, values, meta)


class FilterMap(_IdentityTyped):
    """Filter map keys/values by allow/block lists (FilterMap.scala:45)."""

    def __init__(
        self,
        allow_keys: Sequence[str] = (),
        block_keys: Sequence[str] = (),
        value_filter: Callable[[Any], bool] | str | None = None,
        uid: str | None = None,
    ):
        super().__init__("filterMap", uid=uid)
        self.allow_keys = tuple(allow_keys)
        self.block_keys = tuple(block_keys)
        self.value_filter = decode_callable(value_filter)

    def get_params(self):
        return {
            "allow_keys": list(self.allow_keys),
            "block_keys": list(self.block_keys),
            "value_filter": encode_callable(
                self.value_filter, type(self).__name__, "value_filter"
            ),
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        col = cols[0]
        assert isinstance(col, MapColumn)
        allow = set(self.allow_keys)
        block = set(self.block_keys)
        out = []
        for m in col.values:
            kept = {
                k: v
                for k, v in m.items()
                if (not allow or k in allow)
                and k not in block
                and (self.value_filter is None or self.value_filter(v))
            }
            out.append(kept)
        return MapColumn(col.feature_type, out)


class MultiLabelJoiner(Transformer):
    """(RealNN?, OPVector probabilities) → RealMap keyed by label names
    (MultiLabelJoiner.scala:44). Labels default to the probability index."""

    output_type = RealMap

    def __init__(self, labels: Sequence[str] | None = None, uid: str | None = None):
        super().__init__("multiLabelJoiner", uid=uid)
        self.labels = list(labels) if labels is not None else None

    def get_params(self):
        return {"labels": self.labels}

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        probs = cols[-1]
        assert isinstance(probs, VectorColumn)
        arr = np.asarray(probs.values, dtype=np.float64)
        labels = self.labels or [str(i) for i in range(arr.shape[1])]
        out = [
            {lab: float(p) for lab, p in zip(labels, row)} for row in arr
        ]
        return MapColumn(RealMap, out)


class TopNLabelProbMap(Transformer):
    """RealMap → top-N entries by probability (MultiLabelJoiner.scala:67)."""

    input_types = (RealMap,)
    output_type = RealMap

    def __init__(self, top_n: int, uid: str | None = None):
        super().__init__("topNLabelProbMap", uid=uid)
        self.top_n = int(top_n)

    def get_params(self):
        return {"top_n": self.top_n}

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        col = cols[0]
        assert isinstance(col, MapColumn)
        out = []
        for m in col.values:
            top = sorted(m.items(), key=lambda kv: (-kv[1], kv[0]))[: self.top_n]
            out.append(dict(top))
        return MapColumn(RealMap, out)

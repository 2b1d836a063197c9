"""Shared machinery for vectorizer stages: same-typed features are grouped
into one sequence stage whose fit computes per-feature summaries and whose
model emits one block of vector columns per input feature; the blocks
concatenate into the stage's OPVector output with flattened
column-provenance metadata."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..stages.base import Estimator, Model, Transformer
from ..stages.metadata import ColumnMeta, VectorMetadata
from ..types import OPVector
from ..types.columns import Column, VectorColumn


def assemble_values(blocks: Sequence[np.ndarray], num_rows: int) -> np.ndarray:
    """Concatenate per-feature blocks [N, d_i] into one float32 [N, Σd_i]
    plane, converting dtype during the copy."""
    out = np.empty((num_rows, sum(b.shape[1] for b in blocks)), np.float32)
    off = 0
    for b in blocks:
        w = b.shape[1]
        out[:, off:off + w] = b
        off += w
    return out


#: batches above this many rows run ``blocks_for`` over row chunks of this
#: size (it is row-pointwise): each chunk's float64 block temporaries are
#: written into the one float32 output before the next chunk is built
CHUNK_ROWS = 1 << 16


class _Vectorizer:
    """Mixin: ``blocks_for`` gives the per-feature blocks and metas; the
    metadata is fit-static, so it is flattened once and cached against the
    per-block (width, meta count) layout."""

    _meta_cache: tuple | None = None  # (layout key, VectorMetadata)

    def blocks_for(
        self, cols: Sequence[Column], num_rows: int
    ) -> tuple[list[np.ndarray], list[list[ColumnMeta]]]:
        raise NotImplementedError

    def _values_chunked(self, cols: Sequence[Column], num_rows: int):
        """(values [N, D] float32, block layout, metas): ``blocks_for``
        over row chunks, each chunk assembled into its rows of the
        output."""
        values = None
        for a in range(0, num_rows, CHUNK_ROWS):
            b = min(a + CHUNK_ROWS, num_rows)
            rows = slice(a, b)  # take() with a slice gives views
            blocks, metas = self.blocks_for([c.take(rows) for c in cols], b - a)
            if values is None:
                layout = [(blk.shape[1], len(ms)) for blk, ms in zip(blocks, metas)]
                values = np.empty(
                    (num_rows, sum(w for w, _ in layout)), np.float32
                )
            values[a:b] = assemble_values(blocks, b - a)
        return values, layout, metas

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        if num_rows > CHUNK_ROWS:
            values, layout, metas = self._values_chunked(cols, num_rows)
        else:
            blocks, metas = self.blocks_for(cols, num_rows)
            layout = [(b.shape[1], len(ms)) for b, ms in zip(blocks, metas)]
            values = assemble_values(blocks, num_rows)
        layout = tuple(layout)
        cached = self._meta_cache
        if cached is not None and cached[0] == layout:
            metadata = cached[1]
        else:
            metadata = VectorMetadata.flatten(
                self.output_name,
                [VectorMetadata(self.output_name, tuple(m)) for m in metas],
            )
            self._meta_cache = (layout, metadata)
        if values.shape[1] != metadata.size:
            raise ValueError(
                f"{self}: {values.shape[1]} columns but {metadata.size} metas"
            )
        return VectorColumn(OPVector, values, metadata)


class VectorizerModel(_Vectorizer, Model):
    """Base fitted vectorizer."""

    output_type = OPVector


class VectorizerEstimator(Estimator):
    """Base vectorizer estimator: ``fit`` returns a ``VectorizerModel``."""

    output_type = OPVector


class VectorizerTransformer(_Vectorizer, Transformer):
    """Fit-free vectorizer."""

    output_type = OPVector

"""Shared machinery for fitted vectorizer stages: a vectorizer emits one
block of vector columns per input feature; the blocks concatenate into the
stage's OPVector output with flattened column-provenance metadata."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..stages.base import Model, Transformer
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


class _Vectorizer:
    """Mixin: ``blocks_for`` gives the per-feature blocks and metas; the
    metadata is fit-static, so it is flattened once and cached against the
    per-block (width, meta count) layout."""

    _meta_cache: tuple | None = None  # (layout key, VectorMetadata)

    def blocks_for(
        self, cols: Sequence[Column], num_rows: int
    ) -> tuple[list[np.ndarray], list[list[ColumnMeta]]]:
        raise NotImplementedError

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        blocks, metas = self.blocks_for(cols, num_rows)
        layout = tuple((b.shape[1], len(ms)) for b, ms in zip(blocks, metas))
        cached = self._meta_cache
        if cached is not None and cached[0] == layout:
            metadata = cached[1]
        else:
            metadata = VectorMetadata.flatten(
                self.output_name,
                [VectorMetadata(self.output_name, tuple(m)) for m in metas],
            )
            self._meta_cache = (layout, metadata)
        values = assemble_values(blocks, num_rows)
        if values.shape[1] != metadata.size:
            raise ValueError(
                f"{self}: {values.shape[1]} columns but {metadata.size} metas"
            )
        return VectorColumn(OPVector, values, metadata)


class VectorizerModel(_Vectorizer, Model):
    """Base fitted vectorizer."""

    output_type = OPVector


class VectorizerTransformer(_Vectorizer, Transformer):
    """Fit-free vectorizer."""

    output_type = OPVector

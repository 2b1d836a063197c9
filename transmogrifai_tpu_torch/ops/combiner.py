"""VectorsCombiner — concatenate every per-type vector into the single
feature vector fed to the SanityChecker's removal model and the predictor,
flattening metadata. Under a fused batch (``featurize.engine``) the members
already wrote into one buffer, which is returned wholesale; a sparse input
makes the result a SparseMatrix."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..stages.base import Transformer
from ..stages.metadata import VectorMetadata
from ..types import OPVector
from ..types.columns import Column, SparseMatrix, VectorColumn


class VectorsCombiner(Transformer):
    output_type = OPVector

    def __init__(self, uid: str | None = None):
        super().__init__("vecsCombine", uid=uid)
        # (input metadata objects, flattened result): upstream vectorizers
        # cache their metadata, so repeated scoring flattens once
        self._flatten_cache: tuple[tuple, VectorMetadata] | None = None

    def _flatten(self, metas: list[VectorMetadata]) -> VectorMetadata:
        key = tuple(metas)
        cached = self._flatten_cache
        if cached is not None and len(cached[0]) == len(key) and all(
            a is b for a, b in zip(cached[0], key)
        ):
            return cached[1]
        out = VectorMetadata.flatten(self.output_name, metas)
        self._flatten_cache = (key, out)
        return out

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        from ..featurize import engine as _engine

        for c in cols:
            if not isinstance(c, VectorColumn):
                raise TypeError(f"combine expects vectors, got {type(c).__name__}")
        metadata = self._flatten([
            c.metadata if c.metadata is not None else VectorMetadata("anon", ())
            for c in cols
        ])
        # under a fused batch every member wrote its slice of the shared
        # plane buffer: the concatenation already happened
        values = _engine.fused_result(self.uid, cols)
        if values is None:
            values = _concat(cols, num_rows)
        if metadata.size != values.shape[1]:
            metadata = None  # an input without metadata: none for the whole
        return VectorColumn(OPVector, values, metadata)


def _concat(cols: Sequence[VectorColumn], num_rows: int):
    """The members' values side by side: a SparseMatrix when any is sparse
    (dense blocks ride along as COO; consumers densify on their first
    dense touch), else one float32 array."""
    if any(c.is_sparse for c in cols):
        return SparseMatrix.hstack(
            [c.values for c in cols], [c.dim for c in cols], num_rows
        )
    if not cols:
        return np.zeros((num_rows, 0), dtype=np.float32)
    return np.concatenate(
        [np.asarray(c.values, dtype=np.float32) for c in cols], axis=1
    )

"""VectorsCombiner — concatenate every per-type vector into the single
feature vector fed to the SanityChecker's removal model and the predictor,
flattening metadata."""
from __future__ import annotations

import numpy as np

from ..stages.base import Transformer
from ..stages.metadata import VectorMetadata
from ..types import OPVector
from ..types.columns import Column, VectorColumn


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
        for c in cols:
            if not isinstance(c, VectorColumn):
                raise TypeError(f"combine expects vectors, got {type(c).__name__}")
        if cols:
            values = np.concatenate(
                [np.asarray(c.values, dtype=np.float32) for c in cols], axis=1
            )
        else:
            values = np.zeros((num_rows, 0), dtype=np.float32)
        metadata = self._flatten([
            c.metadata if c.metadata is not None else VectorMetadata("anon", ())
            for c in cols
        ])
        if metadata.size != values.shape[1]:
            metadata = None  # an input without metadata: none for the whole
        return VectorColumn(OPVector, values, metadata)

"""Shared machinery for vectorizer stages: same-typed features are grouped
into one sequence stage whose fit computes per-feature summaries and whose
model emits one block of vector columns per input feature; the blocks
concatenate into the stage's OPVector output with flattened
column-provenance metadata.

Execution rides the featurize plane (``featurize/``): a large batch splits
across the featurize pool by row chunk (``blocks_for`` is row-pointwise;
the native kernels release the interpreter lock), and when a fusion sink
is active (``featurize.engine``) the stage's blocks land directly in its
slice of the shared ``[N, total_width]`` plane buffer.
"""
from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np

from ..featurize import engine as _engine
from ..featurize import parallel as _par
from ..featurize import stats as _fstats
from ..stages.base import Estimator, Model, Transformer
from ..stages.metadata import ColumnMeta, VectorMetadata
from ..types import OPVector
from ..types.columns import Column, SparseMatrix, VectorColumn


def _assemble_values(blocks: Sequence) -> Any:
    """One stage's blocks [N, d_i] as one float32 [N, sum d_i] plane, or a
    SparseMatrix when any block is sparse."""
    if any(isinstance(b, SparseMatrix) for b in blocks):
        if len(blocks) == 1:
            return blocks[0]
        return SparseMatrix.hstack(
            blocks, [b.shape[1] for b in blocks], blocks[0].shape[0]
        )
    if len(blocks) == 1:
        # single-buffer stages (smart text) assemble in place: reuse
        return np.ascontiguousarray(blocks[0], dtype=np.float32)
    if not blocks:
        return np.zeros((0, 0), dtype=np.float32)
    # one pass: the dtype conversion happens during the copy into the
    # preallocated output
    out = np.empty(
        (blocks[0].shape[0], sum(b.shape[1] for b in blocks)), np.float32
    )
    off = 0
    for b in blocks:
        w = b.shape[1]
        out[:, off:off + w] = b
        off += w
    return out


def _vstack_values(parts: Sequence) -> Any:
    """Row-wise concat of chunk outputs (dense ndarray or SparseMatrix; a
    mixed set degrades to sparse, values preserved either way)."""
    if len(parts) == 1:
        return parts[0]
    if not any(isinstance(p, SparseMatrix) for p in parts):
        return np.concatenate(parts, axis=0)
    rows_parts, cols_parts, vals_parts = [], [], []
    any_vals = False
    off = 0
    width = parts[0].shape[1]
    for p in parts:
        if not isinstance(p, SparseMatrix):
            p = SparseMatrix.from_dense(p)
        rows_parts.append(p.rows.astype(np.int64) + off)
        cols_parts.append(p.cols)
        vals_parts.append(p.vals)
        any_vals = any_vals or p.vals is not None
        off += p.shape[0]
    vals = None
    if any_vals:
        vals = np.concatenate([
            v if v is not None else np.ones(len(r), dtype=np.float32)
            for v, r in zip(vals_parts, rows_parts)
        ])
    return SparseMatrix(
        np.concatenate(rows_parts).astype(np.int32),
        np.concatenate(cols_parts), (off, width), vals,
    )


class _Vectorizer:
    """Mixin: ``blocks_for`` gives the per-feature blocks and metas; the
    metadata is fit-static, so it is flattened once and cached against the
    per-block (width, meta count) layout."""

    _meta_cache: tuple | None = None  # (layout key, VectorMetadata)

    def blocks_for(
        self, cols: Sequence[Column], num_rows: int
    ) -> tuple[list, list[list[ColumnMeta]]]:
        raise NotImplementedError

    def _blocks_chunked(self, cols: Sequence[Column], num_rows: int):
        """``blocks_for`` over row chunks on the featurize pool, the chunks'
        blocks stacked in row order; one chunk is one direct call."""
        ranges = _par.chunk_ranges(num_rows)
        if len(ranges) == 1:
            return self.blocks_for(cols, num_rows)

        def task(span):
            a, b = span
            return self.blocks_for([_par.slice_rows(c, a, b) for c in cols], b - a)

        parts = _par.run_tasks([lambda s=s: task(s) for s in ranges])
        blocks0, metas = parts[0]
        blocks = [
            _vstack_values([p[0][bi] for p in parts])
            for bi in range(len(blocks0))
        ]
        return blocks, metas

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        t0 = time.perf_counter()
        sink = _engine.current_sink(self.uid)
        if (
            sink is None
            and _par.pool_enabled()
            and num_rows >= 2 * _par.min_chunk_rows()
        ):
            blocks, metas = self._blocks_chunked(cols, num_rows)
        else:
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
        if sink is not None and not any(isinstance(b, SparseMatrix) for b in blocks):
            # fused assembly: the blocks land in this stage's slice of the
            # shared plane buffer, which the combiner returns wholesale
            buf, off, width = sink
            o = off
            for b in blocks:
                w = b.shape[1]
                buf[:, o:o + w] = b
                o += w
            values: Any = buf[:, off:off + width]
        else:
            values = _assemble_values(blocks)
        if values.shape[1] != metadata.size:
            raise ValueError(
                f"{self}: {values.shape[1]} columns but {metadata.size} metas"
            )
        out = VectorColumn(OPVector, values, metadata)
        _engine.note_output(self.uid, out)
        _fstats.stats().record_stage(
            self.operation_name, num_rows, time.perf_counter() - t0,
            getattr(values, "nbytes", 0),
        )
        return out


class VectorizerModel(_Vectorizer, Model):
    """Base fitted vectorizer."""

    output_type = OPVector


class VectorizerEstimator(Estimator):
    """Base vectorizer estimator: ``fit`` returns a ``VectorizerModel``."""

    output_type = OPVector


class VectorizerTransformer(_Vectorizer, Transformer):
    """Fit-free vectorizer."""

    output_type = OPVector

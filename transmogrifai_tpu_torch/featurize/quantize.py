"""Quantized serving planes: the uint8 numeric upload behind
``score_function(model, quantized=True)``, the port of the JAX package's
``featurize/quantize.py``.

A fitted model's numeric columns have fit-time value ranges (the numeric
vectorizers' ``value_ranges``), and a tree predictor bins its input into at
most ``max_bins`` codes anyway. So each numeric value column of the fused
graph's upload can shrink to ONE uint8 code per row, with a per-column
decode table on the device:

* **bin-aligned** (tree predictors): the host encodes each value to its
  exact bin under the predictor's thresholds (the number of thresholds
  strictly below it, in float32), and the decode table holds one
  representative per bin, chosen and checked at build to re-bin to the
  same code on the device: tree predictions stay **equal** to the float32
  plane's;
* **affine** (GLMs, and any column without thresholds): code =
  ``rint((v - lo) / scale)`` over the fit range ``[lo, hi]``, decode =
  ``lo + code * scale``, with the largest reconstruction error (half a
  step) on the per-column ``quantError`` ledger; values outside the range
  clamp, +-Inf to the edges, NaN encodes as ``lo`` (the imputation masks
  it anyway);
* **constant / all-null** columns decode exactly to ``lo``.

Both modes share one decode on the device, a gather from a ``[F, 256]``
float32 reps table (:func:`dequantize`) that is uploaded once with the
program's params: the upload per batch is the codes alone. The host codec
below is the reference's numpy, unchanged, so both packages build the same
plan from the same saved model.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["ColumnQuant", "QuantPlan", "N_CODES", "dequantize"]

#: uint8 code space: one byte per value per row on the wire
N_CODES = 256


@dataclasses.dataclass
class ColumnQuant:
    """One column's code <-> value contract: ``mode`` in {affine, bins,
    constant}, a 256-entry float32 decode table ``reps``, and the encode
    parameters of its mode. ``quant_error`` bounds the absolute
    reconstruction error of in-range values (0.0 where predictions cannot
    move: bins, constant)."""

    mode: str
    lo: float
    hi: float
    scale: float
    reps: np.ndarray
    quant_error: float
    thresholds: np.ndarray | None = None  # sorted float32, bins mode only

    @classmethod
    def affine(cls, lo: float, hi: float) -> "ColumnQuant":
        """Uniform uint8 grid over the fit range [lo, hi]. Non-finite
        edges clamp to a finite span; a degenerate range is a constant
        column (codes all 0, decode exact)."""
        lo = float(np.float32(lo))
        hi = float(np.float32(hi))
        if not np.isfinite(lo):
            lo = 0.0
        if not np.isfinite(hi):
            hi = lo
        if hi <= lo:
            reps = np.full(N_CODES, np.float32(lo))
            return cls("constant", lo, lo, 0.0, reps, 0.0)
        scale = (hi - lo) / (N_CODES - 1)
        reps = (
            np.float32(lo)
            + np.float32(scale) * np.arange(N_CODES, dtype=np.float32)
        ).astype(np.float32)
        # the grid is float32: the realized half step bounds the error
        err = float(np.max(np.diff(reps))) / 2.0
        return cls("affine", lo, hi, float(scale), reps, err)

    @classmethod
    def bins(cls, thresholds: np.ndarray) -> "ColumnQuant | None":
        """Bin-aligned codes for one predictor column: code = thresholds
        strictly below the value (``trees.bin_data``'s float32 compare),
        decode = a representative that re-bins to the same code. None
        where the column cannot be represented (more than 256 bins, or the
        check fails): the caller takes the affine grid."""
        thr = np.asarray(thresholds, dtype=np.float32).ravel()
        finite = np.sort(thr[np.isfinite(thr)])
        n_bins = int(thr.shape[0]) + 1
        if n_bins > N_CODES:
            return None
        reps = np.zeros(N_CODES, dtype=np.float32)
        if finite.size == 0:
            # every value bins to 0 (x > NaN is false on the device)
            return cls("bins", 0.0, 0.0, 0.0, reps, 0.0, finite)
        # bin 0: any value <= the smallest threshold
        reps[0] = finite[0]
        achievable = {0}
        last = reps[0]
        uniq = np.unique(finite)
        for b in range(1, n_bins):
            # bin b is reachable iff some distinct edge d has exactly b
            # thresholds <= d; the next float32 above d then has exactly b
            # thresholds strictly below it
            cand = None
            for d in uniq:
                if int((finite <= d).sum()) == b:
                    cand = np.nextafter(np.float32(d), np.float32(np.inf))
                    break
            if cand is not None:
                achievable.add(b)
                last = np.float32(cand)
            reps[b] = last
        reps[n_bins:] = last
        # every achievable code's representative re-bins to itself
        rebinned = (reps[:n_bins, None] > finite[None, :]).sum(axis=1)
        for b in achievable:
            if int(rebinned[b]) != b:
                return None
        return cls("bins", float(finite[0]), float(finite[-1]), 0.0,
                   reps, 0.0, finite)

    def encode(self, vals: np.ndarray) -> np.ndarray:
        """Host codec: float32 values -> uint8 codes."""
        v = np.asarray(vals, dtype=np.float32)
        if self.mode == "constant":
            return np.zeros(v.shape, dtype=np.uint8)
        if self.mode == "bins":
            thr = self.thresholds
            if thr is None or thr.size == 0:
                return np.zeros(v.shape, dtype=np.uint8)
            # thresholds strictly below = searchsorted-left over the sorted
            # edges; NaN bins to 0 as on the device
            x = np.where(np.isnan(v), np.float32(-np.inf), v)
            return np.searchsorted(thr, x, side="left").astype(np.uint8)
        # affine: NaN -> lo (masked by the imputation); +-Inf clip to the
        # range's edges
        x = np.where(np.isnan(v), np.float32(self.lo), v)
        with np.errstate(invalid="ignore"):
            q = np.rint((x - np.float32(self.lo)) / np.float32(self.scale))
        return np.clip(q, 0, N_CODES - 1).astype(np.uint8)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "mode": self.mode,
            "lo": self.lo,
            "hi": self.hi,
            "scale": self.scale,
            "quantError": self.quant_error,
        }
        if self.thresholds is not None:
            out["thresholds"] = [float(t) for t in self.thresholds]
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ColumnQuant":
        if d["mode"] == "bins":
            got = cls.bins(np.asarray(d.get("thresholds", []), np.float32))
            if got is not None:
                return got
        if d["mode"] == "constant":
            return cls.affine(d["lo"], d["lo"])
        return cls.affine(d["lo"], d["hi"])


class QuantPlan:
    """Per-column quantization of one member's value columns: the encode
    runs in the member's host ingest, the reps table is a program param
    that :func:`dequantize` gathers from on the device."""

    def __init__(self, columns: list[ColumnQuant]):
        self.columns = list(columns)

    def reps_table(self) -> np.ndarray:
        """[F, 256] float32 decode table (uploaded once, with the params)."""
        return np.stack([c.reps for c in self.columns]).astype(np.float32)

    def encode(self, vals: np.ndarray) -> np.ndarray:
        """[N, F] float32 -> [N, F] uint8 (4x fewer bytes on the wire)."""
        out = np.empty(vals.shape, dtype=np.uint8)
        for j, c in enumerate(self.columns):
            out[:, j] = c.encode(vals[:, j])
        return out

    def errors(self) -> list[float]:
        """Per-column largest reconstruction error (the quantError ledger)."""
        return [float(c.quant_error) for c in self.columns]

    def descriptor(self) -> str:
        """The plan's part of the program's fingerprint: the modes alone."""
        tags = {"affine": "a", "bins": "b", "constant": "c"}
        return "q8" + "".join(tags[c.mode] for c in self.columns)

    def to_json(self) -> dict[str, Any]:
        return {"columns": [c.to_json() for c in self.columns]}

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "QuantPlan":
        return cls([ColumnQuant.from_json(c) for c in d["columns"]])


def dequantize(codes: torch.Tensor, reps: torch.Tensor) -> torch.Tensor:
    """The decode on the device: codes [N, F] uint8 and reps [F, 256]
    float32 -> values [N, F] float32, one gather from each column's row of
    the table."""
    col = torch.arange(reps.shape[0], device=reps.device)
    return reps[col[None, :], codes.long()]

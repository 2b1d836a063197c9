"""Streaming histogram — fixed-size mergeable quantile sketch.

Reference: utils/src/main/java/com/salesforce/op/utils/stats/
StreamingHistogram.java:36-269 (one of the reference's two Java files),
implementing the Ben-Haim & Tom-Tov "A Streaming Parallel Decision Tree
Algorithm" (JMLR 2010) histogram: at most ``max_bins`` (centroid, count)
pairs; inserting a point adds a unit bin then merges the closest pair;
histograms merge associatively (the monoid property that lets score
distributions aggregate across shards — used for score/feature
distributions in model insights and drift monitoring).
"""
from __future__ import annotations

import bisect


class StreamingHistogram:
    """Mergeable bounded histogram of (point, count) bins."""

    def __init__(self, max_bins: int = 100):
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        self.max_bins = max_bins
        self._points: list[float] = []
        self._counts: list[float] = []

    # ------------------------------------------------------------ building
    def update(self, value: float, count: float = 1.0) -> "StreamingHistogram":
        """Algorithm 1 (update): insert then shrink-to-capacity."""
        i = bisect.bisect_left(self._points, value)
        if i < len(self._points) and self._points[i] == value:
            self._counts[i] += count
        else:
            self._points.insert(i, float(value))
            self._counts.insert(i, float(count))
            self._shrink()
        return self

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Algorithm 2 (merge): union the bins, shrink to capacity."""
        out = StreamingHistogram(max(self.max_bins, other.max_bins))
        for p, c in sorted(
            list(zip(self._points, self._counts))
            + list(zip(other._points, other._counts))
        ):
            if out._points and out._points[-1] == p:
                out._counts[-1] += c
            else:
                out._points.append(p)
                out._counts.append(c)
        out._shrink()
        return out

    def _shrink(self) -> None:
        while len(self._points) > self.max_bins:
            # merge the closest adjacent pair (weighted centroid)
            gaps = [
                self._points[i + 1] - self._points[i]
                for i in range(len(self._points) - 1)
            ]
            i = min(range(len(gaps)), key=gaps.__getitem__)
            c = self._counts[i] + self._counts[i + 1]
            p = (
                self._points[i] * self._counts[i]
                + self._points[i + 1] * self._counts[i + 1]
            ) / c
            self._points[i : i + 2] = [p]
            self._counts[i : i + 2] = [c]

    # ------------------------------------------------------------- queries
    @property
    def bins(self) -> list[tuple[float, float]]:
        return list(zip(self._points, self._counts))

    @property
    def total_count(self) -> float:
        return sum(self._counts)

    def sum_at(self, b: float) -> float:
        """Algorithm 3 (sum): estimated number of points <= b via the
        trapezoid interpolation between surrounding centroids."""
        pts, cts = self._points, self._counts
        if not pts:
            return 0.0
        if b < pts[0]:
            return 0.0
        if b >= pts[-1]:
            return self.total_count
        i = bisect.bisect_right(pts, b) - 1
        p_i, p_j = pts[i], pts[i + 1]
        m_i, m_j = cts[i], cts[i + 1]
        # fraction of the (i, i+1) trapezoid left of b
        frac = (b - p_i) / (p_j - p_i)
        m_b = m_i + (m_j - m_i) * frac
        s = (m_i + m_b) * frac / 2.0
        return sum(cts[:i]) + m_i / 2.0 + s

    def quantile(self, q: float) -> float:
        """Inverse of sum_at by bisection over the centroid span."""
        if not self._points:
            raise ValueError("empty histogram")
        if len(self._points) == 1:
            return self._points[0]
        target = q * self.total_count
        lo, hi = self._points[0], self._points[-1]
        for _ in range(60):
            mid = (lo + hi) / 2.0
            if self.sum_at(mid) < target:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2.0

    def density(self) -> list[tuple[float, float]]:
        """Normalized (point, mass) pairs."""
        total = self.total_count
        if total == 0:
            return []
        return [(p, c / total) for p, c in zip(self._points, self._counts)]

    def to_json(self) -> dict:
        return {
            "maxBins": self.max_bins,
            "points": list(self._points),
            "counts": list(self._counts),
        }

    @classmethod
    def from_json(cls, data: dict) -> "StreamingHistogram":
        h = cls(data["maxBins"])
        h._points = [float(p) for p in data["points"]]
        h._counts = [float(c) for c in data["counts"]]
        return h


def histogram_from_values(values, max_bins: int = 64) -> StreamingHistogram:
    """Bulk-build a StreamingHistogram from an array of values.

    Exact (unique values + counts) when the data has at most ``max_bins``
    distinct values; otherwise one vectorized equal-width pre-bin whose
    centroids/counts seed the sketch — O(n) numpy work instead of n Python
    ``update`` calls, which matters when Workflow.train profiles every raw
    feature of a large training set."""
    import numpy as np

    h = StreamingHistogram(max_bins)
    vals = np.asarray(values, dtype=np.float64)
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return h
    uniq, counts = np.unique(vals, return_counts=True)
    if len(uniq) > max_bins:
        # equal-width pre-bin straight to capacity, mass-weighted centers —
        # one vectorized np.histogram instead of n python merges (the
        # serving drift window feeds whole batch columns through here)
        counts, edges = np.histogram(vals, bins=max_bins)
        sums, _ = np.histogram(vals, bins=edges, weights=vals)
        keep = counts > 0
        counts = counts[keep]
        uniq = sums[keep] / counts  # centroid of each bin's actual mass
    h._points = [float(p) for p in uniq]
    h._counts = [float(c) for c in counts]
    return h

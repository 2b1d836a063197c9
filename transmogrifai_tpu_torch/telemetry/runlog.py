"""The run ledger's transfer census and the cross-run diff.

* :class:`RunStats`, a process-wide :class:`~.metrics.LedgerCore` ledger
  (the ``run`` registry source) counting the host<->device copies of
  scoring at run time. The fused scoring graph records its one upload and
  its one download a batch here, with the bytes it already counts
  (``compiler/fused.py``).
* :func:`load_run_report` / :func:`validate_run_report` and
  :func:`diff_runs` / :class:`RegressionSentinel`: the cross-run
  comparison flagging per-phase slowdowns (TPR001), compile-count
  blowups (TPR002), transfer-bytes growth (TPR003) and quality drops
  (TPR004) beyond :class:`RunTolerances`, emitting a ``run_regression``
  event. The model registry's canary gate diffs its two sides through
  them (``serving/registry.py``).

The run recorder, ``build_report``, the report files a train writes and
the device-memory polling are not ported yet (``ROADMAP.md`` A12).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from . import events as _tevents
from . import metrics as _tm

#: the schema version of a run report's ``run`` payload
RUN_SCHEMA_VERSION = 1

_COUNTER_KEYS = (
    "h2dTransfers",     # host->device uploads through the dispatch seam
    "h2dBytes",         # bytes those uploads moved
    "d2hTransfers",     # device->host downloads at the scoring render seam
    "d2hBytes",         # bytes those downloads moved
    "runsRecorded",     # finalized RunReports this process
    "layersTimed",      # DAG-layer boundary pulses
    "foldsTimed",       # CV-fold boundary pulses
    "candidatesTimed",  # candidate-sweep timings (selector + workflow CV)
    "summaryDegraded",  # summary_pretty sections that failed and degraded
    "runRegressions",   # findings emitted by diff_runs/RegressionSentinel
)


class RunStats(_tm.LedgerCore):
    """Thread-safe counters; upload/download seconds ride along as
    floats. Shares the registry's re-entrant lock with the other ledgers,
    so a ``telemetry.snapshot_lock()`` read is consistent across all."""

    def __init__(self) -> None:
        super().__init__(_COUNTER_KEYS)
        self._h2d_s = 0.0
        self._d2h_s = 0.0

    # ------------------------------------------------------------ recording
    def record_upload(self, nbytes: int, seconds: float = 0.0) -> None:
        with self._lock:
            self._counts["h2dTransfers"] += 1
            self._counts["h2dBytes"] += int(nbytes)
            self._h2d_s += seconds

    def record_download(self, nbytes: int, seconds: float = 0.0) -> None:
        with self._lock:
            self._counts["d2hTransfers"] += 1
            self._counts["d2hBytes"] += int(nbytes)
            self._d2h_s += seconds

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> dict:
        with self._lock:
            out: dict = dict(self._counts)
            out["h2dSeconds"] = round(self._h2d_s, 4)
            out["d2hSeconds"] = round(self._d2h_s, 4)
        return out

    def reset(self) -> None:
        with self._lock:
            self._reset_counts()
            self._h2d_s = 0.0
            self._d2h_s = 0.0


_STATS = RunStats()
_tm.REGISTRY.register_source("run", _STATS.snapshot)


def stats() -> RunStats:
    return _STATS


def snapshot() -> dict:
    return _STATS.snapshot()


def delta(before: dict) -> dict:
    """Per-run view: current snapshot minus an earlier ``snapshot()``."""
    now = _STATS.snapshot()
    out: dict = _tm.counter_delta(now, before, _COUNTER_KEYS)
    for k in ("h2dSeconds", "d2hSeconds"):
        out[k] = _tm.float_delta(now, before, k, ndigits=4)
    return out


def record_upload(nbytes: int, seconds: float = 0.0) -> None:
    """One host→device upload through the dispatch seam (prefetch_f32 /
    device_f32's fresh-upload path)."""
    _STATS.record_upload(nbytes, seconds)


def record_download(nbytes: int, seconds: float = 0.0) -> None:
    """One device→host download at a scoring render point."""
    _STATS.record_download(nbytes, seconds)


# ---------------------------------------------------------- run reports
def load_run_report(path: str) -> dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    problems = validate_run_report(doc)
    if problems:
        raise ValueError(f"{path}: not a valid run report: {problems}")
    return doc



def validate_run_report(doc: Any) -> list[str]:
    """Problems with a run report (empty list = valid). Checks both the
    unified bench envelope and the nested ``run`` payload this module
    owns."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return [f"not a JSON object: {type(doc).__name__}"]
    if doc.get("schema_version") != 1:
        problems.append(f"bad schema_version {doc.get('schema_version')!r}")
    if doc.get("metric") != "train_run_wallclock":
        problems.append(f"bad metric {doc.get('metric')!r}")
    if not isinstance(doc.get("metrics"), dict):
        problems.append("missing 'metrics' map")
    run = doc.get("run")
    if not isinstance(run, dict):
        return problems + ["missing 'run' payload"]
    if run.get("schemaVersion") != RUN_SCHEMA_VERSION:
        problems.append(f"bad run.schemaVersion {run.get('schemaVersion')!r}")
    for key, types in (
        ("runId", str), ("wallSeconds", (int, float)), ("phases", dict),
        ("layers", list), ("transferCensus", dict), ("deviceMemory", dict),
        ("compileStats", dict), ("featurizeStats", dict),
    ):
        if not isinstance(run.get(key), types):
            problems.append(f"run.{key} missing or invalid")
    census = run.get("transferCensus")
    if isinstance(census, dict):
        for side in ("hostToDevice", "deviceToHost"):
            cell = census.get(side)
            if not isinstance(cell, dict) or not all(
                isinstance(cell.get(k), (int, float))
                for k in ("count", "bytes", "seconds")
            ):
                problems.append(f"run.transferCensus.{side} invalid")
    # out-of-core ingest block: additive, validated WHEN PRESENT
    stream = run.get("stream")
    if stream is not None:
        if not isinstance(stream, dict):
            problems.append("run.stream not a map")
        else:
            for key in ("chunksFolded", "rowsSeen", "quarantinedTotal"):
                if not isinstance(stream.get(key), int):
                    problems.append(f"run.stream.{key} missing or invalid")
    return problems


# --------------------------------------------------------------- run diffing
@dataclasses.dataclass
class RunTolerances:
    """Regression thresholds for :func:`diff_runs`. Ratios compare
    current/baseline; the absolute floors keep noise on tiny runs (a
    40 ms ingest doubling to 80 ms) from crying wolf."""

    phase_slowdown_ratio: float = 1.5
    phase_min_seconds: float = 0.25
    compile_blowup_ratio: float = 1.5
    compile_blowup_abs: int = 2
    transfer_growth_ratio: float = 1.5
    transfer_min_bytes: int = 1 << 20
    quality_drop: float = 0.02


#: quality-metric names (substring match) where LOWER is better — a drop
#: in these is an improvement, a rise a regression
_LOWER_IS_BETTER = ("rmse", "mse", "mae", "loss", "error", "brier")


def _quality_regressed(name: str, base: float, cur: float, tol: float) -> bool:
    lower_better = any(s in name.lower() for s in _LOWER_IS_BETTER)
    return (cur - base > tol) if lower_better else (base - cur > tol)


def _census_bytes(run: dict[str, Any]) -> int:
    c = run.get("transferCensus") or {}
    return int(
        (c.get("hostToDevice") or {}).get("bytes", 0)
        + (c.get("deviceToHost") or {}).get("bytes", 0)
    )


def diff_runs(
    baseline: dict[str, Any] | str,
    current: dict[str, Any] | str,
    tolerances: RunTolerances | None = None,
    emit_events: bool = True,
):
    """Compare two run reports; returns an
    :class:`~..analysis.findings.Report` whose findings are the
    TPR-coded regressions (per-phase slowdown TPR001, compile-count
    blowup TPR002, transfer-bytes growth TPR003, quality drop TPR004 —
    all WARNING severity: nothing is refused, the verdict is evidence).
    Each regression bumps the run ledger and, with ``emit_events``, lands
    one ``run_regression`` event in the structured log."""
    from ..analysis.findings import Report, Severity

    tol = tolerances or RunTolerances()
    base_doc = load_run_report(baseline) if isinstance(baseline, str) else baseline
    cur_doc = load_run_report(current) if isinstance(current, str) else current
    base = base_doc.get("run") or {}
    cur = cur_doc.get("run") or {}
    report = Report()

    # ---- TPR001: per-phase slowdowns
    base_phases = base.get("phases") or {}
    for name, cell in (cur.get("phases") or {}).items():
        b = base_phases.get(name)
        if b is None:
            continue
        bs, cs = float(b.get("seconds", 0.0)), float(cell.get("seconds", 0.0))
        # a zero-cost baseline phase growing real seconds is a slowdown
        # too (also the injectable-clock regime, where clean timings are
        # exactly zero and only simulated chaos seconds register)
        if cs > tol.phase_min_seconds and (
            bs <= 0.0 or cs > bs * tol.phase_slowdown_ratio
        ):
            ratio_s = f"{cs / bs:.2f}x" if bs > 0 else "from zero"
            report.add(
                "TPR001",
                f"phase '{name}' slowed {ratio_s} between runs "
                f"({bs:.3f}s -> {cs:.3f}s, tolerance "
                f"{tol.phase_slowdown_ratio:.2f}x)",
                subject=name,
                severity=Severity.WARNING,
                baselineSeconds=bs,
                currentSeconds=cs,
            )

    # ---- TPR002: compile-count blowups
    bc = int((base.get("compileStats") or {}).get("programsCompiled", 0))
    cc = int((cur.get("compileStats") or {}).get("programsCompiled", 0))
    if cc > max(bc * tol.compile_blowup_ratio, bc + tol.compile_blowup_abs):
        report.add(
            "TPR002",
            f"programs compiled blew up {bc} -> {cc} between runs — a "
            "cache/bucketing regression",
            subject="programsCompiled",
            severity=Severity.WARNING,
            baseline=bc,
            current=cc,
        )

    # ---- TPR003: transfer-bytes growth
    bb, cb = _census_bytes(base), _census_bytes(cur)
    if cb > tol.transfer_min_bytes and cb > max(
        bb * tol.transfer_growth_ratio, bb + tol.transfer_min_bytes
    ):
        report.add(
            "TPR003",
            f"host<->device transfer volume grew {bb} -> {cb} bytes "
            "between runs — a new boundary crossing in the hot path",
            subject="transferCensus",
            severity=Severity.WARNING,
            baselineBytes=bb,
            currentBytes=cb,
        )

    # ---- TPR004: quality drops
    base_q = base.get("quality") or {}
    for name, cv in (cur.get("quality") or {}).items():
        bv = base_q.get(name)
        if not isinstance(bv, (int, float)) or not isinstance(cv, (int, float)):
            continue
        if _quality_regressed(name, float(bv), float(cv), tol.quality_drop):
            report.add(
                "TPR004",
                f"quality metric '{name}' regressed {bv} -> {cv} "
                f"(tolerance {tol.quality_drop})",
                subject=name,
                severity=Severity.WARNING,
                baseline=float(bv),
                current=float(cv),
            )

    report.data["runDiff"] = {
        "baselineRunId": base.get("runId"),
        "currentRunId": cur.get("runId"),
        "baselineWallSeconds": base.get("wallSeconds"),
        "currentWallSeconds": cur.get("wallSeconds"),
        "regressions": len(report),
    }
    if report.findings:
        _STATS.bump("runRegressions", len(report.findings))
        if emit_events:
            _tevents.emit(
                "run_regression",
                baselineRunId=base.get("runId"),
                currentRunId=cur.get("runId"),
                codes=sorted({f.code for f in report.findings}),
                findings=len(report.findings),
            )
    return report


class RegressionSentinel:
    """Standing cross-run regression check: pin a baseline report (dict
    or path) and :meth:`check` each new run against it."""

    def __init__(
        self,
        baseline: dict[str, Any] | str,
        tolerances: RunTolerances | None = None,
    ):
        self.baseline = (
            load_run_report(baseline) if isinstance(baseline, str) else baseline
        )
        self.tolerances = tolerances or RunTolerances()

    def check(self, current: dict[str, Any] | str):
        """Diff ``current`` against the pinned baseline; returns the
        findings Report (``.ok`` is True — regressions are warnings — so
        callers gate on ``len(report)``)."""
        return diff_runs(self.baseline, current, self.tolerances)

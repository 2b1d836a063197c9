"""Finding/Report core of the analysis plane: the data types only.

Every rule of an analyser emits a TP-coded :class:`Finding` through one
shared :class:`Report`. The port has one such emitter so far, the
cross-run regression sentinel (``telemetry/runlog.py`` ``diff_runs``, the
``TPR`` codes), which the model registry's canary gate reads. The other
analysers' codes (``TPA``, ``TPX``, ``TPL``, ``TPJ``, ``TPS``, ``TPC``)
come with their analysers, as do the comment-directive parser and the
lint directives (``ROADMAP.md`` A14).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Iterable, Iterator

__all__ = ["CODES", "Finding", "PreflightError", "Report", "Severity"]


class Severity(enum.Enum):
    ERROR = "error"      # refuses train()/CI — the DAG/plan/code is wrong
    WARNING = "warning"  # suspicious but runnable; CI fails only on NEW ones
    INFO = "info"        # census/ledger data riding the report

    def __str__(self) -> str:  # noqa: D105
        return self.value


#: registry of every code an emitter of the port may use; a Finding with
#: any other code is refused
CODES: dict[str, str] = {
    # ---- TPR: cross-run regression sentinel (telemetry/runlog.py)
    "TPR001": "training phase slowed beyond tolerance between runs",
    "TPR002": "compiled-program count blew up between runs",
    "TPR003": "host<->device transfer volume grew beyond tolerance "
              "between runs",
    "TPR004": "quality metric dropped beyond tolerance between runs",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One TP-coded diagnostic.

    ``subject`` names what the finding is about (a stage uid, feature name
    or ``path:line``); ``detail`` carries structured context for JSON
    surfaces (never required for rendering)."""

    code: str
    message: str
    subject: str = ""
    severity: Severity = Severity.ERROR
    detail: dict[str, Any] = dataclasses.field(default_factory=dict, hash=False)

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unregistered analyser code {self.code!r}")

    def render(self) -> str:
        where = f" [{self.subject}]" if self.subject else ""
        return f"{self.code} {self.severity}: {self.message}{where}"

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "code": self.code,
            "severity": str(self.severity),
            "message": self.message,
            "subject": self.subject,
        }
        if self.detail:
            out["detail"] = self.detail
        return out


class PreflightError(ValueError):
    """A report with ERROR findings was asked to refuse; carries the full
    :class:`Report` for programmatic access."""

    def __init__(self, report: "Report"):
        self.report = report
        errors = report.errors()
        lines = [f.render() for f in errors]
        super().__init__(
            f"static analysis found {len(errors)} error(s):\n  "
            + "\n  ".join(lines)
        )


class Report:
    """An ordered collection of findings plus analyser attachments
    (``data`` — e.g. the run diff's summary)."""

    def __init__(self, findings: Iterable[Finding] = ()) -> None:
        self.findings: list[Finding] = list(findings)
        self.data: dict[str, Any] = {}

    # ------------------------------------------------------------ building
    def add(
        self,
        code: str,
        message: str,
        subject: str = "",
        severity: Severity = Severity.ERROR,
        **detail: Any,
    ) -> Finding:
        f = Finding(code, message, subject, severity, detail)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.data.update(other.data)
        return self

    # ------------------------------------------------------------- queries
    def __iter__(self) -> Iterator[Finding]:
        return iter(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity is Severity.ERROR]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity is Severity.WARNING]

    def by_code(self, code: str) -> list[Finding]:
        return [f for f in self.findings if f.code == code]

    @property
    def ok(self) -> bool:
        """True when no ERROR findings (warnings/info don't refuse)."""
        return not self.errors()

    def raise_if_errors(self) -> "Report":
        if not self.ok:
            raise PreflightError(self)
        return self

    # ----------------------------------------------------------- rendering
    def pretty(self) -> str:
        if not self.findings:
            return "no findings"
        return "\n".join(f.render() for f in self.findings)

    def summary_line(self) -> str:
        """One line for ``summary_pretty()``: counts + distinct codes."""
        codes: dict[str, int] = {}
        for f in self.findings:
            codes[f.code] = codes.get(f.code, 0) + 1
        code_s = ", ".join(
            f"{c}×{n}" if n > 1 else c for c, n in sorted(codes.items())
        )
        return (
            f"Static analysis: {len(self.errors())} error(s), "
            f"{len(self.warnings())} warning(s)"
            + (f" ({code_s})" if code_s else "")
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "findings": [f.to_json() for f in self.findings],
            "errors": len(self.errors()),
            "warnings": len(self.warnings()),
            **self.data,
        }

"""Findings and reports of the port's auditors (a copy of
``repro.analysis.report``, which is pure Python).

A ``Finding`` is one violated (or noteworthy) contract: which check fired,
where (program + kernel or ``file:line``), and what to do about it.  A
``Report`` collects findings across programs, applies waivers, and renders
the CLI / CI artifact output.

Waivers: ``--waive CHECK`` (or ``Report(waive={...})``) downgrades every
finding of that check to a warning — the run still prints it but exits 0.
Use them to land a known regression consciously, never silently.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    check: str                    # e.g. "collectives.data-axis-gather"
    severity: str                 # "error" | "warning" | "info"
    message: str                  # actionable: names the op and the fix
    program: Optional[str] = None    # RoundProgramSpec.name
    location: Optional[str] = None   # kernel name or file:line
    waived: bool = False

    def render(self) -> str:
        tag = {"error": "FAIL", "warning": "warn", "info": "info"}[
            self.severity]
        if self.waived:
            tag = "waived"
        where = " @ ".join(x for x in (self.program, self.location) if x)
        head = f"[{tag}] {self.check}" + (f" ({where})" if where else "")
        return f"{head}\n    {self.message}"


class Report:
    """Collects findings; a report passes iff it has no un-waived errors."""

    def __init__(self, waive: Iterable[str] = ()):
        self.findings: List[Finding] = []
        self.waive = set(waive)
        self.artifacts: Dict[str, Any] = {}   # per-check JSON payloads

    def add(self, check: str, message: str, *, severity: str = "error",
            program: Optional[str] = None,
            location: Optional[str] = None) -> Finding:
        if severity not in SEVERITIES:
            raise ValueError(f"severity {severity!r} not in {SEVERITIES}")
        waived = check in self.waive or check.split(".")[0] in self.waive
        f = Finding(check=check, severity=severity, message=message,
                    program=program, location=location, waived=waived)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.artifacts.update(other.artifacts)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity == "error" and not f.waived]

    def ok(self) -> bool:
        return not self.errors

    def render(self, *, verbose: bool = False) -> str:
        lines = []
        for f in self.findings:
            if f.severity == "info" and not verbose:
                continue
            lines.append(f.render())
        n_err = len(self.errors)
        n_warn = sum(1 for f in self.findings
                     if f.severity == "warning" or f.waived)
        lines.append(f"{'FAIL' if n_err else 'OK'}: "
                     f"{n_err} error(s), {n_warn} warning(s), "
                     f"{len(self.findings)} finding(s) total")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"ok": self.ok(),
                "findings": [dataclasses.asdict(f) for f in self.findings],
                "artifacts": self.artifacts}

    def dump_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")

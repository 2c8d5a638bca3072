"""Finding/rule plumbing for `repro_torch.analysis` (acclint, DESIGN.md §16).

Port of `repro.analysis.findings`. A finding is one violation of one rule
at one anchor: file:line for AST rules, an entry-point pseudo-path such as
`trace:bfs/batched_pull` for the engine-step rules, `combiner:min/vote` for
the algebra probes. The committed baseline file
(`src/repro_torch/analysis/baseline.json`) suppresses known findings by
(rule, path) with a mandatory human-written reason, so the gate starts
green and ratchets: new findings fail, baselined ones are reported but
don't, and stale suppressions are surfaced for deletion. The format is the
reference's, so each package's loader reads the other's file.

The rule set is the reference's less ACC-J101 (the deadlock rule): the
port's mesh is single-controller (`repro_torch.mesh` runs its collectives
as host functions), so no device-side barrier exists to deadlock.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable, Optional

#: the port's committed suppression file, found relative to the package
BASELINE_PATH = str(Path(__file__).resolve().parent / "baseline.json")

#: rule catalog: id -> one-line contract statement (long form: DESIGN.md §16)
RULES = {
    # -- trace backend (engine steps on the card) ---------------------------
    "ACC-J102": (
        "device->host sync or pageable host->device copy inside an engine "
        "step, found by one run under torch.cuda.set_sync_debug_mode('error') "
        "(telemetry-off paths must be transfer-free, §12)"),
    "ACC-J103": (
        "engine step failed CUDA-graph capture, or its replay differs bit "
        "for bit from an eager step (streaming static-shape discipline, §8)"),
    # -- AST / convention backend -------------------------------------------
    "ACC-A201": (
        "program-name string dispatch (`<x>.name == '<algo>'`) — serving "
        "layers must dispatch on declared program metadata (§15)"),
    "ACC-A202": (
        "unordered scatter accumulation (`np.<ufunc>.at`, `index_add(_)`, "
        "`scatter_add(_)`, `index_put(_)(accumulate=True)`, "
        "`scatter_reduce(_)`/`index_reduce(_)` with sum/mean/prod) in core/ "
        "or streaming/ — association order must be pinned (a stable sort, "
        "then a segment reduce; the PR 9 residual-flake mechanism class)"),
    "ACC-A203": (
        "direct device->host read (`.item()` / `.tolist()` / `.cpu()` / "
        "`.numpy()` / `.to('cpu')` / `torch.cuda.synchronize`) outside the "
        "`obs` chokepoint (`device_fetch`, `host_flags`, `host_copy`; §12 "
        "TRANSFER_COUNT and HOST_READS accounting)"),
    "ACC-M301": (
        "registered ACC program missing required metadata (declared "
        "'result'; residual block incl. with_tol where kind='residual'; "
        "'resume_fields' where an incremental contract is declared, §15)"),
    # -- combiner algebra backend -------------------------------------------
    "ACC-C401": (
        "combiner violates the monoid laws (identity / associativity / "
        "commutativity) its segment combine and cache keys rely on"),
    "ACC-C402": (
        "combiner idempotency declaration mismatch (declared idempotent "
        "but pair(a,a) != a, or 'vote' kind on a non-idempotent monoid)"),
    "ACC-C403": (
        "combiner segment/pairwise/tree reductions disagree (the pinned "
        "reduction-tree doctrine behind batched bit-identity, §7/§9)"),
}

#: the rules that need a CUDA device (the trace backend)
CUDA_RULES = frozenset({"ACC-J102", "ACC-J103"})


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str        # file path, or pseudo-path (trace:<entry>, combiner:<name>)
    line: int        # 1-based; 0 when not anchored to a source line
    message: str

    def anchor(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


# ---------------------------------------------------------------------------
# baseline / suppression file
# ---------------------------------------------------------------------------


def load_baseline(path: Optional[str]) -> list[dict]:
    """Parse the suppression file. Each entry must carry rule, path and a
    non-empty reason; malformed entries raise (the gate must not silently
    widen)."""
    if path is None:
        return []
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return []
    entries = doc.get("suppressions", [])
    out = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or not e.get("rule") or not e.get("path") \
                or not str(e.get("reason", "")).strip():
            raise ValueError(
                f"{path}: suppression #{i} must be an object with non-empty "
                f"'rule', 'path' and 'reason' fields, got {e!r}")
        if e["rule"] not in RULES:
            raise ValueError(
                f"{path}: suppression #{i} names unknown rule {e['rule']!r}")
        out.append(e)
    return out


def apply_baseline(findings: Iterable[Finding], baseline: list[dict]):
    """Split findings into (active, suppressed) and report stale suppression
    entries (matched nothing — delete them)."""
    active: list[Finding] = []
    suppressed: list[Finding] = []
    hits = [0] * len(baseline)
    for f in findings:
        idx = next((i for i, e in enumerate(baseline)
                    if e["rule"] == f.rule and e["path"] == f.path), None)
        if idx is None:
            active.append(f)
        else:
            hits[idx] += 1
            suppressed.append(f)
    stale = [e for e, h in zip(baseline, hits) if h == 0]
    return active, suppressed, stale


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def render(active: list[Finding], suppressed: list[Finding],
           stale: list[dict], checked: dict) -> str:
    lines = []
    for scope, n in sorted(checked.items()):
        lines.append(f"[acclint] checked {scope}: {n}")
    for f in sorted(active, key=lambda f: (f.rule, f.path, f.line)):
        lines.append(f"[acclint] {f.rule} {f.anchor()}: {f.message}")
    if suppressed:
        lines.append(f"[acclint] {len(suppressed)} finding(s) suppressed by "
                     "baseline")
    for e in stale:
        lines.append(f"[acclint] WARNING stale suppression (matched "
                     f"nothing, delete it): {e['rule']} {e['path']}")
    verdict = ("OK" if not active
               else f"{len(active)} non-baselined finding(s)")
    lines.append(f"[acclint] {verdict}")
    return "\n".join(lines)


def to_json(active: list[Finding], suppressed: list[Finding],
            stale: list[dict], checked: dict) -> dict:
    return {
        "tool": "acclint",
        "rules": dict(RULES),
        "checked": checked,
        "findings": [f.to_dict() for f in active],
        "suppressed": [f.to_dict() for f in suppressed],
        "stale_suppressions": stale,
        "ok": not active,
    }

"""Metadata backend: ACC-M301 — every registered program must declare the
metadata the serving/streaming layers dispatch on (DESIGN.md §15/§16).

Port of `repro.analysis.meta_check`, over the port's catalog
(`repro_torch.launch.catalog.make_catalog`) and its
`streaming.incremental.resume_fields`.

The catalog is served purely on declared metadata: the result field a pool
caches, the residual block the SLO degrader and the Maiter correction
read, the incremental contract the streaming refresh routes on. A program
missing a declaration doesn't fail loudly — it silently falls into a
weaker regime (full recompute, primary-field serving), which is exactly
the kind of drift a linter should catch.
"""

from __future__ import annotations

from typing import Optional

from .findings import Finding

#: residual programs must declare the whole refresh-math block
RESIDUAL_KEYS = ("estimate", "residual", "tol", "damping", "settle",
                 "threshold")
THRESHOLD_RULES = ("degree", "absolute")
INCREMENTAL_CONTRACTS = ("cascade", "reelect")


def check_program(name: str, program) -> list[Finding]:
    from repro_torch.streaming.incremental import resume_fields

    path = f"catalog:{name}"
    out: list[Finding] = []

    def flag(msg: str) -> None:
        out.append(Finding("ACC-M301", path, 0, msg))

    if program.param("result") is None:
        flag("no declared 'result' field — pools would silently serve the "
             "push-plane primary "
             f"({program.primary!r}); declare ('result', <field>) even when "
             "they coincide")
    comb = program.combiner
    if comb.kind not in ("vote", "aggregation"):
        flag(f"combiner kind {comb.kind!r} is not 'vote'|'aggregation'")
    if comb.kind == "vote" and not comb.idempotent:
        flag(f"'vote' combiner {comb.name!r} is not idempotent — frontier "
             "duplicates would double-apply (vote semantics, paper §3.2)")

    kind = program.param("kind")
    if kind == "residual":
        missing = [k for k in RESIDUAL_KEYS if program.param(k) is None]
        if missing:
            flag(f"residual program missing declared {missing} — the "
                 "streaming residual correction and SLO degrader read "
                 "these (DESIGN.md §15)")
        thr = program.param("threshold")
        if thr is not None and thr not in THRESHOLD_RULES:
            flag(f"threshold rule {thr!r} not in {THRESHOLD_RULES}")
        if program.with_tol is None:
            flag("residual program without `with_tol` — SLO degradation "
                 "(`serving.slo.degraded_variant`) cannot loosen it "
                 "without name dispatch")
    elif kind is not None:
        flag(f"unknown program kind {kind!r} (only 'residual' is defined)")

    inc = program.param("incremental")
    if inc is not None:
        if inc not in INCREMENTAL_CONTRACTS:
            flag(f"incremental contract {inc!r} not in "
                 f"{INCREMENTAL_CONTRACTS}")
        elif not tuple(program.param("resume_fields", ())):
            flag(f"'{inc}' program without 'resume_fields' — the serving "
                 "cache cannot refresh entries in place (streaming resume, "
                 "DESIGN.md §15)")

    # the declared planes must exist in the schema the cache stores
    try:
        fields = resume_fields(program)
    except Exception as e:                              # noqa: BLE001
        flag(f"resume_fields() raised {type(e).__name__}: {e}")
        fields = ()
    if kind == "residual" and len(fields) < 2:
        flag("residual program's resume_fields() did not yield the "
             "(estimate, residual) split")
    return out


def check_catalog(programs: Optional[dict] = None):
    """ACC-M301 over every registered program. Returns (findings, n)."""
    if programs is None:
        from repro_torch.launch.catalog import make_catalog
        programs = make_catalog()
    findings: list[Finding] = []
    for name, program in programs.items():
        findings.extend(check_program(name, program))
    return findings, len(programs)

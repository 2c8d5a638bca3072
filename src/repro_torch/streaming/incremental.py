"""Incremental recomputation over a streaming graph, in part: the helpers
the serving scheduler uses (port of `repro.streaming.incremental`, its lines
70-114 and 369-388).

  * `is_monotone`, `is_residual`, `incremental_contract`, `resume_fields`
    classify a program by its declared metadata, never by its name: the
    scheduler caches `resume_fields` beside a result and preempts only
    residual-push programs;
  * `reseed_from_residuals` re-derives a `BatchState`'s frontier and
    consensus planes from residual metadata — the preempt/resume path of
    `serving.scheduler._LanePool.admit_resume`.

`residual_correct`, `incremental_batch` and `delta.py` (`StreamingGraph`)
come with ROADMAP queue 1 item 6.
"""

from __future__ import annotations

import torch

from repro_torch.core.acc import ACCProgram
from repro_torch.serving import batch_engine as B


def is_monotone(program: ACCProgram) -> bool:
    """Safe to resume from a previous fixpoint: idempotent min/max combiner
    with the default (monoid) apply — any valid upper(min)/lower(max) bound
    converges to the unique fixpoint."""
    return program.combiner.idempotent and program.apply is None


def is_residual(program: ACCProgram) -> bool:
    """Residual-push program (params kind='residual', e.g. `ppr_delta`):
    metadata carries an (estimate, residual) split whose invariant holds at
    EVERY iteration, so a run can stop and resume from its planes."""
    return program.param("kind") == "residual"


def incremental_contract(program: ACCProgram) -> str:
    """Classify the streaming-refresh regime for `program` from its declared
    metadata: 'residual' | 'monotone' | 'cascade' | 'reelect' | 'selective'
    (source-parameterized query-granular rerun) | 'full' (recompute — the
    always-safe fallback for programs declaring nothing)."""
    if is_residual(program):
        return "residual"
    if is_monotone(program):
        return "monotone"
    declared = program.param("incremental")
    if declared in ("cascade", "reelect"):
        return declared
    return "selective" if B._accepts_source(program) else "full"


def resume_fields(program: ACCProgram) -> tuple:
    """Metadata planes a resume needs beyond the served result field — the
    serving cache stores these alongside results. Residual programs need
    their (estimate, residual) split; contract programs declare theirs via
    params 'resume_fields'."""
    if is_residual(program):
        return (program.param("estimate", "rank"),
                program.param("residual", "resid"))
    if program.param("incremental") is not None:
        return tuple(program.param("resume_fields", ()))
    return ()


def reseed_from_residuals(program, cfg, g, st: B.BatchState,
                          m: dict) -> B.BatchState:
    """Re-derive a BatchState's frontier/consensus planes from residual
    metadata `m` ({field: (n+1, Q) tensor}). The frontier comes from
    `program.active` over the FULL field, masked by done lanes; the masked
    pull's `hot` plane goes all-hot."""
    active = program.active(m, m, st.it).clone()
    active[-1] = False
    active &= ~st.done[None, :]
    count = active.sum(0, dtype=torch.int32)
    union_fe, overflow = B._union_volume(g.out, cfg, active)
    st = st._replace(m=m, active=active, count=count,
                     union_fe=union_fe, overflow=overflow)
    if st.hot is not None:
        st = st._replace(hot=torch.ones_like(st.hot))
    gmode = B._consensus_mode(program, cfg, g.n_edges, st)
    return st._replace(gmode=gmode,
                       mode=torch.where(st.done, st.mode, gmode))

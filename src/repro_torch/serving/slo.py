"""Deadline-aware serving policy: admission drop, degradation, preemption.

Port of `repro.serving.slo`, unchanged: the policy is host-side.

The SLO subsystem's policy half (DESIGN.md §13). `GraphServer(slo=...)`
threads an :class:`SLOPolicy` through the scheduling loop; the load half
(open-loop workload generation and the replay harness, `repro.slo`) is not
ported yet (ROADMAP queue 1 item 7).

SIMD-X's just-in-time task management spends GPU cycles only on work that
still matters; at the serving layer the analogous discipline is spending
LANE time only on queries that can still meet their deadline:

  * **admission-time drop** — a queued query whose deadline has already
    passed (or provably cannot be met: `now + hopeless_margin x
    EWMA(resident)` past the deadline) is completed as `dropped` instead
    of occupying a lane it cannot use;
  * **pressure-triggered degradation** — under queue pressure, residual
    push programs (`ppr_delta`) admit into a shadow pool running a
    LOOSENED tolerance (`tol x degrade_factor`): the query finishes in
    fewer push iterations at documented accuracy loss, flagged
    `degraded` and never cached under the bit-exact key;
  * **preemption** — a long-resident lane blocking a pool whose queue
    holds deadline-critical work is evicted mid-run; for residual-push
    programs the FULL metadata columns (rank, resid, send, deg) are
    harvested into the result cache and the query is re-queued at the
    front — on re-admission it resumes the fixpoint from the saved
    residuals via the shared `reseed_from_residuals` path, so preempted
    work is resumable, not wasted.

Every decision is host-side and O(queue length); the policy never touches
the device beyond the rare preempt/resume column reads.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.acc import ACCProgram


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Knobs for deadline-aware scheduling (all trip points documented in
    DESIGN.md §13's policy table). Deadlines themselves arrive per query
    via `GraphServer.submit(deadline_ms=...)`; without a policy the server
    still *accounts* misses — the policy adds drop/degrade/preempt
    *actions*."""

    #: drop queued queries whose deadline has already passed (checked at
    #: submit and at the head of every pump's admission phase)
    drop_expired: bool = True
    #: also drop when `now + hopeless_margin * EWMA(pool resident)` is past
    #: the deadline — the query cannot finish even if admitted right now.
    #: 0 disables the estimate (only already-expired queries drop).
    hopeless_margin: float = 0.0

    #: algorithms (residual-push programs) that get a degraded shadow pool
    degrade_algos: Tuple[str, ...] = ()
    #: tolerance multiplier for the degraded variant (`tol x factor`)
    degrade_factor: float = 8.0
    #: lanes in each degraded shadow pool
    degrade_slots: int = 4
    #: pressure trigger: an algorithm's total queued count at/above this
    #: routes overflow admissions to the degraded pool
    degrade_queue_depth: int = 4
    #: pressure trigger (alternative): any queued query's deadline slack
    #: below this many seconds counts as pressure
    degrade_slack_s: float = 0.0

    #: enable preemption of long-resident lanes (residual-push pools only —
    #: their partial state is resumable; evicting a min-program lane would
    #: discard work)
    preempt: bool = False
    #: trigger: preempt when the smallest queued deadline slack is below
    #: max(preempt_slack_s, preempt_slack_factor * EWMA(pool resident))
    preempt_slack_s: float = 0.0
    preempt_slack_factor: float = 1.0
    #: a victim lane must have been resident at least this long
    preempt_min_resident_s: float = 0.0
    #: per-query preemption budget — caps requeue churn
    max_preempts: int = 1

    #: consensus-cohort step cadence (single-device cohort groups only).
    #: On a synchronous host backend a batched step costs the same whether
    #: one lane or all Q are live, so the isolation lever is WHICH leaves
    #: step each pump round: a cohort leaf holding any deadline-bearing
    #: resident query may burst up to `cohort_burst` steps per round...
    cohort_burst: int = 1
    #: ...while a best-effort-only leaf steps every `best_effort_stride`-th
    #: round (1 = every round, i.e. no cadence shaping — the default keeps
    #: cohort scheduling bit-identical to pre-policy serving)
    best_effort_stride: int = 1

    def describe(self) -> dict:
        """JSON-able summary for `GraphServer.stats()['slo']['policy']`."""
        return {
            "drop_expired": self.drop_expired,
            "hopeless_margin": self.hopeless_margin,
            "degrade_algos": list(self.degrade_algos),
            "degrade_factor": self.degrade_factor,
            "degrade_slots": self.degrade_slots,
            "degrade_queue_depth": self.degrade_queue_depth,
            "degrade_slack_s": self.degrade_slack_s,
            "preempt": self.preempt,
            "preempt_slack_s": self.preempt_slack_s,
            "preempt_slack_factor": self.preempt_slack_factor,
            "preempt_min_resident_s": self.preempt_min_resident_s,
            "max_preempts": self.max_preempts,
            "cohort_burst": self.cohort_burst,
            "best_effort_stride": self.best_effort_stride,
        }


def degraded_variant(program: ACCProgram, factor: float) -> ACCProgram:
    """Loosened-tolerance variant of a residual-push program.

    The degraded pool's program converges when the residual clears
    `factor*tol` times its declared threshold rule instead of `tol` — by the
    residual invariant the served estimate is within `factor*tol` per unit
    of threshold-weighted residual mass of the exact answer, reached in
    strictly fewer push iterations. Only residual programs degrade this way
    (min/max programs have nothing to loosen), and the rebuild goes through
    the program's OWN declared `with_tol` contract — metadata dispatch, no
    name matching, so any residual-form program in the catalog degrades."""
    assert factor > 1.0, factor
    assert program.param("kind") == "residual", (
        f"{program.name} is not a residual-push program — nothing to loosen")
    if program.with_tol is None:
        raise ValueError(
            f"{program.name!r} declares no tolerance-rebuild contract "
            "(ACCProgram.with_tol) — cannot build a degraded variant")
    return program.with_tol(float(program.param("tol")) * float(factor))

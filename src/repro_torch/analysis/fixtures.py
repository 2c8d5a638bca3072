"""Seeded violations — one per acclint rule ID of the port (DESIGN.md §16).

Port of `repro.analysis.fixtures`. Every rule ships with a fixture that
deliberately violates it, so the gate's failure path is itself tested:
`python -m repro_torch.launch.acclint --fixtures` must exit non-zero with
every rule ID present (on a CUDA device; on the CPU every rule but the
trace backend's), and tests/test_torch_acclint.py pins each fixture to its
rule. This file is excluded from the AST scan
(ast_lint.EXCLUDED_BASENAMES) — the violations below are the point.
"""

from __future__ import annotations

import torch

from .findings import CUDA_RULES, RULES

# ---------------------------------------------------------------------------
# trace fixtures (ACC-J102/J103): make() -> (step, state) on the card
# ---------------------------------------------------------------------------


def item_step(device):
    """§12 violation: a step that reads a device scalar back (`.item()`)
    to shift its output — the host waits for the device every step."""
    x = torch.arange(8, dtype=torch.float32, device=device)

    def step(s):
        return s + s.max().item()

    return step, x


def nonzero_step(device):
    """§8 violation: a step whose output size comes from `torch.nonzero`
    (the count of set lanes), so no static shape can be captured."""
    x = torch.arange(8, dtype=torch.float32, device=device)

    def step(s):
        return torch.nonzero(s > 3).reshape(-1)

    return step, x


def trace_fixtures(device) -> list:
    """[(entry, make)] of the trace fixtures on `device`."""
    return [("fixture:trace/item", lambda: item_step(device)),
            ("fixture:trace/nonzero", lambda: nonzero_step(device))]


# ---------------------------------------------------------------------------
# AST fixtures (ACC-A201/A202/A203): (rule, relpath-under-src/repro_torch, source)
# ---------------------------------------------------------------------------

AST_FIXTURES = (
    ("ACC-A201", "serving/fixture_dispatch.py",
     'def route(program, pool):\n'
     '    if program.name == "bfs":\n'
     '        return pool.traversal\n'
     '    return pool.generic\n'),
    ("ACC-A202", "streaming/fixture_scatter.py",
     'import numpy as np\n\n'
     'def seed(dead_in, dst, contrib):\n'
     '    np.add.at(dead_in, dst, contrib)\n'
     '    return dead_in\n'),
    ("ACC-A202", "core/fixture_index_add.py",
     'import torch\n\n'
     'def combine(vals, dst, n):\n'
     '    out = torch.zeros(n, dtype=torch.float32, device=vals.device)\n'
     '    out.index_add_(0, dst, vals)\n'
     '    return out\n'),
    ("ACC-A203", "serving/fixture_fetch.py",
     'import torch\n\n'
     'def harvest(st):\n'
     '    torch.cuda.synchronize()\n'
     '    return st.tele.cpu().numpy()\n'),
    ("ACC-A203", "serving/fixture_item.py",
     'def live(st):\n'
     '    return bool((~st.done).any().item())\n'),
)


# ---------------------------------------------------------------------------
# metadata fixture (ACC-M301)
# ---------------------------------------------------------------------------


def bad_meta_program():
    """A syntactically valid ACCProgram whose declarations are broken three
    ways: 'vote' on a non-idempotent monoid, kind='residual' without the
    refresh-math block or with_tol, and no declared result field."""
    from repro_torch.core import acc

    def init(n, deg, source=None):
        raise NotImplementedError("metadata fixture — never run")

    return acc.ACCProgram(
        name="bad_meta",
        combiner=acc.Combiner("sum", "vote"),
        init=init,
        compute=lambda s, w, r: s["val"],
        active=lambda new, old, it: new["val"] != old["val"],
        params=(("kind", "residual"), ("incremental", "sometimes")),
    )


# ---------------------------------------------------------------------------
# combiner fixtures (ACC-C401/C402/C403)
# ---------------------------------------------------------------------------


def broken_combiners():
    """[(combiner, expected_rule)] — each breaks exactly one algebra rule."""
    from repro_torch.core import acc

    class _MeanPair(acc.Combiner):
        """'sum' whose pair() averages: no identity, not associative."""

        def pair(self, a, b):
            return (a + b) * 0.5

    class _LyingIdempotent(acc.Combiner):
        """'sum' that CLAIMS idempotency (pair(x,x) = 2x != x)."""

        @property
        def idempotent(self):
            return True

    class _ShiftedSegment(acc.Combiner):
        """min whose segment() output is biased by an eighth — the keyed
        combine disagrees with the sequential pair() fold on every lane."""

        def segment(self, vals, ids, num, sorted_ids=False):
            return super().segment(vals, ids, num, sorted_ids) + 0.125

    return [
        (_MeanPair("sum", "aggregation"), "ACC-C401"),
        (_LyingIdempotent("sum", "aggregation"), "ACC-C402"),
        (_ShiftedSegment("min", "vote"), "ACC-C403"),
    ]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def expected_rules(device) -> set:
    """The rules whose fixtures can fire on `device`: all of them on a CUDA
    device, all but the trace backend's elsewhere."""
    if torch.device(device).type == "cuda":
        return set(RULES)
    return set(RULES) - CUDA_RULES


def run_all(device="cuda"):
    """Run every backend over its seeded violations on `device`. Returns
    (findings, checked) — the CLI's --fixtures mode; must produce every
    rule of `expected_rules(device)`. The trace fixtures run only on a
    CUDA device (`checked['trace_fixtures']` is 0 elsewhere)."""
    from . import ast_lint, combiner_check, meta_check, trace_check

    findings = []
    traced = []
    if torch.device(device).type == "cuda":
        traced = trace_fixtures(device)
        for entry, make in traced:
            findings.extend(trace_check.check_step(entry, make))
    for _rule, rel, src in AST_FIXTURES:
        for f in ast_lint.lint_source(src, rel):
            findings.append(f.__class__(f.rule, f"fixture:{rel}", f.line,
                                        f.message))
    findings.extend(meta_check.check_program("bad_meta", bad_meta_program()))
    broken = broken_combiners()
    for comb, _rule in broken:
        findings.extend(combiner_check.check_combiner(comb, device))
    checked = {"fixture_entries": len(traced) + len(AST_FIXTURES) + 1 + len(broken),
               "trace_fixtures": len(traced)}
    return findings, checked

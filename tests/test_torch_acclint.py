"""acclint for the port (`repro_torch.analysis`, `repro_torch.launch.acclint`)
held against the reference's (`repro.analysis`) on the CPU: the rule set,
the baseline format read both ways, the AST rules in torch idiom over seeded
violations and the port's tree, the metadata and combiner probes against
the reference's fixtures and counts, and the CLI's exit codes. The trace
backend (ACC-J102/J103) needs the card: tests/test_torch_cuda.py holds it.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import combiner_check as jcombiner
from repro.analysis import fixtures as jfixtures
from repro.analysis import meta_check as jmeta
from repro.analysis.findings import RULES as JRULES
from repro.analysis.findings import load_baseline as jload_baseline
from repro.core import algorithms as JA
from repro.graph import csr as jcsr
from repro.serving import default_config as jdefault_config
from repro.serving import run_batch as jrun_batch
from repro.streaming import StreamingGraph as JSG
from repro.streaming import incremental_batch as jincremental_batch
from repro_torch import interop
from repro_torch.analysis import ast_lint, combiner_check, fixtures, meta_check, trace_check
from repro_torch.analysis.findings import (BASELINE_PATH, CUDA_RULES, RULES, Finding,
                                           apply_baseline, load_baseline)
from repro_torch.core import algorithms as TA
from repro_torch.serving import default_config, run_batch
from repro_torch.streaming import StreamingGraph, incremental_batch
from repro_torch.streaming import incremental as tinc

ROOT = Path(__file__).resolve().parent.parent


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# the rule set
# ---------------------------------------------------------------------------


def test_rules_are_the_reference_set_less_the_deadlock_rule():
    assert set(RULES) == set(JRULES) - {"ACC-J101"}
    assert CUDA_RULES == {"ACC-J102", "ACC-J103"}


#: what each shared rule's contract must still say: the framework-free rules
#: keep the reference's text word for word, the others its scope and section
CONTRACT = {
    "ACC-J102": ("§12",), "ACC-J103": ("§8",), "ACC-A201": None,
    "ACC-A202": ("core/", "streaming/", "np.<ufunc>.at"),
    "ACC-A203": ("obs", "§12"), "ACC-M301": None,
    "ACC-C401": None, "ACC-C402": None, "ACC-C403": None,
}


@pytest.mark.parametrize("rule", sorted(CONTRACT))
def test_each_shared_rule_keeps_its_contract(rule):
    keep = CONTRACT[rule]
    if keep is None:
        assert RULES[rule] == JRULES[rule]
    else:
        for word in keep:
            assert word in RULES[rule] and word in JRULES[rule], (rule, word)


# ---------------------------------------------------------------------------
# baseline file: the reference's format, read both ways
# ---------------------------------------------------------------------------


def _write(tmp_path, entries, name="bl.json"):
    p = tmp_path / name
    p.write_text(json.dumps({"version": 1, "suppressions": entries}))
    return str(p)


@pytest.mark.parametrize("loader", [load_baseline, jload_baseline],
                         ids=["port-loader", "reference-loader"])
def test_baseline_roundtrip(tmp_path, loader):
    f1 = Finding("ACC-A202", "src/repro_torch/streaming/x.py", 12, "m")
    f2 = Finding("ACC-A203", "src/repro_torch/serving/y.py", 3, "m")
    path = _write(tmp_path, [
        {"rule": "ACC-A202", "path": "src/repro_torch/streaming/x.py",
         "reason": "known, tracked"},
        {"rule": "ACC-J102", "path": "trace:gone/entry", "reason": "stale entry"},
    ])
    active, suppressed, stale = apply_baseline([f1, f2], loader(path))
    assert active == [f2] and suppressed == [f1]
    assert [e["rule"] for e in stale] == ["ACC-J102"]


@pytest.mark.parametrize("loader", [load_baseline, jload_baseline],
                         ids=["port-loader", "reference-loader"])
def test_baseline_requires_reason(tmp_path, loader):
    path = _write(tmp_path, [{"rule": "ACC-A202", "path": "x.py", "reason": "  "}])
    with pytest.raises(ValueError):
        loader(path)


def test_each_loader_reads_the_others_committed_file():
    port = load_baseline(BASELINE_PATH)
    assert jload_baseline(BASELINE_PATH) == port
    ref = jload_baseline(str(ROOT / "ACCLINT_BASELINE.json"))
    assert load_baseline(str(ROOT / "ACCLINT_BASELINE.json")) == ref


def test_port_loader_refuses_the_deadlock_rule(tmp_path):
    path = _write(tmp_path, [{"rule": "ACC-J101", "path": "jaxpr:bfs/solo_fused",
                              "reason": "no counterpart"}])
    with pytest.raises(ValueError, match="unknown rule"):
        load_baseline(path)


def test_committed_baseline_entries_have_reasons_and_match():
    entries = load_baseline(BASELINE_PATH)
    assert entries, "the committed baseline is read"
    assert all(len(e["reason"].split()) >= 8 for e in entries)
    fs, _ = ast_lint.lint_tree(str(ROOT / "src" / "repro_torch"))
    _active, _supp, stale = apply_baseline(
        fs, [e for e in entries if not e["path"].startswith("trace:")])
    assert stale == []


# ---------------------------------------------------------------------------
# AST rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule,rel,src", fixtures.AST_FIXTURES,
                         ids=[f"{r}-{p}" for r, p, _ in fixtures.AST_FIXTURES])
def test_ast_fixture_flagged(rule, rel, src):
    fs = ast_lint.lint_source(src, rel)
    assert _rules(fs) == {rule}, fs
    assert all(f.line > 0 for f in fs)


def test_ast_fixtures_cover_the_reference_fixtures():
    assert {r for r, _, _ in fixtures.AST_FIXTURES} == \
        {r for r, _, _ in jfixtures.AST_FIXTURES}


def test_ast_combiner_name_dispatch_legal():
    """`comb.name == 'sum'` is monoid dispatch, not program dispatch."""
    src = 'def f(comb):\n    return comb.name == "sum"\n'
    assert ast_lint.lint_source(src, "serving/x.py") == []


def test_ast_reduceat_legal_and_scope():
    """reduceat over a stable sort (the pinned idiom) passes; an unordered
    scatter outside core/+streaming/ is out of scope for A202."""
    ok = ('import numpy as np\n'
          'def f(v, s, n):\n'
          '    o = np.argsort(s, kind="stable")\n'
          '    u, st = np.unique(s[o], return_index=True)\n'
          '    return np.add.reduceat(v[o], st, axis=0)\n')
    assert ast_lint.lint_source(ok, "streaming/x.py") == []
    for scatter in ('import numpy as np\ndef f(a, i, v):\n    np.add.at(a, i, v)\n',
                    'def f(a, i, v):\n    a.index_add_(0, i, v)\n'):
        assert ast_lint.lint_source(scatter, "kernels/x.py") == []
        assert _rules(ast_lint.lint_source(scatter, "core/x.py")) == {"ACC-A202"}


@pytest.mark.parametrize("call,legal", [
    ('a.scatter_reduce_(0, i, v, reduce="amax")', True),
    ('a.scatter_reduce(0, i, v, "amin", include_self=False)', True),
    ('a.scatter_reduce_(0, i, v, reduce="amin" if c else "amax")', True),
    ('a.index_reduce_(0, i, v, "amax")', True),
    ('torch.scatter_reduce(a, 0, i, v, "amax")', True),
    ('a.index_put_((i,), v)', True),
    ('a.scatter_reduce_(0, i, v, reduce="sum")', False),
    ('a.scatter_reduce_(0, i, v, reduce="amin" if c else "sum")', False),
    ('a.index_reduce_(0, i, v, "prod")', False),
    ('a.index_reduce_(0, i, v, "mean")', False),
    ('a.scatter_reduce_(0, i, v, reduce=op)', False),
    ('torch.scatter_reduce(a, 0, i, v, "sum")', False),
    ('torch.index_add(a, 0, i, v)', False),
    ('a.scatter_add_(0, i, v)', False),
    ('a.scatter_add(0, i, v)', False),
    ('a.index_add(0, i, v)', False),
    ('a.index_put_((i,), v, accumulate=True)', False),
    ('a.put_(i, v, accumulate=True)', False),
])
def test_ast_torch_scatters(call, legal):
    """amin/amax scatters are order-free and legal; sums, means, products,
    adds, accumulating puts and a reduce the source does not name are not."""
    src = f"import torch\ndef f(a, i, v, c, op):\n    return {call}\n"
    fs = ast_lint.lint_source(src, "streaming/x.py")
    assert (fs == []) == legal, fs


@pytest.mark.parametrize("call", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", 'x.to("cpu")',
    'x.to("cpu", copy=True).numpy()', "x.cpu().numpy()", "torch.cuda.synchronize()",
    'x.to(device="cpu")'])
def test_ast_host_reads_outside_obs(call):
    src = f"import torch\ndef f(x):\n    return {call}\n"
    fs = ast_lint.lint_source(src, "serving/x.py")
    assert _rules(fs) == {"ACC-A203"} and len(fs) == 1, fs
    assert ast_lint.lint_source(src, "obs/__init__.py") == []


def test_ast_counted_reads_exempt():
    """The counted reads go through obs's helpers: legal anywhere."""
    src = ('from repro_torch import obs\n'
           'def flags(st):\n'
           '    live, gmode = obs.host_flags(st.packed)\n'
           '    return obs.host_copy(st.m["dist"][:, 0]), obs.device_fetch(st.tele)\n'
           'def moved(x, dev):\n'
           '    return x.to(dev), x.to("cuda")\n')
    assert ast_lint.lint_source(src, "serving/batch_engine.py") == []


def test_ast_tree_clean_but_for_the_baseline():
    fs, n = ast_lint.lint_tree(str(ROOT / "src" / "repro_torch"))
    assert n > 60
    active, _supp, _stale = apply_baseline(fs, load_baseline(BASELINE_PATH))
    assert active == [], active
    paths = {f.path for f in fs}
    for clean in ("core/engine.py", "serving/batch_engine.py", "serving/sharded.py",
                  "serving/placement.py", "serving/scheduler.py",
                  "streaming/incremental.py", "streaming/delta.py"):
        assert f"src/repro_torch/{clean}" not in paths, clean


# ---------------------------------------------------------------------------
# metadata + combiner rules against the reference's
# ---------------------------------------------------------------------------


def test_meta_bad_fixture_same_rules_as_the_reference():
    fs = meta_check.check_program("bad_meta", fixtures.bad_meta_program())
    jfs = jmeta.check_program("bad_meta", jfixtures.bad_meta_program())
    assert _rules(fs) == _rules(jfs) == {"ACC-M301"}
    assert [f.message for f in fs] == [f.message for f in jfs]


def test_meta_catalog_clean_with_the_reference_count():
    fs, n = meta_check.check_catalog()
    _jfs, jn = jmeta.check_catalog()
    assert fs == [] and n == jn


@pytest.mark.parametrize("i", range(3))
def test_combiner_fixture_flagged_as_in_the_reference(i):
    comb, rule = fixtures.broken_combiners()[i]
    jcomb, jrule = jfixtures.broken_combiners()[i]
    assert rule == jrule
    fs = combiner_check.check_combiner(comb, "cpu")
    assert rule in _rules(fs), fs
    assert _rules(fs) == _rules(jcombiner.check_combiner(jcomb))


def test_combiner_registered_clean_with_the_reference_count():
    fs, n = combiner_check.check_registered(device="cpu")
    _jfs, jn = jcombiner.check_registered()
    assert fs == [] and n == jn


@pytest.mark.parametrize("name", ["min", "max", "sum"])
def test_combiner_probes_bit_equal_to_the_reference(name):
    """The C403 reductions on the reference's draws: the keyed combine and
    the pinned tree give the reference's bits."""
    import jax.numpy as jnp

    from repro.core import acc as jacc
    from repro_torch.core import acc as tacc

    p = combiner_check.probe_values(tacc.Combiner(name, "aggregation"), "cpu")
    d = combiner_check._draws()
    jc = jacc.Combiner(name, "aggregation")
    want = np.asarray(jc.segment(jnp.asarray(d["vals"]), jnp.asarray(d["ids"]), 5))
    assert np.array_equal(p["segment"].numpy().view(np.int32), want.view(np.int32))
    tree = np.asarray(jc.reduce_axis_tree(jnp.asarray(d["stack"]), 0))
    assert np.array_equal(p["tree"].numpy().view(np.int32), tree.view(np.int32))


def test_trace_backend_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        trace_check.require_cuda("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        list(trace_check.catalog_entries(device="cpu"))


def test_cpu_fixtures_fire_every_cpu_rule():
    fs, checked = fixtures.run_all("cpu")
    assert _rules(fs) == set(RULES) - CUDA_RULES == fixtures.expected_rules("cpu")
    assert checked["trace_fixtures"] == 0
    assert fixtures.expected_rules("cuda") == set(RULES)


# ---------------------------------------------------------------------------
# the A202 repair: incremental multiset counts without np.add.at
# ---------------------------------------------------------------------------


def _no_add_at(path):
    tree = ast.parse(Path(path).read_text())
    return not any(isinstance(n, ast.Attribute) and n.attr == "at"
                   and isinstance(n.value, ast.Attribute) and n.value.attr == "add"
                   for n in ast.walk(tree))


def test_incremental_uses_no_add_at():
    assert _no_add_at(tinc.__file__)


@pytest.mark.parametrize("algo", ["ppr_delta", "pagerank_delta"])
def test_incremental_batch_with_repeated_neighbours_pinned(algo):
    """A source `u` with three parallel edges to one target and two to
    another: deleting one copy and inserting another moves the multiset
    counts. `incremental_batch` is bit-equal to the reference's (which
    counts with np.bincount) and to the counts np.add.at gave."""
    e = np.asarray([(0, 1), (1, 2), (1, 2), (1, 2), (1, 3), (1, 3), (2, 4), (3, 4),
                    (4, 0), (4, 1)], dtype=np.int64)
    jg = jcsr.from_edges(e[:, 0], e[:, 1], 5, None, directed=True, dedupe=False)
    tg = interop.graph_from_numpy(interop.csr_arrays(jg.out), interop.csr_arrays(jg.inc),
                                  device="cpu")
    js, ts = JSG(jg, delta_cap=16), StreamingGraph(tg, delta_cap=16)
    args = (0,) if algo == "ppr_delta" else ()
    jp, tp = getattr(JA, algo)(*args), getattr(TA, algo)(*args)
    sources = [0, 1]
    jcfg, tcfg = jdefault_config(jg, max_iters=256), default_config(tg, max_iters=256)
    jprev, _ = jrun_batch(jp, js.graph, js.pack, jcfg, sources, delta=js.delta)
    tprev, _ = run_batch(tp, ts.graph, ts.pack, tcfg, sources, delta=ts.delta)
    ins, dels = [(1, 3), (1, 2)], [(1, 2)]
    js.apply(ins, dels)
    ts.apply(ins, dels)
    jm, jinfo = jincremental_batch(jp, js, jcfg, sources, {k: np.asarray(v)
                                                          for k, v in jprev.items()})
    tm, tinfo = incremental_batch(tp, ts, tcfg, sources, tprev)
    assert tinfo["mode"] == jinfo["mode"] == "residual-resume"
    for k in jm:
        a, b = np.asarray(jm[k]), tm[k].numpy()
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), k
    # the multiset counts of `u` = 1 as np.add.at gave them
    nbrs = ts.live_out_neighbors(1)
    keys = np.unique(np.concatenate([nbrs, [3, 2], [2]]))
    old = np.zeros(keys.size, np.int64)
    np.add.at(old, np.searchsorted(keys, nbrs), 1)
    assert np.array_equal(old, np.bincount(np.searchsorted(keys, nbrs),
                                           minlength=keys.size))
    assert old.max() >= 3                  # `u` repeats a neighbour


def test_sum_by_target_matches_an_integer_scatter():
    rng = np.random.default_rng(5)
    dst = torch.from_numpy(rng.integers(0, 40, 500))
    vals = torch.from_numpy(rng.integers(0, 2, (500, 3)).astype(np.int32))
    want = torch.zeros((40, 3), dtype=torch.int32)
    want.index_add_(0, dst, vals)
    assert torch.equal(tinc._sum_by_target(dst, vals, 40), want)
    empty = tinc._sum_by_target(dst[:0], vals[:0], 40)
    assert torch.equal(empty, torch.zeros((40, 3), dtype=torch.int32))


# ---------------------------------------------------------------------------
# CLI exit codes
# ---------------------------------------------------------------------------


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.acclint", *args],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_clean_tree_exits_zero_on_the_cpu():
    p = _cli("--device", "cpu", "--backends", "ast,combiner", "--json", "-")
    assert p.returncode == 0, p.stdout + p.stderr
    report = json.loads(p.stdout)
    assert report["ok"] and report["findings"] == [] and report["stale_suppressions"] == []
    assert report["checked"]["meta_programs"] == 9 and report["checked"]["ast_files"] > 60
    assert report["device"] == "cpu"


def test_cli_fixtures_on_the_cpu_exit_one_every_cpu_rule():
    p = _cli("--fixtures", "--device", "cpu", "--json", "-")
    assert p.returncode == 1, p.stdout + p.stderr
    report = json.loads(p.stdout)
    assert {f["rule"] for f in report["findings"]} == set(RULES) - CUDA_RULES
    assert report["ok"] is False
    assert "ACC-J102" in p.stderr and "not run" in p.stderr


@pytest.mark.parametrize("args", [("--backends", "nope"),
                                  ("--device", "cpu", "--backends", "trace"),
                                  ("--device", "cpu"),
                                  ("--device", "cpu", "--backends", "ast",
                                   "--programs", "nope")])
def test_cli_usage_errors_exit_two(args):
    p = _cli(*args)
    assert p.returncode == 2, p.stdout + p.stderr

"""acclint for the port — the repro_torch.analysis CLI (DESIGN.md §16).

Port of `repro.launch.acclint`, over `src/repro_torch/`:

    python -m repro_torch.launch.acclint                 # all backends, on the card
    python -m repro_torch.launch.acclint --json report.json
    python -m repro_torch.launch.acclint --backends trace --programs bfs,kcore
    python -m repro_torch.launch.acclint --device cpu --backends ast,combiner
    python -m repro_torch.launch.acclint --fixtures      # seeded violations: must
                                                         # exit non-zero, every rule

Exit codes follow the reference: 0 = clean (baselined findings reported but
not fatal), 1 = non-baselined findings or a fixture gap, 2 = usage/config
error (an unknown backend or program, a malformed baseline, the trace
backend on a device that is not CUDA). Suppressions: the port's
`src/repro_torch/analysis/baseline.json` — entries are {rule, path,
reason}, reason mandatory.

The trace backend runs engine steps on the card (`--device`, default
cuda); the sharded entries put every shard of their (2, 1) and (1, 2)
meshes on that one device. `--device cpu` runs the AST, metadata and
combiner backends on the CPU and refuses the trace backend.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BACKENDS = ("trace", "ast", "combiner")


def _parse_args(argv):
    from repro_torch.analysis.findings import BASELINE_PATH

    ap = argparse.ArgumentParser(
        prog="acclint",
        description="static checks of ACC contracts and determinism "
                    "discipline over the port (DESIGN.md §16)")
    ap.add_argument("--backends", default="trace,ast,combiner",
                    help="comma list of: trace, ast (includes the metadata "
                         "rules), combiner [default: all]")
    ap.add_argument("--programs", default=None,
                    help="comma list of catalog programs for the trace/meta "
                         "backends [default: the whole catalog]")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="suppression file [default: the package's "
                         "analysis/baseline.json]")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="write the machine-readable report to PATH "
                         "('-' = stdout)")
    ap.add_argument("--fixtures", action="store_true",
                    help="run the seeded per-rule violations instead of the "
                         "tree (self-test: exits non-zero, every rule ID)")
    ap.add_argument("--scale", type=int, default=6,
                    help="RMAT scale of the trace graph [default: 6]")
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the sharded entry points (fast dev loop)")
    ap.add_argument("--device", default="cuda",
                    help="device of the trace and combiner backends "
                         "[default: cuda]")
    return ap.parse_args(argv)


def _checked_by(entry: dict, backends: list, programs) -> bool:
    """Whether this run checks what a suppression entry names (so that an
    entry it cannot match is not reported stale): a trace entry of a
    program the run traces, a combiner probe, or a source file or catalog
    program of the AST and metadata backends."""
    path = entry["path"]
    for scope, backend in (("trace:", "trace"), ("catalog:", "ast")):
        if path.startswith(scope):
            name = path[len(scope):].split("/", 1)[0]
            return backend in backends and (programs is None or name in programs)
    if path.startswith("combiner:"):
        return "combiner" in backends
    return "ast" in backends


def run(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    import torch

    from repro_torch.analysis import apply_baseline, load_baseline
    from repro_torch.analysis.findings import render, to_json

    backends = [b.strip() for b in args.backends.split(",") if b.strip()]
    unknown = [b for b in backends if b not in BACKENDS]
    if unknown:
        print(f"[acclint] unknown backend(s): {unknown}", file=sys.stderr)
        return 2
    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        print(f"[acclint] bad --device: {e}", file=sys.stderr)
        return 2
    if "trace" in backends and not args.fixtures and device.type != "cuda":
        print(f"[acclint] the trace backend runs on a CUDA device, not "
              f"{device}: pass --device cuda, or --backends ast,combiner",
              file=sys.stderr)
        return 2

    findings: list = []
    checked: dict = {}
    missing: list = []
    seconds: dict = {}
    programs = None

    if args.fixtures:
        from repro_torch.analysis import fixtures
        findings, checked = fixtures.run_all(device)
        fired = {f.rule for f in findings}
        expected = fixtures.expected_rules(device)
        missing = sorted(expected - fired)
        checked["rules_fired"] = len(fired)
        if device.type != "cuda":
            print(f"[acclint] on {device} the trace backend's rules "
                  f"{sorted(set(fixtures.RULES) - expected)} are not run "
                  "(they need a CUDA device)", file=sys.stderr)
        if missing:
            # a rule whose seeded violation no longer fires is a DEAD rule
            print(f"[acclint] FIXTURE GAP: rules {missing} produced no "
                  "finding on their seeded violations", file=sys.stderr)
        baseline: list = []          # fixtures are never baselined
    else:
        try:
            baseline = load_baseline(args.baseline)
        except ValueError as e:
            print(f"[acclint] bad baseline: {e}", file=sys.stderr)
            return 2
        if args.programs is not None:
            from repro_torch.launch.catalog import make_catalog
            cat = make_catalog()
            names = [p.strip() for p in args.programs.split(",") if p.strip()]
            bad = [p for p in names if p not in cat]
            if bad:
                print(f"[acclint] unknown program(s): {bad} "
                      f"(catalog: {sorted(cat)})", file=sys.stderr)
                return 2
            programs = {k: cat[k] for k in names}
        if "trace" in backends:
            from repro_torch.analysis import trace_check
            t0 = time.perf_counter()
            per_entry: dict = {}
            fs, n = trace_check.check_catalog(
                programs, scale=args.scale, sharded=not args.no_sharded,
                device=device, seconds=per_entry)
            findings.extend(fs)
            checked["trace_entries"] = n
            seconds["trace"] = time.perf_counter() - t0
            seconds["trace_entries"] = per_entry
        if "ast" in backends:
            import repro_torch
            from repro_torch.analysis import ast_lint, meta_check
            t0 = time.perf_counter()
            root = os.path.dirname(os.path.abspath(repro_torch.__file__))
            fs, n = ast_lint.lint_tree(root)
            findings.extend(fs)
            checked["ast_files"] = n
            fs, n = meta_check.check_catalog(programs)
            findings.extend(fs)
            checked["meta_programs"] = n
            seconds["ast"] = time.perf_counter() - t0
        if "combiner" in backends:
            from repro_torch.analysis import combiner_check
            t0 = time.perf_counter()
            fs, n = combiner_check.check_registered(programs, device=device)
            findings.extend(fs)
            checked["combiners"] = n
            seconds["combiner"] = time.perf_counter() - t0

    baseline = [e for e in baseline if _checked_by(e, backends, programs)]
    active, suppressed, stale = apply_baseline(findings, baseline)
    report = to_json(active, suppressed, stale, checked)
    report["device"] = str(device)
    report["seconds"] = seconds
    if args.json == "-":
        print(json.dumps(report, indent=2))
    else:
        if args.json:
            with open(args.json, "w") as f:
                json.dump(report, f, indent=2)
        print(render(active, suppressed, stale, checked))
        for backend in BACKENDS:
            if backend in seconds:
                print(f"[acclint] {backend} backend {seconds[backend]:.2f} s "
                      f"on {device}")
    if args.fixtures and missing:
        return 1
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(run())

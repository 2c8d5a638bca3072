"""repro_torch.analysis — acclint for the port: static checking of ACC
contracts and determinism discipline over `src/repro_torch/` (DESIGN.md
§16), port of `repro.analysis`.

Four backends over one findings/baseline pipeline:

  * `trace_check` — runs every catalog program's engine steps on the card
    (solo, batched, sharded replicated + edge-sharded) under the sync debug
    mode (ACC-J102, host transfers, §12) and captures each in a CUDA graph
    (ACC-J103, static shapes, §8); the counterpart of the reference's IR
    backend. The reference's ACC-J101 (§9 deadlock) has no counterpart:
    the port's mesh is single-controller, with no device-side barrier;
  * `ast_lint` + `meta_check` — convention rules over src/repro_torch/
    source and the registered programs' declared metadata (§15);
  * `combiner_check` — bit-exact property probes of every registered
    Combiner's monoid algebra, on the caller's device.

CLI: `python -m repro_torch.launch.acclint` (runs on the card unless
`--device cpu`). Suppressions live in `analysis/baseline.json` beside this
file; deliberate per-rule violations in `fixtures` (run via --fixtures).
"""

from .findings import RULES, Finding, apply_baseline, load_baseline  # noqa: F401

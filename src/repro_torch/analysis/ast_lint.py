"""AST backend: convention rules over `src/repro_torch/` source (ACC-A201..
A203, DESIGN.md §16), in PyTorch's idiom.

Port of `repro.analysis.ast_lint`. Each rule bans a defect class an earlier
change fixed by hand; the linter keeps it out. The walker works on parsed
source, so strings and comments can't trip rules, and every finding
anchors to a real file:line.

  * A201: `<x>.name == '<algo>'` program dispatch, as in the reference
    (comparing a combiner's name, `comb.name == 'sum'`, stays legal).
  * A202: unordered scatter accumulation in core/ and streaming/: numpy's
    `np.<ufunc>.at`, and torch's `index_add(_)`, `scatter_add(_)`,
    `index_put(_)`/`put_` with `accumulate=True`, and `scatter_reduce(_)`/
    `index_reduce(_)` whose reduce is sum, mean or prod or cannot be read
    from the source. `amin`/`amax` are order-free and stay legal.
  * A203: device->host reads (`.item()`, `.tolist()`, `.cpu()`,
    `.numpy()`, `.to('cpu')`, `torch.cuda.synchronize`) outside `obs/`.
    `obs` is the chokepoint: `device_fetch` (telemetry, TRANSFER_COUNT),
    `host_flags` (the engine's packed control-flow reads, which callers
    count in `batch_engine.HOST_READS`) and `host_copy` (result planes).
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, Optional

from .findings import Finding

#: catalog algorithm names — the string literals whose `.name ==` comparison
#: constitutes program dispatch (combiner dispatch, `comb.name == 'sum'`,
#: compares monoid names and stays legal: the monoid IS the declared
#: metadata)
ALGO_NAMES = frozenset({
    "bfs", "sssp", "wcc", "ppr", "ppr_delta", "pagerank", "pagerank_delta",
    "kcore", "mis", "bp",
})

#: numpy ufuncs whose unordered `.at` scatter the determinism doctrine bans
#: in core/ + streaming/
UFUNC_NAMES = frozenset({
    "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "logical_or", "logical_and", "bitwise_or", "bitwise_and", "fmax", "fmin",
})

#: torch scatters that always accumulate in an unordered way
TORCH_SCATTER_ADDS = frozenset({"index_add", "index_add_", "scatter_add",
                                "scatter_add_"})
#: torch scatters whose order matters only for some reductions; the
#: position of `reduce` among the method's positional arguments
TORCH_SCATTER_REDUCES = {"scatter_reduce": 3, "scatter_reduce_": 3,
                         "index_reduce": 3, "index_reduce_": 3}
#: torch writes that accumulate only with `accumulate=True`
TORCH_ACCUMULATING_PUTS = frozenset({"index_put", "index_put_", "put", "put_"})
#: reductions a scatter may take in any order (min/max are exact)
ORDER_FREE_REDUCES = frozenset({"amin", "amax"})

#: tensor methods that read the device from the host
HOST_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: directories (relative to the scan root) where ACC-A202 applies
SCATTER_SCOPES = ("core", "streaming")
#: directory whose files ARE the §12 device->host chokepoint (ACC-A203 exempt)
FETCH_CHOKEPOINT = "obs"
#: files the linter never scans (deliberate violations live here)
EXCLUDED_BASENAMES = ("fixtures.py",)


def _dotted(node: ast.AST) -> Optional[str]:
    """`np.add.at` -> 'np.add.at'; None for non-trivial expressions."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _str_consts(node: ast.AST) -> Iterable[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for e in node.elts:
            yield from _str_consts(e)


def _literal_strs(node: ast.AST) -> Optional[set]:
    """The strings an expression can take when it is a literal or a
    conditional between literals; None when the source does not say."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.IfExp):
        a, b = _literal_strs(node.body), _literal_strs(node.orelse)
        return None if a is None or b is None else a | b
    return None


def _kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
    return next((k.value for k in node.keywords if k.arg == name), None)


def _is_torch_function(func: ast.AST) -> bool:
    """`torch.index_add(x, ...)` rather than `x.index_add(...)`: the tensor
    is the first positional argument, so the others shift by one."""
    return (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
            and func.value.id == "torch")


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.findings: list[Finding] = []
        top = relpath.replace(os.sep, "/").split("/", 1)[0]
        self.in_scatter_scope = top in SCATTER_SCOPES
        self.in_chokepoint = top == FETCH_CHOKEPOINT

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(
            Finding(rule, self.relpath, getattr(node, "lineno", 0), msg))

    # -- ACC-A201: program-name string dispatch ------------------------------

    def visit_Compare(self, node: ast.Compare) -> None:
        left_is_name = (isinstance(node.left, ast.Attribute)
                        and node.left.attr == "name")
        for op, comp in zip(node.ops, node.comparators):
            algos = ()
            if left_is_name and isinstance(op, (ast.Eq, ast.NotEq, ast.In,
                                                ast.NotIn)):
                algos = [s for s in _str_consts(comp) if s in ALGO_NAMES]
            if algos:
                self._flag(
                    "ACC-A201", node,
                    f"dispatch on program name {algos!r} — consult declared "
                    "program metadata (`program.param(...)`, combiner kind, "
                    "incremental contract) instead (DESIGN.md §15)")
        self.generic_visit(node)

    # -- ACC-A202: unordered scatters -----------------------------------------

    def _scatter(self, node: ast.Call, dotted: Optional[str]) -> None:
        parts = dotted.split(".") if dotted else []
        if (len(parts) == 3 and parts[0] in ("np", "numpy")
                and parts[1] in UFUNC_NAMES and parts[2] == "at"):
            self._flag(
                "ACC-A202", node,
                f"`{dotted}` scatter: association order depends on the "
                "duplicate layout of the index batch — pin it with "
                f"`np.{parts[1]}.reduceat` over a stable argsort")
            return
        if not isinstance(node.func, ast.Attribute):
            return
        attr = node.func.attr
        shift = 1 if _is_torch_function(node.func) else 0
        if attr in TORCH_SCATTER_ADDS:
            self._flag(
                "ACC-A202", node,
                f"`{attr}` accumulates duplicates in an unordered way (atomics "
                "on the card) — pin the order with a stable sort and a segment "
                "reduce (`Combiner.segment`), or take an order-free amin/amax")
        elif attr in TORCH_SCATTER_REDUCES:
            pos = TORCH_SCATTER_REDUCES[attr] + shift
            red = _kwarg(node, "reduce")
            if red is None and len(node.args) > pos:
                red = node.args[pos]
            ops = None if red is None else _literal_strs(red)
            if ops is None or not ops <= ORDER_FREE_REDUCES:
                what = "a reduce the source does not name" if ops is None \
                    else f"reduce {sorted(ops)}"
                self._flag(
                    "ACC-A202", node,
                    f"`{attr}` with {what}: only amin/amax are order-free — "
                    "pin a sum's order with a stable sort and a segment reduce")
        elif attr in TORCH_ACCUMULATING_PUTS:
            acc = _kwarg(node, "accumulate")
            if isinstance(acc, ast.Constant) and acc.value is True:
                self._flag(
                    "ACC-A202", node,
                    f"`{attr}(accumulate=True)` adds duplicates in an "
                    "unordered way — pin the order with a stable sort and a "
                    "segment reduce")

    # -- ACC-A203: device->host reads -----------------------------------------

    def _host_read(self, node: ast.Call, dotted: Optional[str]) -> None:
        func = node.func
        what = None
        if dotted == "torch.cuda.synchronize":
            what = "`torch.cuda.synchronize()`"
        elif isinstance(func, ast.Attribute) and func.attr in HOST_READ_METHODS:
            # `.cpu().numpy()` is one read, flagged at its `.cpu()`
            inner = func.value
            if not (func.attr == "numpy" and isinstance(inner, ast.Call)
                    and isinstance(inner.func, ast.Attribute)
                    and inner.func.attr in ("cpu", "to")):
                what = f"`.{func.attr}()`"
        elif isinstance(func, ast.Attribute) and func.attr == "to":
            dest = node.args[0] if node.args else _kwarg(node, "device")
            if isinstance(dest, ast.Constant) and dest.value == "cpu":
                what = "`.to('cpu')`"
        if what:
            self._flag(
                "ACC-A203", node,
                f"{what} outside `repro_torch.obs` — device->host reads go "
                "through the chokepoint (`obs.device_fetch`, `obs.host_flags`, "
                "`obs.host_copy`) so they are counted; engine code must stay "
                "async (DESIGN.md §12)")

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if self.in_scatter_scope:
            self._scatter(node, dotted)
        if not self.in_chokepoint:
            self._host_read(node, dotted)
        self.generic_visit(node)


def lint_source(source: str, relpath: str) -> list[Finding]:
    """Lint one file's source. `relpath` is relative to the scan root
    (`src/repro_torch/`) — scope rules key off its first path component."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("ACC-A201", relpath, e.lineno or 0,
                        f"unparseable source: {e.msg}")]
    v = _Visitor(relpath)
    v.visit(tree)
    return v.findings


def lint_tree(root: str):
    """Lint every .py under `root` (the src/repro_torch/ package directory).
    Returns (findings, n_files)."""
    findings: list[Finding] = []
    n = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if not fn.endswith(".py") or fn in EXCLUDED_BASENAMES:
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            with open(path, encoding="utf-8") as f:
                src = f.read()
            for fd in lint_source(src, rel):
                # re-anchor to a path usable from the repo root
                findings.append(Finding(fd.rule,
                                        os.path.join("src/repro_torch", rel),
                                        fd.line, fd.message))
            n += 1
    return findings, n

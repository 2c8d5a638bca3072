"""The port stands alone: no file of `src/repro_torch/` nor `chip_smoke.py`
imports `jax` or the reference package `repro`, and the package imports with
JAX made unimportable."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_package_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.interop\n"
        "from repro_torch.core import algorithms, engine, frontier, acc\n"
        "from repro_torch.graph import generators, packing, csr\n"
        "from repro_torch.kernels import ops, ell_spmv, frontier_pack, segment_reduce\n"
        "g = generators.rmat(6, 4, seed=1, device='cpu')\n"
        "p = packing.pack_ell(g.inc)\n"
        "m, st = engine.run(algorithms.bfs(0), g, p,\n"
        "                   engine.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges))\n"
        "assert int(st['final_count']) == 0\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]

"""Nothing the benchmark loads is JAX or the JAX package: every module
under graphbench/ imported in a fresh process, and a whole run of a cell on
the CPU, then the top-level name of each loaded module (the part before the
first dot) compared whole against jax, jaxlib, flax and repro."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p.relative_to(REPO) for p in (REPO / "graphbench").rglob("*.py")
                 if "tests" not in p.parts)


def loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_is_found():
    assert len(MODULES) >= 20


@pytest.mark.parametrize("path", MODULES, ids=str)
def test_module_loads_no_jax(path):
    if len(path.parts) == 2:
        code = f"import importlib; importlib.import_module('graphbench.{path.stem}')"
    else:
        code = ("from pathlib import Path; from graphbench import harness; "
                f"harness.module(Path({str(REPO)!r}), {path.parts[1]!r}, {path.stem!r})")
    names = loaded_after(code)
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_a_whole_cpu_run_loads_no_jax(tmp_path):
    code = ("import sys; sys.path.insert(0, " + repr(str(REPO / "graphbench" / "tests")) + ")\n"
            "from conftest import make_tiny, run_tiny\n"
            "import pathlib\n"
            f"root = make_tiny(pathlib.Path({str(tmp_path)!r}))\n"
            "r = run_tiny(root, 'kron23-serve')\n"
            "assert r['correct'], r")
    names = loaded_after(code)
    assert "repro_torch" in names and not names & FORBIDDEN


def test_the_check_compares_whole_names():
    sys.path.insert(0, str(REPO / "graphbench"))
    import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    sys.modules["repro_torch_like.x"] = sys.modules["json"]
    try:
        assert "repro_torch_like" not in run.forbidden_modules()
    finally:
        del sys.modules["repro_torch_like.x"]

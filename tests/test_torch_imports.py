"""The port stands alone: no file of `src/repro_torch/`, nor `chip_smoke.py`,
the port's scripts (`scripts/port_*.py`) or its examples (`examples/torch/`),
imports `jax` or the reference package `repro`, and the package imports
with JAX made unimportable."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("port_*.py")) + sorted(
    (ROOT / "examples" / "torch").glob("*.py"))


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
        "from repro_torch.kernels import embedding_bag, flash_attention\n"
        "from repro_torch.nn import layers, chunked_attn\n"
        "from repro_torch import obs, serving\n"
        "from repro_torch.core import baselines\n"
        "from repro_torch.serving import batch_engine, cache, scheduler, slo\n"
        "from repro_torch.obs import metrics, trace, recorder, health\n"
        "from repro_torch import streaming\n"
        "from repro_torch.streaming import delta, incremental\n"
        "from repro_torch.launch import catalog, serve_graph, stream_graph\n"
        "from repro_torch.launch import slo_replay, obs_report\n"
        "from repro_torch import mesh, slo\n"
        "from repro_torch.slo import workload, harness\n"
        "from repro_torch.graph import partition\n"
        "from repro_torch.serving import sharded, placement\n"
        "from repro_torch import analysis\n"
        "from repro_torch.analysis import ast_lint, combiner_check, fixtures, findings\n"
        "from repro_torch.analysis import meta_check, trace_check\n"
        "from repro_torch.launch import acclint\n"
        "assert acclint.run(['--device', 'cpu', '--backends', 'ast,combiner']) == 0\n"
        "import torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.configs import registry, lm_archs, gnn_archs\n"
        "from repro_torch.nn import moe\n"
        "from repro_torch.models import transformer, deepfm, gnn, dimenet\n"
        "from repro_torch.launch import serve, train\n"
        "from repro_torch import optim, data, checkpoint, distributed, tree\n"
        "from repro_torch.optim import adamw\n"
        "from repro_torch.data import pipelines\n"
        "from repro_torch.checkpoint import manager\n"
        "from repro_torch.distributed import fault\n"
        "from repro_torch.graph import sampler\n"
        "from repro_torch.distributed import sharding, collectives, pipeline, pipeline_tp\n"
        "from repro_torch.nn import decode_attn\n"
        "m4 = mesh.make_mesh(2, 2, devices=['cpu'] * 4)\n"
        "with sharding.activate(m4):\n"
        "    assert sharding.spec('kv_seq', 'heads') == (('data', 'model'), None)\n"
        "red, _ = collectives.bf16_psum_ef([torch.ones(3)] * 2, [torch.zeros(3)] * 2)\n"
        "assert red[0].tolist() == [2.0, 2.0, 2.0]\n"
        "q, kv = torch.randn(2, 4, 1, 8), torch.randn(2, 2, 16, 8)\n"
        "out = decode_attn.decode_attention_splitkv(q, kv, kv, 9, m4)\n"
        "assert out.shape == (2, 4, 1, 8)\n"
        "assert len(configs.cells()) == 40\n"
        "cfg = train.tiny_config(configs.get('granite-moe-1b-a400m').make_config(),\n"
        "                        d_model=64, n_layers=1, vocab=64)\n"
        "tp = transformer.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "done, _ = serve.serve(cfg, tp, [[[1, 2, 3]]], 1, 2, 8, 'cpu')\n"
        "assert len(done[0][1]) == 2\n"
        "g = generators.rmat(6, 4, seed=1, device='cpu')\n"
        "p = packing.pack_ell(g.inc)\n"
        "m, st = engine.run(algorithms.bfs(0), g, p,\n"
        "                   engine.EngineConfig(frontier_cap=g.n_nodes, edge_cap=g.n_edges))\n"
        "assert int(st['final_count']) == 0\n"
        "mb, sb = serving.run_batch(algorithms.bfs(0), g, p, serving.default_config(g), [0, 3])\n"
        "assert int(sb['final_count'].sum()) == 0\n"
        "srv = serving.GraphServer(g, p, catalog.make_catalog(), slots=2,\n"
        "                          telemetry=True)\n"
        "for a in ('bfs', 'ppr_delta', 'kcore'):\n"
        "    srv.submit(a, 3)\n"
        "assert len(srv.drain()) == 3 and srv.stats()['obs']['enabled']\n"
        "ssrv = serving.GraphServer(g, None, catalog.make_catalog(), slots=2,\n"
        "                           delta_cap=8)\n"
        "for a in ('bfs', 'ppr_delta', 'kcore'):\n"
        "    ssrv.submit(a, 3)\n"
        "ssrv.pump()\n"
        "assert ssrv.apply_updates([(1, 2), (4, 5)], [(0, int(g.out.col_idx[0]))])['version'] == 1\n"
        "assert len(ssrv.drain()) == 3 and ssrv.stats()['graph']['streaming']['version'] == 1\n"
        "msrv = serving.GraphServer(g, None, catalog.make_catalog(), slots=2, delta_cap=8,\n"
        "                           mesh=serving.make_serving_mesh(2, 2, devices=['cpu'] * 4),\n"
        "                           placements={'bfs': ('replicated', 2),\n"
        "                                       'ppr_delta': ('edge_sharded', 2)})\n"
        "for a in ('bfs', 'ppr_delta'):\n"
        "    msrv.submit(a, 3)\n"
        "msrv.pump()\n"
        "assert set(msrv.apply_updates([(1, 2)])['shipped']) == {'bfs', 'ppr_delta'}\n"
        "arr = slo.generate(slo.Workload(rate_qps=200.0, duration_s=0.1), g.n_nodes)\n"
        "assert slo.replay(msrv, arr).crashed_lanes == 0\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]

"""The dry-run: every (arch x shape x mesh) cell proved on meta tensors.

Counterpart of `repro.launch.dryrun`. The reference lowers and compiles each
cell under XLA on a forced 512-device host platform and reads the compiled
program's memory analysis, cost analysis and collectives. The port has no
compiler: it proves each cell by running the port's own step
(`launch.steps`) on `meta` tensors, which holds no data, takes no memory
and needs no card, and counts what that run executes (`launch.cost`).

The production meshes keep the reference's shapes (`launch.mesh`): (16, 16)
on ('data', 'model') and (2, 16, 16) on ('pod', 'data', 'model'). On the
H100 the 256-GPU mesh reads as one NVLink Switch domain and 'pod' as two
such domains over InfiniBand; the collective term uses NVLink's 450 GB/s
alone, as the reference uses one ICI rate.

Each record has the reference's fields:

  * `memory`, per device: `argument_bytes`, `output_bytes` and
    `alias_bytes` (the donated inputs) from the shard shapes the cell's
    shardings give (a dim that does not divide takes the ceiling, as XLA
    pads); `argument_alloc_bytes`, the same with each tensor's block
    rounded up to the caching allocator's 512 bytes (what
    `torch.cuda.memory_allocated` counts for the arguments on one card of
    the mesh: every input has a storage of its own, and a host scalar
    takes none);
    `one_device_peak_bytes`, the meta run's peak for the cell as the port
    runs it on one card. `temp_bytes` is null with its reason: for the
    default steps the reference relies on GSPMD to partition the program,
    and the port places tensors explicitly and has no partitioned executor
    for them; the mesh variants run every shard in one process.
  * `flops`, `bytes_accessed`: the one-device program's counts (aten ops
    plus the kernels' meta routes), and `kernels`, each kernel's calls,
    operations and bytes.
  * `collectives`: counted for the steps the port runs on a mesh (`pp`,
    `edgeshard`, `splitkv`, on one pod's grid), null for the default cells
    (the reason above).
  * `roofline`: three terms on `kernels.tuning.H100`. Compute comes from
    `analytic` for the LM cells, as in the reference; otherwise it is the
    counted flops over the chips, marked as an even split (`split`), and
    so is memory. Compute runs at the bf16 peak for bf16 cells and at the
    float32 one (the CUDA cores: the port keeps float32 products in float32)
    for the others. The collective term is skipped when null, and
    `dominant` names the largest of the rest. `one_device` holds the
    one-card bound of the run, max(flops / peak, bytes / HBM rate).

Usage (on the CPU; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out dryrun_results.jsonl
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch
from torch.utils._pytree import tree_map

from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.tuning import H100
from repro_torch.launch import cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build

#: PyTorch's CUDA caching allocator hands out blocks in multiples of this
ALLOC_ROUND = 512
#: the steps that run the port's mesh paths (their collectives are counted)
MESH_VARIANTS = ("pp", "edgeshard", "splitkv")

TEMP_REASON = {
    "default": "the reference relies on GSPMD to partition this step; the port places "
               "tensors explicitly and has no partitioned executor for it",
    "mesh": "every shard of the mesh runs in one process: one_device_peak_bytes is "
            "all shards' together",
}


def shard_numel(shape, entries, mesh) -> int:
    """Elements of one device's block: each dim over its entry's parts,
    rounded up (XLA pads a dim that does not divide)."""
    entries = tuple(entries) + (None,) * (len(shape) - len(entries))
    return math.prod(-(-dim // sh.parts(mesh, e)) for dim, e in zip(shape, entries))


def per_device_bytes(tree, specs, mesh, align: int = 1) -> int:
    """Bytes one device holds of a tree of tensors whose partition entries
    are the tree `specs` beside it (None: the whole subtree replicated),
    each tensor's block rounded up to `align` bytes. Leaves that are not
    tensors (an int cache length, a seed) hold none."""
    if isinstance(tree, torch.Tensor):
        b = shard_numel(tuple(tree.shape), specs or (), mesh) * tree.element_size()
        return -(-b // align) * align
    if isinstance(tree, dict):
        return sum(per_device_bytes(v, None if specs is None else specs[k], mesh, align)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(per_device_bytes(v, None if specs is None else specs[i], mesh, align)
                   for i, v in enumerate(tree))
    return 0


def on_device(tree):
    """`tree` without its host scalars (the CPU tensors among a step's meta
    inputs: the cache length, the sampler's seed), which take no device
    memory."""
    return tree_map(lambda t: None if isinstance(t, torch.Tensor) and t.device.type == "cpu"
                    else t, tree)


def compute_peak(dtype: str) -> float:
    return H100.bf16_flops if dtype == "bfloat16" else H100.f32_flops


def _compute_dtype(spec, built) -> str:
    return spec.make_config().dtype if spec.family == "lm" else "float32"


def run_cell(arch: str, shape: str, multi_pod: bool, allow_bonus: bool = False,
             variant: str = "", mesh=None) -> dict:
    """One cell's record (see the module docstring); `mesh` overrides the
    production mesh (tests pass a local one)."""
    spec = configs.get(arch)
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    chips = math.prod(mesh.shape.values())
    rec = {
        "arch": arch, "shape": shape,
        "mesh": "x".join(str(v) for v in mesh.shape.values()),
        "chips": chips,
    }
    if variant:
        rec["variant"] = variant
    t0 = time.time()
    try:
        built = build(spec, shape, mesh, variant=variant)
        rec["note"] = built.note
        rec["kind"] = built.kind
        rec["model_flops"] = built.model_flops
        if built.skip and not allow_bonus:
            rec["status"] = "SKIP"
            rec["skip_reason"] = built.skip_reason
            return rec
        if built.skip:
            rec["bonus"] = True
        dtype = _compute_dtype(spec, built)
        inputs = built.make_inputs("meta")
        memory = dict(
            argument_bytes=per_device_bytes(inputs, built.in_shardings, mesh),
            argument_alloc_bytes=per_device_bytes(on_device(inputs), built.in_shardings, mesh,
                                                  ALLOC_ROUND),
            alias_bytes=sum(per_device_bytes(inputs[i], built.in_shardings[i], mesh)
                            for i in built.donate_argnums))
        with cost.counting(inputs) as counts:
            out = built.fn(*inputs)
        on_mesh = variant in MESH_VARIANTS
        memory.update(output_bytes=per_device_bytes(out, built.out_shardings, mesh),
                      temp_bytes=None, temp_reason=TEMP_REASON["mesh" if on_mesh else "default"],
                      one_device_peak_bytes=counts.peak_bytes)
        del out, inputs
        peak = compute_peak(dtype)
        rec.update(
            status="OK",
            run_s=round(time.time() - t0, 1),
            compute_dtype=dtype,
            memory=memory,
            flops=counts.flops,
            bytes_accessed=counts.bytes_accessed,
            kernels=cost.kernel_table(counts),
            collectives=counts.collectives() if on_mesh else None,
            analytic=built.analytic,
            one_device=dict(
                flops=counts.flops, bytes_accessed=counts.bytes_accessed,
                peak_bytes=counts.peak_bytes,
                bound_s=max(counts.flops / peak, counts.bytes_accessed / H100.hbm_bw)),
        )
        if not on_mesh:
            rec["collectives_reason"] = TEMP_REASON["default"]
        rec["roofline"] = roofline_terms(rec)
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def roofline_terms(rec: dict) -> dict:
    """Three-term roofline on the H100. LM cells take compute and memory
    from the analytic model (global flops over the chips, bytes a device);
    the others take the counted one-device flops and bytes over the chips
    (`split` "even"). The collective term is the wire bytes over NVLink,
    skipped when the record has none."""
    chips = rec["chips"]
    ana = rec.get("analytic") or {}
    peak = compute_peak(rec.get("compute_dtype", "bfloat16"))
    if ana:
        flops = ana["flops_global"] / chips
        b = ana["bytes_per_device"]
        split = "analytic"
    else:
        flops = (rec.get("flops") or 0.0) / chips
        b = (rec.get("bytes_accessed") or 0.0) / chips
        split = "even"
    coll = rec.get("collectives")
    terms = {"compute": flops / peak, "memory": b / H100.hbm_bw}
    if coll is not None:
        terms["collective"] = coll["wire_bytes"] / H100.nvlink_bw
    dom = max(terms.items(), key=lambda kv: kv[1])[0]
    mf = rec.get("model_flops") or 0.0
    bound = max(terms.values())
    return {
        "compute_s": terms["compute"],
        "memory_s": terms["memory"],
        "collective_s": terms.get("collective"),
        "dominant": dom,
        "split": split,
        "peak_flops": peak,
        "model_flops_ratio": mf / (flops * chips) if flops else None,
        # fraction of roofline: ideal time (model flops at peak) / bound time
        "roofline_frac": (mf / chips / peak) / bound if bound and mf else None,
    }


def cells_of(arch: str = "all", shape: str = "all") -> list:
    cells = configs.cells()
    if arch != "all":
        cells = [c for c in cells if c[0] == arch]
    if shape != "all":
        cells = [c for c in cells if c[1] == shape]
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--allow-bonus", action="store_true",
                    help="also run the long_500k decode bonus cells")
    ap.add_argument("--variant", default="",
                    help="step variant: 'zero1', 'pp' (pipeline-parallel train), "
                         "'splitkv' (decode), 'edgeshard' (GatedGCN)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    t0 = time.time()
    status = []
    with open(args.out, "a") as f:
        for arch, shape in cells_of(args.arch, args.shape):
            for mp in meshes:
                rec = run_cell(arch, shape, mp, allow_bonus=args.allow_bonus,
                               variant=args.variant)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                status.append(rec["status"])
                extra = ""
                if rec["status"] == "OK":
                    r = rec["roofline"]
                    frac = r["roofline_frac"] and round(r["roofline_frac"], 3)
                    extra = f" dom={r['dominant']} frac={frac} run={rec['run_s']}s"
                elif rec["status"] == "FAIL":
                    extra = " " + rec["error"][:160]
                print(f"[{rec['status']}] {arch} x {shape} x {rec['mesh']}{extra}", flush=True)
    counts = {s: status.count(s) for s in ("OK", "SKIP", "FAIL")}
    print(f"dryrun: {len(status)} records {counts} in {time.time() - t0:.1f} s", flush=True)
    return 1 if counts["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

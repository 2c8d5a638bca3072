"""Roofline report: reads the dry-run's records and prints each cell's
three-term table on the H100.

Counterpart of the reference's `benchmarks/roofline.py` (the port's
`benchmarks/` is not ported; this is a launcher of its own). The terms are
the dry-run's (`launch.dryrun.roofline_terms`, on `kernels.tuning.H100`);
the latest record of each (arch, shape, mesh, variant) counts.

  PYTHONPATH=src python -m repro_torch.launch.roofline dryrun_results.jsonl [mesh]
"""

from __future__ import annotations

import json
import os
import sys

from repro_torch.kernels.tuning import H100

GIB = 1024 ** 3


def load(path="dryrun_results.jsonl"):
    recs = {}
    if not os.path.exists(path):
        return []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"], r.get("variant", ""))] = r  # keep latest
    return list(recs.values())


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def main(path="dryrun_results.jsonl", mesh_filter=None):
    """One CSV line a record: the three terms, the dominant one, the model
    flops' share and the roofline fraction, then the per-device argument
    GiB, whether they fit the H100's memory, the one-device peak GiB of the
    meta run and the record's run seconds."""
    recs = load(path)
    rows = []
    hdr = ("cell", "mesh", "status", "compute", "memory", "collective",
           "dominant", "mflops_ratio", "roofline_frac", "args_gib", "args_fit",
           "one_device_peak_gib", "run_s")
    print(",".join(hdr))
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        cell = f"{r['arch']}/{r['shape']}" + (f"/{r['variant']}" if r.get("variant") else "")
        if r["status"] != "OK":
            print(f"{cell},{r['mesh']},{r['status']}" + ",-" * (len(hdr) - 3))
            continue
        rf, mem = r["roofline"], r["memory"]
        print(",".join(str(x) for x in (
            cell, r["mesh"], "OK",
            fmt_s(rf["compute_s"]), fmt_s(rf["memory_s"]),
            fmt_s(rf["collective_s"]), rf["dominant"],
            rf["model_flops_ratio"] and round(rf["model_flops_ratio"], 3),
            rf["roofline_frac"] and round(rf["roofline_frac"], 4),
            round(mem["argument_bytes"] / GIB, 4), mem["argument_bytes"] <= H100.hbm_bytes,
            round(mem["one_device_peak_bytes"] / GIB, 3), r["run_s"],
        )))
        rows.append(r)
    return rows


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))

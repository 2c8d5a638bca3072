#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run (RMAT scale 22)
    python3 chip_smoke.py --quick         # build + kernel sweeps only

Phases (any failure exits non-zero; nothing is caught):
  1. card      — nvidia-smi name and power limit, torch/CUDA versions;
  2. build     — nvcc builds every kernel (csrc/*.cu), one nvcc per source;
                 the wgmma flash library's SASS (cuobjdump -sass) must hold
                 HGMMA (wgmma) and UTMALDG (TMA loads), the TF32 flash
                 library's TF32 tensor-core instructions (HMMA...TF32),
                 ell_combine's and ell_spmm's LDG.E.128 (16-byte loads),
                 the wgmma flash backward's HGMMA and UTMALDG (its
                 USETMAXREG, setmaxnreg, counted), the TF32 flash
                 backward's HMMA...TF32 and no float atomics (RED/ATOM
                 .F32); registers and spills of every instance of both
                 flash backwards (the TF32 one's float32 Dh 64 causal
                 instances, the main path's, must not spill), and of the
                 TF32 flash kernel, ell_spmm and ell_combine_batched
                 (ptxas -v), the main path's
                 instances by name (ell_combine_batched: both routes at
                 Q = 8 and 64 for copy/sum, add_w/min, hop/min, mul_w/sum);
  3. kernels   — each CUDA kernel against its plain PyTorch version on the
                 card over shape sweeps: ell_combine bit-equal at W in
                 {1, 2, 3, 4, 5, 8, 12, 16, 32, 64, 128, 256}, both its
                 16-byte and scalar variants (views 4 bytes into their
                 storage among them); ell_combine_batched bit-equal to its
                 plain version at W in {1, 2, 3, 4, 5, 8, 32, 33, 256} and Q
                 in {1, 3, 4, 8, 16, 64, 65}, on both routes (slot lanes and
                 column lanes) at every Q, all 12 op pairs, sentinels
                 anywhere in a row, vals views 4 bytes into their storage,
                 sums also on values without BIG, and at Q = 1 to the 1-D
                 kernel; its deletion overlay bit-equal to the
                 plain version and to the kernel on the neutralized copy;
                 frontier_pack bit-equal; segment_reduce bit-equal to
                 segment_reduce_ordered (its fold order) for sum, min and
                 max, at segment lengths on each side of every tier limit,
                 D in {1, 3, 64}, num far above E, every id out of range and
                 E = 0, bit-equal to the plain version for min/max and for
                 sum within rtol 1e-5 of it run in float64, identical from
                 run to run; embedding_bag with ids from [-V - 3, V + 3),
                 max bit-equal to the plain version, sum and mean bit-equal
                 to `embedding_bag_ordered` (its fold order) and to a second
                 call and within rtol 1e-5 of the plain version; ell_spmm
                 over ragged R,
                 W in {1, 3, 4, 8, 32, 256}, D in {8, 10, 64, 70, 128}, float32
                 (rtol 1e-5) and bfloat16 (rtol 1.6e-2), with sentinels
                 anywhere in a row (a slice with none live among them), on
                 each layout `spmm_layout` picks (views 4 bytes into their
                 storage among them), each call repeated bit for bit;
                 flash_attention over ragged Sq and
                 Skv (across the tensor-core kernel's 128-row tiles), Sq <
                 Skv (decode offsets over several kv tiles), causal and not,
                 float32 (2e-4) and bfloat16 (5e-2, and 1e-2 in relative
                 norm), each call on the route `flash_attention.route` names
                 (bf16 with D % 8 == 0: wgmma; float32 and bf16 D = 12: the
                 TF32 kernel, in float32 also within 2e-4 of
                 `attention_3xtf32`, its plain version, and one decode row,
                 Sq = 1, Skv = 2048, among the shapes); in bfloat16 each is
                 also held within
                 ROUNDED_REL_ERR (5e-3) in relative norm of
                 `attention_rounded`, the plain version that rounds where the
                 kernels do, and a control shows that dropping key 0 from
                 every row moves `attention_rounded` by more than twice that;
  4. main path — RMAT scale 22, edge factor 16 (Graph500 a/b/c 0.57/0.19/
                 0.19, seed 1, undirected): each kernel timed at the main
                 path's shapes (ell_combine per slice, all 12 op pairs
                 bit-equal there, and at copy/sum beside torch.sparse.mm of
                 the slices' 0/1 CSR matrices; segment_reduce at the push
                 Combine's shape
                 and at each slice's pull-merge shape, each bit-equal to
                 segment_reduce_ordered), then bfs, sssp, wcc, pagerank and
                 kcore(16) through `engine.run` with the kernel pull,
                 counted (segment_reduce's launches split into one a push and
                 one a slice a pull); each is bit-equal to the torch pull
                 (metadata, traces, iterations); bfs and sssp equal scipy's
                 distances;
  5. diameter  — grid2d(1024): bfs and sssp under fusion none/all/pushpull
                 give equal results, equal to scipy's;
  6. slice     — the kernel library's second slice at full width, through
                 `kernels.ops` and `nn.layers`, counted: (a) the deletion
                 overlay on phase 4's ELL slices with 1 % of the real slots
                 dead, bit-equal to the kernel on the neutralized copy and to
                 the plain version, all Compute x Combine ops, and at
                 copy/sum beside torch.sparse.mm without the dead slots;
                 (b) ell_spmm
                 over the same slices at D = 64 (gin-tu) and D = 70
                 (gatedgcn); (c) embedding_bag over DeepFM's table (39 fields
                 x 100,000 rows x 10), B = 512, 16,384 and 262,144, sum and
                 mean, each bit-equal to `embedding_bag_ordered` and timed
                 beside its bound by bytes and by 32-byte sectors; (d) one
                 granite-3-8b attention layer (d_model 4096, 32/8 heads,
                 head_dim 128, B = 4, S = 1024) through
                 `gqa_attention(use_flash=True)` against `use_flash=False`,
                 in bf16 (the wgmma kernel) within 5e-2 and 1e-2 in
                 relative norm, and in float32 (the TF32 kernel) within
                 2e-4, each flash kernel alone likewise, the bf16 one also
                 within 5e-3 of `attention_rounded`; ell_spmm on each slice
                 bit-equal to a second call; each kernel timed beside its
                 plain version and, where one exists, a single PyTorch call
                 (float32 scaled_dot_product_attention's kernels named by
                 torch.profiler); the TF32 flash kernel's bound is three
                 TF32 products a product at 495 TFLOP/s, its CUDA-core
                 bound beside it, ell_spmm's bound beside the one without
                 padding weights and its rate of row requests;
  7. baselines — the paper's baseline engines (Fig. 5, Fig. 12) on RMAT-22
                 and grid2d(1024) against `engine.run`, each timed beside
                 it: run_atomic bfs and sssp, run_batch_filter bfs and the
                 ballot-only sssp bit-equal; run_atomic pagerank within rtol
                 1e-5 for one iteration (its whole run's deviation logged);
                 the online-only bfs overflows on RMAT-22 at frontier_cap 64
                 and on the grid at 256, and at the grid's side (1024, edge
                 cap 4096) runs to the end bit-equal to full bfs;
  8. batched   — `serving.run_batch` at RMAT-22 with `default_config`:
                 ell_combine_batched on each slice at Q = 8 and 64 (its
                 route and lanes logged; copy/sum and add_w/min, at Q = 64
                 hop/min and mul_w/sum too, each bit-equal to the plain
                 version) beside its byte bound, plain version and
                 torch.sparse.mm; segment_reduce at D = 64 at the union
                 push's shape (E = 2n) and each pull merge's, beside
                 index_add_; then 64
                 sources (vertex 0, 62 seeded draws of nonzero degree, one
                 repeated): bfs, sssp and ppr at Q = 64 counted
                 (ell_combine_batched, segment_reduce and frontier_pack
                 launches against the steps taken), 8 lanes bit-equal to solo
                 engine.run, bfs/sssp lanes equal to scipy, warm times and
                 queries/s at Q = 1, 8, 64, pagerank at Q = 2, the masked
                 pull of ppr (its drift logged) and ppr_delta (bit-equal),
                 telemetry counters, peak device memory;
  9. serving   — `serving.GraphServer` on phase 4's RMAT-22 graph: the
                 path's kernels at its shapes against their plain versions
                 (`ell_combine_batched` at Q = 32, `segment_reduce` at
                 D = 32 on the union push and the merges, `frontier_pack`
                 at the union's cap); (a) bfs, sssp and ppr from `launch.catalog.make_catalog()`, 32
                 slots each, `default_config`, cache 64 (a cached result is
                 16.8 MB of host memory), queue cap 48, 384 requests drawn
                 as `serve_graph` draws them (numpy seed 0, hot fraction
                 0.25, sources of nonzero degree), counted: every request
                 completes, no lane owned after `drain`, pool host reads =
                 steps + rounds of admissions, no `device_fetch`, the first
                 8 engine-served completions of each algorithm and the
                 last 8 admitted into recycled lanes bit-equal to solo
                 `engine.run`, one bfs and one sssp equal to scipy,
                 cache hits bit-equal to their key's first completion;
                 queries/s beside `run_batch` at Q = 32 on the stream's
                 sources (the scheduler's overhead), host time of admission,
                 harvest and pool reads in the stream, admission on its own
                 pools; (b) the same stream with telemetry, bit-equal,
                 latency p50/p95/p99 a pool, audit summary, fetches a round;
                 (c) ppr_delta, 4 lanes of a pool of 5: one preempted and
                 resumed in another lane, bit-equal to the 4 run through, and a degraded ppr_delta stream that
                 caches no degraded result; (d) `launch.serve_graph` at
                 RMAT-16 with telemetry (`--profile`: one warm pump round
                 under torch.profiler);
 10. streaming — phase 4's RMAT-22 graph under edge updates: (a) a
                 `StreamingGraph` at delta_cap 1024 (device sweeps), ten
                 batches of 64 inserts (weights 1-64) and 32 deletes of live
                 base edges drawn as `stream_graph` draws them (seed 0), so
                 the pending insertions pass the cap and the CSR is rebuilt
                 and repacked; then a compaction begun, a batch mid-flight
                 and the compaction finished; after each, bfs and sssp from
                 two sources through `engine.run(delta=)` bit-equal to runs
                 on the graph folded from the live edges; apply time split
                 into edits, sweeps, boundary, materialize and rebuild;
                 dirty/affected/boundary sizes; then the path's kernels at
                 its shapes against their plain versions (ell_combine_batched
                 at Q = 32 and ell_combine on the overlay's slices and a
                 full delta slice with receivers out of order and repeated,
                 segment_reduce at D = 32 on the union push with delta lanes,
                 E = 2n + cap, and on the delta merge, frontier_pack);
                 (b) `incremental_batch` after an insert+delete batch at
                 Q = 32 (bfs, sssp, wcc, ppr, ppr_delta) and after a
                 deletion-only batch at Q = 1 (kcore(16) cascade, mis
                 reelect), each timed beside `run_batch` from scratch on
                 the same views, bit-equal (ppr_delta within 2e-3);
                 (c) `GraphServer(delta_cap=1024)` of bfs, sssp, ppr_delta,
                 32 slots each, cache 64, queue cap 48: 192 requests drawn
                 as `stream_graph` draws them (hot 0.25, seed 0, nonzero
                 degree) with an update batch every 32, each update's
                 counts and time logged, every completion held against
                 `run_batch` on the views of its version (bit-equal,
                 ppr_delta within 1e-3), queries/s, peak memory;
                 (d) `launch.stream_graph --verify` at RMAT-16;
 11. sharded   — SLO replay and sharded serving on the same graph, every
                 mesh a grid of this one card (cuda:0 four times): (k) the
                 path's kernels at its shapes against their plain versions,
                 timed beside their bounds and library calls: segment_reduce
                 at D = 8 on edge shard 0's scan of a (1, 4) mesh (32.6 M
                 sorted destinations), frontier_pack of the shard's
                 union-frontier edge mask at the compacted scan's cap,
                 ell_combine_batched at Q = 8 (a replicated query shard's
                 pull); (a) `run_sharded` against `run_batch` on phase 8's
                 sources: replicated (4, 1) at Q = 32, bfs/sssp/ppr lanes
                 and mode trace bit-equal; edge-sharded (1, 4) at Q = 8,
                 bfs/sssp bit-equal with the compacted scan on and off,
                 ppr/ppr_delta within rtol 1e-5, atol 1e-7; a (1, 1) mesh
                 bit-equal for all four; queries/s, per-shard scan volumes,
                 peak memory; (b) two placed `GraphServer`s (bfs, sssp, ppr
                 replicated (4, 1) at 32 slots; bfs, sssp, ppr_delta
                 edge-sharded (1, 4) at 8 slots), 64 requests each as
                 `stream_graph` draws them with phase 10's update batch
                 every 32, every completion held against `run_batch` on its
                 version's views, each update's `shipped` logged; (c)
                 `repro_torch.slo.replay` of a 10 s mmpp workload (burst
                 factor 6; "paid" bfs/sssp with a 1.5 s deadline, "batch"
                 ppr_delta best effort) at phase 9's served rate with an
                 update every 2.5 s, after `warmup`, on one device with the
                 full policy and on a (4, 1) mesh with its drop half: zero
                 crashed lanes, every offered query accounted for, goodput
                 > 0, the last 8 engine-served completions of each
                 algorithm held against `run_batch`; (d) `slo_replay
                 --assert-goodput --trace` (one device, `--mesh 4x1`),
                 `obs_report` and `scripts/trace_schema.py` on its trace,
                 `serve_graph --mesh 1x4 --placement edge_sharded --verify`
                 and `stream_graph --mesh 4x1 --verify` at RMAT-16;
 12. models    — the model stacks' serving path at the published widths
                 (`repro_torch.models`, `launch.serve.serve`), each part
                 counted with the launch counts set to 0 just before it:
                 (a) granite-3-8b (40 layers, d_model 4096, 32/8 heads, Dh
                 128, d_ff 12800, vocab 49155 padded to 51200; 8.37 B
                 parameters, 16.8 GB of bf16 weights drawn on the card from
                 a seeded generator) serving the reference launcher's
                 defaults (4 slots, 8 requests, prompt 16, gen 24, max_len
                 64, seed 0) and one (2, 1024) forward (the flash kernel);
                 tokens/s, prefill and decode ms, the cache copies, peak
                 memory; check 1: the last decode step's logits against
                 `forward` over the same tokens, check 2: the forward
                 against the same forward with plain attention, both within
                 LOGITS_REL_ERR in relative norm (and the dense forward no
                 further than EXACT_RATIO x the plain one from a forward with
                 float64 attention); (b) granite-moe-1b-a400m (24 layers, 32
                 experts top 8, Dh 64) the same, its MoE combine on
                 segment_reduce (checks at capacity factor 8); (c) DeepFM
                 (39 fields x 100,000 rows x 10, MLP 400-400-400) forward at
                 B = 512 and 262,144 and user_vector + score_candidates over
                 1,000,000 candidates (embedding_bag), against the plain
                 route; (d) gcn-cora and gatedgcn on a 2,708-node uniform
                 graph (d_feat 1,433), gin-tu and DimeNet on 128 molecules
                 of 30 nodes / 64 edges (segment_reduce), against the plain
                 route (rtol 1e-4). Every kernel call of the counted runs
                 (up to KEEP_CALLS a shape) is then held against its plain
                 version on its own inputs and each shape timed beside its
                 bound, plain version and library call;
 13. acclint   — the port's acclint (`repro_torch.launch.acclint`) on the
                 card, with the launch counts set to 0 just before it: every
                 backend over the whole catalog at its default scale 6 must
                 exit 0 with no stale suppression (checked counts, active,
                 suppressed and stale counts and each backend's seconds
                 logged; the trace backend runs each engine step under the
                 sync debug mode and captures it in a CUDA graph, bit-equal
                 on replay); then the trace backend's solo and batched
                 entries of bfs, sssp and pagerank on phase 4's RMAT-22
                 graph (re-packed), none outside the baseline; then
                 `--fixtures`, which must exit 1 with every rule of the
                 port's RULES fired (ACC-J102 and J103 among them); the
                 phase must launch segment_reduce (the combiner probes and
                 every captured Combine), frontier_pack, ell_combine and
                 ell_combine_batched;
 14. training  — the training path (`repro_torch.launch.train`, `optim`,
                 `data`, `checkpoint`, the models' `loss_fn`s): (a) the
                 flash backward that `route_bwd` picks, given its forward's
                 lse (`csrc/flash_attention_bwd_wgmma.cu` for bfloat16
                 with Dh % 8 == 0; `csrc/flash_attention_bwd.cu`, TF32
                 mma.sync, for the rest), one launch a call under its own
                 counter, against float64 autograd of
                 `attention_plain` on the same inputs over BWD_SWEEP (Sq
                 and Skv ragged across the tiles, Sq < Skv and Sq > Skv,
                 Hq / Hkv 1 to 8, Dh 12 to 128), float32 within
                 BWD_F32_ERR of the largest entry, bfloat16 within
                 BWD_BF16_REL_ERR in relative norm, the wgmma kernel also
                 within BWD_ROUNDED_REL_ERR of `attention_bwd_rounded` and
                 the TF32 one in float32 within BWD_F32_ERR of
                 `attention_bwd_3xtf32`, causal and not, every call
                 repeated bit-equal, and as a control the gradients with key 0's row of dK and dV
                 dropped must miss both;
                 (b) the gradient scatters (`gather_rows`, the sum
                 backwards of segment_reduce and embedding_bag) at the main
                 path's shapes, bit-equal on a repeat and within the
                 float32 bound of the float64 sum; (c) granite-moe-1b-a400m
                 at its published width and depth in bf16, TRAIN_STEPS
                 steps of `train_step` at B = 8, S = 1024, counted: the
                 loss falls, s/step, tokens/s, peak memory, launches; one
                 step's gradients twice, bit-equal, finite and nonzero;
                 (d) `python -m repro_torch.launch.train` on the 100m
                 preset for 20 steps, then resumed from step 10: the
                 resumed step-20 checkpoint bit-equal to the straight
                 run's, the straight run's launches (its summary line)
                 counted, float32 flash and its backward among them; (e)
                 five AdamW steps each of DeepFM (ClickStream, B = 4,096),
                 gcn-cora, gatedgcn, gin-tu and DimeNet at phase 12's
                 widths, counted, their first gradients against the
                 kernels' fold-order plain route in float64; then the
                 flash backward at BWD_TIMED's shapes (granite-moe's layer
                 in bf16 and float32, granite-3-8b's, (d)'s 100m layer in
                 float32), held against float64 autograd and timed beside
                 its bound, plain version and the backward of
                 scaled_dot_product_attention (query heads permuted to the
                 port's h % Hkv map); (c) must launch only the wgmma
                 backward, once a layer a step, and (d) only the TF32
                 one, likewise;
 15. distributed — run right after phase 4, on its RMAT-22 graph (after
                 phase 14 the caching allocator is too fragmented for its
                 60 GiB): the distributed stack (`repro_torch.distributed`,
                 `nn.decode_attn`, `models.gnn.make_edgesharded_gatedgcn`), every
                 mesh a grid of this one card (cuda:0), each part counted with
                 the launch counts set to 0 just before it: (e) the min/max
                 backwards of segment_reduce (the push Combine's sorted
                 destinations, E = m at D = 1 and a sorted sample of 2n at
                 D = 64, min and max) and embedding_bag (max, phase 6's
                 DeepFM bags at B = 16,384), values from a few integers so ties
                 abound, each gradient bit-equal to the kernels' fold-order
                 plain route and on a repeat, its shares summing back to the
                 cotangent; (c) the edge-sharded GatedGCN at phase 12's
                 gatedgcn cell (16 layers, d 70, d_in 1,433, 2,708 nodes,
                 edges padded to a multiple of 4) on (1, 4) and (2, 2) against
                 the (1, 1) run (loss and gradients within GNN_REL_ERR of the
                 largest entry), a repeat bit-equal; (a) granite-3-8b at its
                 published width in bf16, depth cut to DIST_LAYERS, 4 micros
                 of (1, 1,024): pipeline_tp on (4, 1), (2, 2), (1, 2) and
                 (3, 1) (one identity padding layer) and pipeline on (4, 1)
                 against the single-device loss_fn + autograd (loss within
                 5e-3 of the bf16 step's; each gradient leaf no further from
                 the float32 step's than EXACT_RATIO times the bf16 step's
                 in relative norm and DIST_MAX_RATIO times in its largest
                 entry; padding gradients zero), flash forward and backward and
                 segment_reduce launches equal to the schedule's count, s a
                 step and peak memory, the (2, 2) run repeated bit-equal and
                 its kernel calls held against their plain versions; (d) the
                 bf16 and top-k (k_frac 0.01) compressed all-reduce over 4
                 'data' shards of (a)'s gradient tree (a leaf a layer,
                 as `layer_stack` hands them to the model), against the float64
                 fold of what the shards sent, send + residual bit-equal to
                 gradient + residual, and each top-k shard's selection
                 checked (k distinct entries, none left behind larger, ties
                 taken lowest index first); (b) granite-3-8b at full width and
                 depth, split-KV decode of B = 4 against a 32,768-token cache
                 (seeded, len = seq - 1) on a (1, 4) mesh: each layer's
                 attention within 1e-2 (relative norm) of the unsharded
                 decode's, logits within LOGITS_REL_ERR, ms a step of both;
 16. report    — the `kernels` JSON line (all eleven kernels, flash as two
                 forward routes and two backward routes; ell_combine, the batched
                 pull, segment_reduce and frontier_pack count phases 9, 10,
                 11 and 13's launches too, flash, segment_reduce and
                 embedding_bag phases 12, 14 and 15's (with the launches of
                 14 (d)'s subprocess), which each kernel's
                 `model_path` lists by shape), the card line, then the last
                 line {"ok": true, "device": {...}}.

Kernel times are CUDA-event means over a run of calls. Kernels under 0.1 ms
(frontier_pack, embedding_bag, the segment_reduce merges) and their library
calls (torch.nonzero_static, F.embedding_bag, index_add_, scatter_reduce_)
take the median of 7 event-timed batches of 50 calls
replayed from a CUDA graph: the card's time, without the Python function's
host time. Beside them are logged, for kernel and library call alike, the
median of 7 event-timed batches of 50 calls through the Python function
(torch.nonzero, which waits for its count on the host, for the library) and
the host time to enqueue one call.

It exits non-zero, printing no result, where torch.cuda.is_available() is
false or the package is missing beside it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # dense TF32 on the tensor cores (H100 SXM data sheet)
BF16_OPS_PER_S = 989e12        # dense bf16 on the tensor cores (H100 SXM data sheet)
#: embedding_bag's batches over DeepFM's table: serve_p99 and serve_bulk
#: (src/repro/configs/registry.py:37-38), and 16,384 between them
BAG_BATCHES = (512, 16_384, 262_144)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def cuda_ms(fn, iters: int = 20, warm: int = 3, batches: int = 1) -> float:
    """Time of one call of `fn` on the card: the median over `batches` of
    the mean of `iters` calls between CUDA events (several batches for
    kernels of tens of microseconds, whose single runs spread widely on a
    shared host)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[batches // 2]


def graph_ms(fn, batches: int = 7, per: int = 50) -> float:
    """Like `cuda_ms(fn, per, batches=batches)`, with the `per` calls
    captured once in a CUDA graph and replayed: the card's time for the
    calls, without the Python wrapper's host time (a kernel of ~10
    microseconds launched from Python is otherwise timed by the host's
    enqueue rate)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    return cuda_ms(graph.replay, 1, 1, batches) / per


def host_us(fn, calls: int = 200) -> float:
    """Host time to enqueue one call of `fn` (no synchronisation inside)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries that differ (equal infinities count 0)."""
    diff = torch.where(a == b, 0.0, (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def rel_max(a: torch.Tensor, exact: torch.Tensor) -> float:
    """Largest |a - exact| / |exact| over entries, in float64."""
    d = (a.double() - exact).abs() / exact.abs().clamp(min=1e-30)
    return float(d.max()) if d.numel() else 0.0


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over all entries, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_rel(what: str, a: torch.Tensor, b: torch.Tensor, limit: float) -> None:
    """Raise if `a` is further than `limit` from `b` in relative norm."""
    r = rel_err(a, b)
    if not r <= limit:
        raise AssertionError(f"{what}: relative norm error {r:.3g} > {limit}")


def dropped_key_control(fa, q, k, v, causal: bool, ref: torch.Tensor) -> float:
    """Relative norm by which dropping key 0 from every row moves
    `ref` = `attention_rounded(q, k, v, causal)`: the size of a fault the
    bfloat16 check must see (causal with Sq == Skv leaves out row 0, which
    would see no key)."""
    lo = 1 if causal and q.shape[2] == k.shape[2] else 0
    dropped = fa.attention_rounded(q[:, :, lo:], k[:, :, 1:], v[:, :, 1:], causal)
    return rel_err(dropped, ref[:, :, lo:])


def ptxas_instances(report: str) -> list[tuple[str, int, int]]:
    """(mangled name, spill bytes, registers) of each kernel in nvcc's
    `-Xptxas -v` report."""
    found = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                       r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
                       r"(\d+) registers", report)
    return [(name, int(st) + int(ld), int(regs)) for name, st, ld, regs in found]


def bound_ms(nbytes: float, ops: float, peak: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def sweep_ell(dev, rng, ell) -> float:
    """ell_combine bit-equal to its plain version for every op pair, over
    widths on both variants: the 16-byte one (W % 4 == 0, aligned) and the
    scalar one (other widths, and views that start 4 bytes in)."""
    shapes = [(8, 4, 50), (64, 16, 200), (128, 32, 1000), (24, 256, 300),
              (13, 4, 50), (37, 32, 100), (29, 256, 700), (100, 1, 60),
              (9, 3, 40), (17, 64, 90), (11, 128, 90), (5, 8, 30), (1, 2, 10),
              (40, 5, 60), (21, 12, 70), (3001, 256, 5000)]
    unaligned = [(13, 4, 50), (37, 32, 100), (29, 256, 700), (9, 3, 40), (40, 5, 60)]
    worst = 0.0
    for (r, w, n), shift in [(x, 0) for x in shapes] + [(x, 1) for x in unaligned]:
        nb = rng.integers(0, n + 1, size=r * w + shift).astype(np.int32)
        wg = rng.random(r * w + shift).astype(np.float32)
        # a view `shift` elements into its storage (4 bytes: not 16-aligned)
        nbr = torch.from_numpy(nb).to(dev)[shift:].view(r, w)
        wgt = torch.from_numpy(wg).to(dev)[shift:].view(r, w)
        vec = ell.vector_layout(w, nbr.data_ptr(), wgt.data_ptr())
        if vec != (w % 4 == 0 and shift == 0):
            raise AssertionError(f"ell_combine W={w} shift={shift}: vector layout {vec}")
        v = rng.random(n + 1).astype(np.float32)
        v[rng.random(n + 1) < 0.2] = ell.BIG
        v[-1] = 0.0
        vals = torch.from_numpy(v).to(dev)
        for op in ell.COMPUTE_OPS:
            for comb in ell.COMBINE_OPS:
                a = ell.ell_combine_cuda(nbr, wgt, vals, op, comb)
                b = ell.ell_combine_plain(nbr, wgt, vals, op, comb)
                torch.cuda.synchronize()
                if not bit_equal(a, b):
                    raise AssertionError(f"ell_combine {op}/{comb} R={r} W={w} n={n} "
                                         f"shift={shift} differs")
                worst = max(worst, abs_err(a, b))
    return worst


def other_route(ell, q: int, w: int, vec: bool):
    """The `ell_combine_batched` route `batched_layout` does not pick at this
    Q, laid out as `route_layout` lays it out."""
    other = "slots" if ell.batched_layout(q, w, 0, 0).route == "columns" else "columns"
    return ell.route_layout(other, q, w, vec)


def sweep_batched(dev, rng, ell) -> float:
    """ell_combine_batched bit-equal to its plain version for every op pair,
    at W in {1, 2, 3, 4, 5, 8, 32, 33, 256} and Q in {1, 3, 4, 8, 16, 64,
    65}, with sentinels anywhere in a row, on both routes (the one
    `batched_layout` picks and the other), each with float4 columns where
    Q % 4 == 0 and vals is aligned and scalar columns for other Q and for a
    vals view 4 bytes into its storage; values of both signs over two
    decades (BIG among them for min and max; a sum's order shows only
    without it) and over six decades with BIG among them; at Q = 1 also
    bit-equal to the 1-D ell_combine kernel."""
    worst = 0.0
    for w in (1, 2, 3, 4, 5, 8, 32, 33, 256):
        r, n = 41, 500
        nb = rng.integers(0, n, (r, w)).astype(np.int32)
        nb[rng.random((r, w)) < 0.3] = n                      # sentinels anywhere
        nbr = torch.from_numpy(nb).to(dev)
        wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(dev)
        for q in (1, 3, 4, 8, 16, 64, 65):
            size = (n + 1) * q + 1
            cases = []
            for comb in ell.COMBINE_OPS:
                v = (rng.standard_normal(size) * 10 ** rng.uniform(-1, 1, size)).astype(np.float32)
                if comb != "sum":
                    v[rng.random(size) < 0.2] = ell.BIG
                cases.append((comb, torch.from_numpy(v).to(dev)))
            # six decades with BIG among them, for every combine, from a
            # generator of their own: the shared `rng` feeds the later sweeps,
            # whose inputs (the flash sweep's dropped-key control among them)
            # must not move with this sweep's cases
            own = np.random.default_rng(w * 1000 + q)
            v = (own.standard_normal(size) * 10 ** own.uniform(-3, 3, size)).astype(np.float32)
            v[own.random(size) < 0.2] = ell.BIG
            cases += [(comb, torch.from_numpy(v).to(dev)) for comb in ell.COMBINE_OPS]
            for shift in (0, 1):
                vec = q % 4 == 0 and shift == 0
                other = other_route(ell, q, w, vec)
                for op in ell.COMPUTE_OPS:
                    for comb, flat in cases:
                        vals = flat[shift:shift + (n + 1) * q].view(n + 1, q)
                        if ell.batched_layout(q, w, vals.data_ptr(), 0).vector != vec:
                            raise AssertionError(f"ell_combine_batched Q={q} shift={shift}: "
                                                 f"vector layout is not {vec}")
                        b = ell.ell_combine_batched_plain(nbr, wgt, vals, op, comb)
                        a = ell.ell_combine_batched_cuda(nbr, wgt, vals, op, comb)
                        c = ell._launch_batched(nbr, wgt, vals, op, comb, other)
                        torch.cuda.synchronize()
                        if not (bit_equal(a, b) and bit_equal(c, b)):
                            raise AssertionError(f"ell_combine_batched {op}/{comb} W={w} Q={q} "
                                                 f"shift={shift} differs from its plain version "
                                                 f"(picked route {bit_equal(a, b)}, {other} "
                                                 f"{bit_equal(c, b)})")
                        if q == 1 and not bit_equal(
                                a[:, 0].contiguous(),
                                ell.ell_combine_cuda(nbr, wgt, vals[:, 0].contiguous(), op, comb)):
                            raise AssertionError(f"ell_combine_batched {op}/{comb} W={w} Q=1 "
                                                 "differs from the 1-D kernel")
                        worst = max(worst, abs_err(a, b))
    return worst


def sweep_pack(dev, rng, fp) -> float:
    cases = [(1024, 0.1, None), (4096, 0.5, None), (2048, 0.95, None),
             (512, 0.0, None), (1000, 0.3, None), (3001, 0.95, None),
             (3001, 0.0, None), (5000, 0.5, 100), (1, 1.0, 1), (4096, 0.5, 0),
             (1 << 20, 0.5, None), (1 << 20, 0.01, 1000)]
    for n, dens, cap in cases:
        cap = n if cap is None else cap
        mask = torch.from_numpy(rng.random(n) < dens).to(dev)
        a = fp.frontier_pack_cuda(mask, cap)
        b = fp.frontier_pack_plain(mask, cap)
        torch.cuda.synchronize()
        for x, y, what in zip(a, b, ("ids", "count", "overflow")):
            if not bit_equal(x, y):
                raise AssertionError(f"frontier_pack n={n} density={dens} cap={cap}: {what} differs")
        exp = np.nonzero(mask.cpu().numpy())[0][:cap]
        if not np.array_equal(a[0].cpu().numpy()[: len(exp)], exp):
            raise AssertionError(f"frontier_pack n={n}: ids are not the set lanes")
    return 0.0


def segment_cases(rng, sr) -> list:
    """(E, D, ids, num) cases for segment_reduce: segment lengths on each side
    of every tier limit (1, THREAD_SEG and one more, 32, 33, LONG_SEG and one
    more), long ones first and last, gaps (empty segments), ids out of range
    at both ends; num far above E; every id out of range; E = 0; and random
    draws."""
    edges = [1, sr.THREAD_SEG, sr.THREAD_SEG + 1, 32, 33, sr.LONG_SEG, sr.LONG_SEG + 1]
    cases = []
    for d in (1, 3, 64):
        lens = edges + [int(x) for x in rng.integers(1, 70, 40)] + edges[::-1]
        lens = [sr.LONG_SEG + 1] + lens + [5000, sr.LONG_SEG + 1]
        seg = np.cumsum(rng.integers(1, 4, len(lens)))          # gaps of 0 .. 2
        num = int(seg[-1]) + 3
        ids = np.concatenate([[-5, -1], np.repeat(seg, lens), [num, num + 7]])
        cases.append((d, ids.astype(np.int32), num))
    sparse = np.sort(rng.choice(1_000_000, 1000, replace=False))
    cases.append((1, np.repeat(sparse, rng.integers(1, 12, 1000)).astype(np.int32), 1_000_003))
    cases.append((3, np.array([-3, -2, 9, 9, 12], np.int32), 9))       # all out of range
    cases.append((1, np.full(4000, 20, np.int32), 10))                 # all past num
    cases.append((1, np.zeros(0, np.int32), 7))                        # E = 0
    cases.append((64, np.zeros(0, np.int32), 7))
    for e, d, s, oob in [(256, 4, 16, 0), (2048, 16, 64, 0), (512, 8, 10, 0),
                         (1000, 1, 50, 0), (20000, 1, 5, 0), (50, 1, 100, 0),
                         (3000, 1, 40, 3), (9000, 2, 3, 0), (0, 1, 7, 0)]:
        cases.append((d, np.sort(rng.integers(-oob, s + oob, size=e)).astype(np.int32), s))
    return cases


def check_segment(sr, vals, sid, num, what: str) -> float:
    """segment_reduce on the card against segment_reduce_ordered (bit-equal,
    sum, min and max) and segment_reduce_plain (bit-equal for min/max; for
    sum within rtol 1e-5 of the plain version run in float64, since the
    float32 plain version's `index_add_` adds in an order that changes from
    run to run and strays by more than that on a hub of 10^5 rows); twice
    for sum, bit-equal. Returns the worst |kernel - plain| of the sums."""
    worst = 0.0
    for comb in ("min", "max", "sum"):
        for fill in (None, float("inf") if comb == "min" else float("-inf")):
            a = sr.segment_reduce_cuda(vals, sid, num, comb, fill)
            o = sr.segment_reduce_ordered(vals, sid, num, comb, fill)
            b = sr.segment_reduce_plain(vals, sid, num, comb, fill)
            torch.cuda.synchronize()
            if not bit_equal(a, o):
                raise AssertionError(f"segment_reduce {comb} {what} differs from "
                                     "segment_reduce_ordered")
            if comb == "sum":
                if not bit_equal(a, sr.segment_reduce_cuda(vals, sid, num, comb, fill)):
                    raise AssertionError(f"segment_reduce sum {what} not deterministic")
                exact = sr.segment_reduce_plain(vals.double(), sid, num, comb, fill)
                torch.testing.assert_close(a.double(), exact, rtol=1e-5, atol=1e-6)
                worst = max(worst, abs_err(a, b))
                if what.startswith("at the") and fill is None:
                    log(f"[4 main] segment_reduce sum {what}: largest relative error against "
                        f"float64, kernel {rel_max(a, exact):.3g}, float32 plain version "
                        f"{rel_max(b, exact):.3g}")
            elif not bit_equal(a, b):
                raise AssertionError(f"segment_reduce {comb} {what} differs from plain")
    return worst


def sweep_segment(dev, rng, sr) -> float:
    worst = 0.0
    for d, ids, num in segment_cases(rng, sr):
        e = ids.shape[0]
        v = rng.random((e, d)).astype(np.float32)
        vals = torch.from_numpy(v[:, 0] if d == 1 else v).to(dev).contiguous()
        sid = torch.from_numpy(ids).to(dev)
        worst = max(worst, check_segment(sr, vals, sid, num, f"E={e} D={d} num={num}"))
    return worst


def sweep_overlay(dev, rng, ell) -> float:
    """The deletion overlay: bit-equal to the plain version and to the
    kernel without a mask on the neutralized copy, for every op pair."""
    for r, w, n in [(8, 4, 50), (13, 4, 50), (37, 32, 100), (29, 256, 700),
                    (9, 3, 40), (100, 1, 60), (3001, 256, 5000)]:
        nbr = torch.from_numpy(rng.integers(0, n + 1, size=(r, w)).astype(np.int32)).to(dev)
        wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(dev)
        v = rng.random(n + 1).astype(np.float32)
        v[rng.random(n + 1) < 0.2] = ell.BIG
        vals = torch.from_numpy(v).to(dev)
        dead = torch.from_numpy(rng.random((r, w)) < 0.3).to(dev)
        neutral = ell.neutralize(nbr, dead, n)
        for op in ell.COMPUTE_OPS:
            for comb in ell.COMBINE_OPS:
                a = ell.ell_combine_cuda(nbr, wgt, vals, op, comb, dead.to(torch.int8))
                b = ell.ell_combine_plain(nbr, wgt, vals, op, comb, dead)
                c = ell.ell_combine_cuda(neutral, wgt, vals, op, comb)
                torch.cuda.synchronize()
                if not (bit_equal(a, b) and bit_equal(a, c)):
                    raise AssertionError(f"overlay {op}/{comb} R={r} W={w} n={n} differs")
    return 0.0


def sweep_spmm(dev, rng, ell) -> float:
    """ell_spmm against its plain version over widths, feature widths and
    types, with a third of the slots sentinels at random places in their
    rows (and a slice with no live slot); each layout `spmm_layout` picks:
    16-byte ids on aligned W % 4 == 0 slices, 4-byte ones on other widths
    and on views 4 bytes into their storage; 16-, 8-, 4- or 2-byte feature
    loads by D, type and alignment (a feature view 4 bytes in among them).
    Each call is repeated and must give the same bits."""
    worst = 0.0
    cases = [(13, 1, 50, 0, 0.3), (40, 3, 90, 0, 0.3), (777, 32, 3000, 0, 0.3),
             (29, 256, 700, 0, 0.3), (1, 256, 300, 0, 0.3), (64, 4, 80, 0, 0.0),
             (37, 32, 100, 1, 0.3), (29, 256, 700, 1, 0.5), (50, 8, 60, 0, 1.0)]
    for r, w, n, shift, sent in cases:
        nb = rng.integers(0, n, size=r * w + shift).astype(np.int32)
        nb[rng.random(r * w + shift) < sent] = n         # sentinels anywhere in a row
        nbr = torch.from_numpy(nb).to(dev)[shift:].view(r, w)
        wgt = torch.from_numpy(rng.random(r * w + shift).astype(np.float32)).to(dev)
        wgt = wgt[shift:].view(r, w)
        for d in (8, 10, 64, 70, 128):
            f = rng.random((n + 2, d)).astype(np.float32)
            f[n] = 0.0
            for dt in (torch.float32, torch.bfloat16):
                for fshift in ((0, 1) if d == 64 else (0,)):
                    # (n + 1, D) rows, `fshift` elements into their storage
                    feats = torch.from_numpy(f).to(dev).to(dt).flatten()
                    feats = feats[fshift:fshift + (n + 1) * d].view(n + 1, d)
                    a = ell.ell_spmm_cuda(nbr, wgt, feats)
                    vec, fvec = ell.spmm_layout(w, d, dt, nbr.data_ptr(), wgt.data_ptr(),
                                                feats.data_ptr(), a.data_ptr())
                    if vec != (w % 4 == 0 and shift == 0):
                        raise AssertionError(f"ell_spmm W={w} shift={shift}: vec_ids {vec}")
                    if fshift and fvec != 1:
                        raise AssertionError(f"ell_spmm D={d} {dt} view: {fvec} columns a load")
                    b = ell.ell_spmm_plain(nbr, wgt, feats)
                    again = ell.ell_spmm_cuda(nbr, wgt, feats)
                    torch.cuda.synchronize()
                    if a.dtype != dt:
                        raise AssertionError(f"ell_spmm returned {a.dtype} for {dt}")
                    if not bit_equal(a, again):
                        raise AssertionError(f"ell_spmm R={r} W={w} D={d} {dt} not "
                                             "deterministic")
                    tol = 1e-5 if dt == torch.float32 else 1.6e-2
                    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
                    if dt == torch.float32:
                        worst = max(worst, abs_err(a, b))
    return worst


def sweep_bag(dev, rng, bag) -> float:
    """embedding_bag with ids drawn from [-V - 3, V + 3) (wrapped, then
    clamped): sum and mean bit-equal to `embedding_bag_ordered` (its fold
    order) and to a second call, within rtol 1e-5 of the plain version; max
    bit-equal to the plain version."""
    worst = 0.0
    for v, d, b, k in [(1000, 10, 100, 39), (50, 64, 33, 4), (70, 70, 5, 1),
                       (300, 3, 17, 200), (500, 128, 64, 8), (40, 1, 9, 2), (90, 256, 3, 3),
                       (2000, 10, 4001, 39), (80, 10, 13, 1)]:
        table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(-v - 3, v + 3, size=(b, k)).astype(np.int32)).to(dev)
        for mode in bag.MODES:
            a = bag.embedding_bag_cuda(table, idx, mode)
            p = bag.embedding_bag_plain(table, idx, mode)
            torch.cuda.synchronize()
            if mode == "max":
                if not bit_equal(a, p):
                    raise AssertionError(f"embedding_bag max V={v} D={d} differs")
            else:
                if not bit_equal(a, bag.embedding_bag_ordered(table, idx, mode)):
                    raise AssertionError(f"embedding_bag {mode} V={v} D={d} K={k} differs "
                                         "from embedding_bag_ordered")
                if not bit_equal(a, bag.embedding_bag_cuda(table, idx, mode)):
                    raise AssertionError(f"embedding_bag {mode} V={v} D={d} not deterministic")
                torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-5)
                worst = max(worst, abs_err(a, p))
    return worst


def sweep_flash(dev, rng, fa, ops, rounded: dict) -> dict:
    """Both flash routes against the plain version; returns the worst
    absolute error of each kernel (bf16 for wgmma, float32 for the TF32
    kernel) and puts each kernel's worst bf16 relative norm error against
    `attention_rounded` into `rounded`. The TF32 kernel in float32 is also
    held within 2e-4 of `attention_3xtf32`; what a single TF32 pass
    (`attention_3xtf32(passes=1)`) would give is logged, not held."""
    worst = {fa.TENSOR_CORES: 0.0, fa.TF32: 0.0}
    worst_rel, least_control = 0.0, float("inf")
    one_pass, three_pass = 0.0, 0.0
    for b, hq, hkv, sq, skv, d in [(1, 2, 2, 32, 32, 16), (2, 4, 2, 64, 64, 32),
                                   (1, 8, 1, 100, 100, 64), (2, 4, 2, 16, 80, 32),
                                   (1, 4, 4, 70, 130, 128), (1, 2, 1, 1, 37, 24),
                                   (1, 32, 8, 200, 200, 128), (2, 6, 3, 65, 129, 8),
                                   (2, 4, 2, 200, 333, 64), (1, 6, 3, 300, 300, 128),
                                   (1, 4, 2, 130, 400, 128), (1, 4, 1, 257, 513, 96),
                                   (1, 4, 2, 150, 170, 12), (1, 32, 8, 1024, 1024, 128),
                                   (1, 8, 2, 1, 2048, 128)]:
        shapes = ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
        base = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(x).to(dev).to(dt) for x in base)
            kernel = fa.route(dt, d)
            for causal in (True, False):
                ops.reset_launches()
                a = fa.flash_attention_cuda(q, k, v, causal)
                if ops.launch_counts()[kernel] != 1:
                    raise AssertionError(f"flash D={d} {dt} did not take the {kernel} route")
                p = fa.attention_plain(q, k, v, causal)
                torch.cuda.synchronize()
                tol = 2e-4 if dt == torch.float32 else 5e-2
                torch.testing.assert_close(a.float(), p.float(), rtol=tol, atol=tol)
                if dt == torch.float32:
                    t3 = fa.attention_3xtf32(q, k, v, causal)
                    torch.testing.assert_close(a, t3, rtol=2e-4, atol=2e-4)
                    three_pass = max(three_pass, abs_err(t3, p))
                    one_pass = max(one_pass, abs_err(fa.attention_3xtf32(q, k, v, causal, 1), p))
                if dt == torch.float32 or kernel == fa.TENSOR_CORES:
                    worst[kernel] = max(worst[kernel], abs_err(a.float(), p.float()))
                if dt == torch.bfloat16:
                    what = f"flash B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} {causal=}"
                    check_rel(what, a, p, fa.BF16_REL_ERR)
                    worst_rel = max(worst_rel, rel_err(a, p))
                    r = fa.attention_rounded(q, k, v, causal)
                    check_rel(f"{what} vs attention_rounded", a, r, fa.ROUNDED_REL_ERR)
                    rounded[kernel] = max(rounded.get(kernel, 0.0), rel_err(a, r))
                    control = dropped_key_control(fa, q, k, v, causal, r)
                    if not control > 2 * fa.ROUNDED_REL_ERR:
                        raise AssertionError(f"{what}: a dropped key moves the output by "
                                             f"only {control:.3g}")
                    least_control = min(least_control, control)
    log(f"[3 kernels] flash_attention bfloat16: worst relative norm error {worst_rel:.3g} "
        f"against the plain version (limit {fa.BF16_REL_ERR}); against attention_rounded "
        f"{rounded} (limit {fa.ROUNDED_REL_ERR}); one dropped key moves attention_rounded by "
        f"at least {least_control:.3g}")
    log(f"[3 kernels] flash_attention float32: worst |attention_3xtf32 - plain| "
        f"{three_pass:.3g}; a single TF32 pass (attention_3xtf32 passes=1) would give "
        f"{one_pass:.3g} (limit 2e-4, not held)")
    return worst


# ---------------------------------------------------------------------------
# phase 4/5 helpers
# ---------------------------------------------------------------------------


def scipy_dist(g, unweighted: bool, indices=0) -> np.ndarray:
    """scipy's Dijkstra distances from `indices` (a vertex, or a list: one
    row each)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    n = g.n_nodes
    a = csr_matrix((g.out.weights.cpu().numpy().astype(np.float64),
                    g.out.col_idx.cpu().numpy(), g.out.row_ptr.cpu().numpy()),
                   shape=(n, n))
    return dijkstra(a, directed=True, indices=indices, unweighted=unweighted)


def check_dist(name: str, dist: torch.Tensor, ref: np.ndarray, big: float) -> None:
    got = dist[:-1].cpu().numpy().astype(np.float64)
    got[got >= big] = np.inf
    if not np.array_equal(got, ref):
        bad = int(np.sum(got != ref))
        raise AssertionError(f"{name}: {bad} distances differ from scipy")


def same_run(name, ma, sa, mb, sb) -> None:
    for k in ma:
        if not bit_equal(ma[k], mb[k]):
            raise AssertionError(f"{name}: field {k!r} differs between pulls/modes")
    for k in ("iterations", "push_iters", "pull_iters", "switches",
              "mode_trace", "fe_trace", "final_count"):
        if not torch.equal(sa[k], sb[k]):
            raise AssertionError(f"{name}: stat {k!r} differs")


def timed(fn):
    """(fn(), host seconds) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_run(engine, prog, g, pack, cfg):
    (m, st), t = timed(lambda: engine.run(prog, g, pack, cfg))
    return m, st, t


def profile_runs(engine, progs, g, pack, cfg, top: int = 8) -> None:
    """torch.profiler over one run of each program: device-busy share of the
    wall time and the kernels that hold the device longest."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else e.self_cuda_time_total

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        engine.run(progs[0][1], g, pack, cfg)      # profiler start-up, not reported
        torch.cuda.synchronize()
    for name, p in progs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.run(p, g, pack, cfg)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: an operator's entry repeats its kernels' time
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in ka)
        log(f"[profile] {name}: wall {wall_us / 1e3:.1f} ms (profiled), device busy "
            f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}%")
        for e in sorted(ka, key=dev_us, reverse=True)[:top]:
            log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")


def check_bags(bag, table, idx, bags, report, err) -> None:
    """Phase 6(c): each batch of BAG_BATCHES (a prefix of `idx`, one id a
    field of DeepFM's table), sum and mean from the counted run `bags`,
    bit-equal to `embedding_bag_ordered` and within rtol 1e-5 of the plain
    version; each timed beside its bound by bytes (each distinct row once)
    and by the 32-byte sectors those rows touch, the plain version and
    F.embedding_bag. Fills report["embedding_bag"] (the middle batch's sum
    at the top, every batch under `sizes`)."""
    fields, dim = idx.shape[1], table.shape[1]
    b_err, sizes = 0.0, []
    for nb in BAG_BATCHES:
        ids = idx[:nb]
        ids64 = ids.long()
        for mode in ("sum", "mean"):
            o = bags[(nb, mode)]
            if not bit_equal(o, bag.embedding_bag_ordered(table, ids, mode)):
                raise AssertionError(f"embedding_bag {mode} B={nb} differs from "
                                     "embedding_bag_ordered")
            pl = bag.embedding_bag_plain(table, ids, mode)
            torch.testing.assert_close(o, pl, rtol=1e-5, atol=1e-5)
            b_err = max(b_err, abs_err(o, pl))
            lib_diff = abs_err(o, F.embedding_bag(ids64, table, mode=mode))
            log(f"[6 slice] (c) embedding_bag B={nb} {mode}: bit-equal to "
                f"embedding_bag_ordered, within rtol 1e-5 of plain (max abs err "
                f"{abs_err(o, pl):.3g}); max |kernel - F.embedding_bag| {lib_diff:.3g}")
        rows = torch.unique(ids).long()
        start = rows * (dim * 4)                                  # byte offset of each row
        sectors = int(((start + dim * 4 - 1) // 32 - start // 32 + 1).sum())
        other = ids.numel() * 4 + nb * dim * 4                    # ids and output
        bnd = bound_ms(rows.numel() * dim * 4 + other, nb * fields * dim)
        size = dict(
            batch=nb, distinct_rows=rows.numel(), sectors=sectors,
            ms=graph_ms(lambda: bag.embedding_bag_cuda(table, ids, "sum")),
            mean_ms=graph_ms(lambda: bag.embedding_bag_cuda(table, ids, "mean")),
            plain_ms=cuda_ms(lambda: bag.embedding_bag_plain(table, ids, "sum"), 5),
            library_ms=graph_ms(lambda: F.embedding_bag(ids64, table, mode="sum")),
            library_mean_ms=graph_ms(lambda: F.embedding_bag(ids64, table, mode="mean")),
            bound_ms=bnd[0], bound_by=bnd[1],
            sector_bound_ms=bound_ms(sectors * 32 + other, nb * fields * dim)[0])
        if nb == BAG_BATCHES[1]:
            size.update(
                wrapper_loop_ms=cuda_ms(lambda: bag.embedding_bag_cuda(table, ids, "sum"),
                                        50, 5, 7),
                library_loop_ms=cuda_ms(lambda: F.embedding_bag(ids64, table, mode="sum"),
                                        50, 5, 7))
        sizes.append(size)
        log(f"[6 slice] (c) embedding_bag B={nb}: card {size['ms']:.4f} ms sum, "
            f"{size['mean_ms']:.4f} mean (CUDA graphs); bound {size['bound_ms']:.4f} by bytes "
            f"({rows.numel()} distinct rows), {size['sector_bound_ms']:.4f} by 32-byte sectors "
            f"({sectors}); plain {size['plain_ms']:.4f}; F.embedding_bag "
            f"{size['library_ms']:.4f} sum, {size['library_mean_ms']:.4f} mean")
    main = sizes[1]
    report["embedding_bag"] = dict(
        replaces="src/repro/kernels/embedding_bag.py:24",
        shape=f"table {table.shape[0]}x{dim} float32, B={main['batch']}, K={fields}, sum "
              f"(B={BAG_BATCHES}: `sizes`)",
        max_abs_err=max(b_err, err["embedding_bag"]),
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "sector_bound_ms", "wrapper_loop_ms", "library_loop_ms")},
        sizes=sizes)
    r = report["embedding_bag"]
    log(f"[6 slice] (c) embedding_bag B={main['batch']} sum through the Python function "
        f"{r['wrapper_loop_ms']:.4f} ms against F.embedding_bag's {r['library_loop_ms']:.4f} "
        "ms a call")


def slice_phase(dev, pack, ops, ell, bag, fa, L, report, err, rounded) -> dict:
    """Phase 6: the kernel library's second slice at full width. Drives the
    overlay, ell_spmm, embedding_bag and the flash kernel through `ops` and
    `nn.layers` with the counts set to 0 just before, checks every result,
    then times each kernel beside its plain version (uncounted). The
    granite layer runs in bf16 (the tensor-core flash kernel) and in float32
    (the TF32 one). Fills `report`; returns the five kernels' launch
    counts."""
    n, slices = pack.n_nodes, pack.slices
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    vals = torch.rand(n + 1, device=dev, generator=gen) * 64
    deads = [(torch.rand(tuple(s.nbr.shape), device=dev, generator=gen) < 0.01) & (s.nbr != n)
             for s in slices]
    feats = {}
    for d in (64, 70):                          # gin-tu, gatedgcn hidden widths
        feats[d] = torch.rand(n + 1, d, device=dev, generator=gen)
        feats[d][n] = 0.0
    fields, per_field, dim = 39, 100_000, 10            # DeepFM (models/deepfm.py)
    table = torch.randn(fields * per_field, dim, device=dev, generator=gen)
    # one id a field; each batch of BAG_BATCHES is a prefix of one draw
    idx = (torch.arange(fields, device=dev, dtype=torch.int32) * per_field
           + torch.randint(0, per_field, (max(BAG_BATCHES), fields), device=dev,
                           generator=gen, dtype=torch.int32))
    d_model, hq, hkv, dh, batch, seq = 4096, 32, 8, 128, 4, 1024   # granite-3-8b
    bf16 = torch.bfloat16

    def weight(rows, cols):
        return (torch.randn(rows, cols, device=dev, generator=gen) * rows ** -0.5).to(bf16)

    params = {"wq": weight(d_model, hq * dh), "wk": weight(d_model, hkv * dh),
              "wv": weight(d_model, hkv * dh), "wo": weight(hq * dh, d_model),
              "attn_norm": torch.ones(d_model, device=dev, dtype=bf16)}
    x = torch.randn(batch, seq, d_model, device=dev, generator=gen).to(bf16)
    pos = torch.arange(seq, device=dev, dtype=torch.int32).expand(batch, seq)
    combos = [(op, comb) for op in ell.COMPUTE_OPS for comb in ell.COMBINE_OPS]
    torch.cuda.synchronize()

    # -- the counted run ------------------------------------------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    over = {c: [ops.ell_combine(s.nbr, s.wgt, vals, *c, dead=dd) for s, dd in zip(slices, deads)]
            for c in combos}
    spmm = {d: [ops.ell_spmm(s.nbr, s.wgt, f) for s in slices] for d, f in feats.items()}
    bags = {(nb, mode): ops.embedding_bag(table, idx[:nb], mode)
            for nb in BAG_BATCHES for mode in ("sum", "mean")}
    h = L.rms_norm(x, params["attn_norm"])
    attn, (k, v) = L.gqa_attention(h, params, n_heads=hq, n_kv=hkv, positions=pos,
                                   use_flash=True)
    p32 = {key: w.float() for key, w in params.items()}
    a32, _ = L.gqa_attention(h.float(), p32, n_heads=hq, n_kv=hkv, positions=pos,
                             use_flash=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    mine = {key: counts[key] for key in
            ("ell_combine_overlay", "ell_spmm", "embedding_bag", fa.TENSOR_CORES, fa.TF32)}
    log(f"[6 slice] counted run {time.perf_counter() - t0:.3f} s; launches {mine}")

    # -- (a) deletion overlay -------------------------------------------------
    real = sum(int((s.nbr != n).sum()) for s in slices)
    n_dead = sum(int(dd.sum()) for dd in deads)
    neutral = [ell.neutralize(s.nbr, dd, n) for s, dd in zip(slices, deads)]
    for c, outs in over.items():
        for s, dd, nu, o in zip(slices, deads, neutral, outs):
            if not bit_equal(o, ell.ell_combine_cuda(nu, s.wgt, vals, *c)):
                raise AssertionError(f"overlay {c} differs from the neutralized copy")
            if not bit_equal(o, ell.ell_combine_plain(s.nbr, s.wgt, vals, *c, dd)):
                raise AssertionError(f"overlay {c} differs from its plain version")
    log(f"[6 slice] (a) overlay: {n_dead} of {real} real slots dead "
        f"({100 * n_dead / real:.3f} %); {len(combos)} op pairs x {len(slices)} slices "
        "bit-equal to the neutralized copy and to the plain version")
    slots = sum(s.nbr.numel() for s in slices)
    rows = sum(s.rows for s in slices)
    ovk = lambda: [ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min", dd)
                   for s, dd in zip(slices, deads)]
    ovp = lambda: [ell.ell_combine_plain(s.nbr, s.wgt, vals, "add_w", "min", dd)
                   for s, dd in zip(slices, deads)]
    # ids and flags of every slot, weights of the live ones
    bnd = bound_ms(slots * 5 + (real - n_dead) * 4 + (n + 1) * 4 + rows * 4, (real - n_dead) * 2)
    report["ell_combine_overlay"] = dict(
        replaces="src/repro/kernels/ell_spmv.py:74",
        shape=f"{len(slices)} RMAT ELL slices, {slots} slots, add_w/min, 1 % dead",
        max_abs_err=err["ell_combine_overlay"], ms=cuda_ms(ovk, 10),
        plain_ms=cuda_ms(ovp, 3, 1), bound_ms=bnd[0], bound_by=bnd[1],
        bound_all_slots_ms=bound_ms(slots * 9 + (n + 1) * 4 + rows * 4, slots * 2)[0])
    csrs = slice_csrs(slices, n, dev, deads)
    report["ell_combine_overlay"].update(library_copy_sum(ell, slices, vals, csrs, deads))
    r = report["ell_combine_overlay"]
    log(f"[6 slice] (a) overlay copy/sum {r['copy_sum_ms']:.4f} ms (bound "
        f"{r['copy_sum_bound_ms']:.4f}) against torch.sparse.mm without the dead slots "
        f"{r['library_copy_sum_ms']:.4f} ms (max |kernel - sparse.mm| "
        f"{r['library_max_abs_diff']:.3g})")
    del over, neutral, deads, csrs

    # -- (b) ell_spmm ---------------------------------------------------------
    used = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    for s in slices:
        used[s.nbr.flatten().long()] = True
    used_rows = int(used[:n].sum())
    csrs = []
    for s in slices:
        live = s.nbr != n
        crow = torch.zeros(s.rows + 1, dtype=torch.int32, device=dev)
        crow[1:] = live.sum(dim=1).cumsum(0)
        csrs.append(torch.sparse_csr_tensor(crow, s.nbr[live], s.wgt[live],
                                            size=(s.rows, n + 1)))
    e_err, times = 0.0, {}
    for d, f in feats.items():
        lib_diff = 0.0
        for s, o, c in zip(slices, spmm[d], csrs):
            b = ell.ell_spmm_plain(s.nbr, s.wgt, f)
            torch.testing.assert_close(o, b, rtol=1e-5, atol=1e-5)
            if not bit_equal(o, ell.ell_spmm_cuda(s.nbr, s.wgt, f)):
                raise AssertionError(f"ell_spmm D={d} on the {tuple(s.nbr.shape)} slice "
                                     "differs between two calls")
            e_err = max(e_err, abs_err(o, b))
            lib_diff = max(lib_diff, abs_err(o, torch.sparse.mm(c, f)))
        sk = lambda f=f: [ell.ell_spmm_cuda(s.nbr, s.wgt, f) for s in slices]
        sp = lambda f=f: [ell.ell_spmm_plain(s.nbr, s.wgt, f) for s in slices]
        sl = lambda f=f: [torch.sparse.mm(c, f) for c in csrs]
        times[d] = (cuda_ms(sk, 5), cuda_ms(sp, 1, 0), cuda_ms(sl, 5), lib_diff)
        log(f"[6 slice] (b) ell_spmm D={d}: {times[d][0]:.4f} ms (plain {times[d][1]:.4f}, "
            f"torch.sparse.mm {times[d][2]:.4f}, max |kernel - sparse.mm| {lib_diff:.3g}); "
            f"bit-equal to itself on a second call; row requests {real * d * 4 / 1e9:.2f} GB "
            f"= {real * d * 4 / times[d][0] / 1e9:.3f} TB/s")
    del spmm, csrs
    d = 64
    # every slot's id and weight (the first bound), or the weights of the
    # live slots only (what the kernel reads); each used row once; the output
    bnd = bound_ms(slots * 8 + used_rows * d * 4 + rows * d * 4, 2 * real * d)
    live_bnd = bound_ms(slots * 4 + real * 4 + used_rows * d * 4 + rows * d * 4, 2 * real * d)
    report["ell_spmm"] = dict(
        replaces="src/repro/kernels/ell_spmv.py:150",
        shape=f"{len(slices)} RMAT ELL slices, {real} live slots, D=64 float32 "
              f"(D=70: {times[70][0]:.4f} ms, plain {times[70][1]:.4f}, library {times[70][2]:.4f})",
        max_abs_err=max(e_err, err["ell_spmm"]), ms=times[d][0], plain_ms=times[d][1],
        bound_ms=bnd[0], bound_by=bnd[1], bound_live_weights_ms=live_bnd[0],
        request_tb_per_s=real * d * 4 / times[d][0] / 1e9,
        request_tb_per_s_d70=real * 70 * 4 / times[70][0] / 1e9, library_ms=times[d][2])

    # -- (c) embedding_bag ----------------------------------------------------
    check_bags(bag, table, idx, bags, report, err)
    del bags, table, idx

    # -- (d) the granite-3-8b attention layer --------------------------------
    # Outputs here are small (a row averages many values of v: rms ~0.12), so
    # bfloat16 is held by the relative norm and float32 at 2e-4 absolute.
    plain, _ = L.gqa_attention(h, params, n_heads=hq, n_kv=hkv, positions=pos, use_flash=False)
    if attn.shape != (batch, seq, d_model) or not bool(torch.isfinite(attn).all()):
        raise AssertionError("granite attention layer: wrong shape or non-finite values")
    b32, _ = L.gqa_attention(h.float(), p32, n_heads=hq, n_kv=hkv, positions=pos,
                             use_flash=False)
    log(f"[6 slice] (d) granite-3-8b attention layer B={batch} S={seq}: use_flash=True vs "
        f"False in bfloat16 max abs diff {abs_err(attn.float(), plain.float()):.3g}, relative "
        f"norm {rel_err(attn, plain):.3g} (limit {fa.BF16_REL_ERR}); in float32 max abs diff "
        f"{abs_err(a32, b32):.3g} (limit 2e-4), relative norm {rel_err(a32, b32):.3g}; "
        f"output rms {float(plain.float().square().mean().sqrt()):.3g}")
    torch.testing.assert_close(attn.float(), plain.float(), rtol=5e-2, atol=5e-2)
    check_rel("granite attention layer (bfloat16)", attn, plain, fa.BF16_REL_ERR)
    torch.testing.assert_close(a32, b32, rtol=2e-4, atol=2e-4)
    del p32, a32, b32
    q = L.rope((h @ params["wq"]).reshape(batch, seq, hq, dh), pos).transpose(1, 2).contiguous()
    k, v = k.contiguous(), v.contiguous()
    q32, k32, v32 = q.float(), k.float(), v.float()
    a, pl = fa.flash_attention_cuda(q, k, v, True), fa.attention_plain(q, k, v, True)
    a32, p32 = fa.flash_attention_cuda(q32, k32, v32, True), fa.attention_plain(q32, k32, v32, True)
    kr, vr = k.repeat(1, hq // hkv, 1, 1), v.repeat(1, hq // hkv, 1, 1)   # group-major
    kr32, vr32 = kr.float(), vr.float()
    lib = F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
    log(f"[6 slice] (d) flash vs plain in bfloat16 (tensor cores) max abs diff "
        f"{abs_err(a.float(), pl.float()):.3g}, relative norm {rel_err(a, pl):.3g}; in float32 "
        f"(TF32) max abs diff {abs_err(a32, p32):.3g}, relative norm "
        f"{rel_err(a32, p32):.3g}; "
        f"output rms {float(pl.float().square().mean().sqrt()):.3g}; "
        f"vs scaled_dot_product_attention {abs_err(a.float(), lib.float()):.3g}")
    torch.testing.assert_close(a.float(), pl.float(), rtol=5e-2, atol=5e-2)
    check_rel("flash kernel (bfloat16, tensor cores)", a, pl, fa.BF16_REL_ERR)
    torch.testing.assert_close(a32, p32, rtol=2e-4, atol=2e-4)
    r = fa.attention_rounded(q, k, v, True)
    control = dropped_key_control(fa, q, k, v, True, r)
    log(f"[6 slice] (d) flash (bfloat16, tensor cores) vs attention_rounded: relative norm "
        f"{rel_err(a, r):.3g} (limit {fa.ROUNDED_REL_ERR}); key 0 dropped from every row "
        f"moves attention_rounded by {control:.3g}")
    check_rel("flash kernel (bfloat16, tensor cores) vs attention_rounded", a, r,
              fa.ROUNDED_REL_ERR)
    if not control > 2 * fa.ROUNDED_REL_ERR:
        raise AssertionError(f"granite: a dropped key moves the output by only {control:.3g}")
    rounded[fa.TENSOR_CORES] = max(rounded[fa.TENSOR_CORES], rel_err(a, r))
    del r
    pairs = batch * hq * seq * (seq + 1) // 2          # causal (query, key) pairs
    shape = f"granite-3-8b layer: q {tuple(q.shape)}, kv {tuple(k.shape)}, causal"
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q32, kr32, vr32, is_causal=True)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    log(f"[6 slice] (d) float32 scaled_dot_product_attention runs {names}")
    # the TF32 kernel does three TF32 products for each float32 one
    for kernel, qq, kk, vv, kx, vx, ops_x, peak, what, e in (
            (fa.TENSOR_CORES, q, k, v, kr, vr, 1, BF16_OPS_PER_S, "bf16",
             abs_err(a.float(), pl.float())),
            (fa.TF32, q32, k32, v32, kr32, vr32, 3, TF32_OPS_PER_S, "float32, 3xTF32",
             abs_err(a32, p32))):
        nbytes = (qq.numel() * 2 + kk.numel() * 2) * qq.element_size()
        bnd = bound_ms(nbytes, ops_x * 4 * pairs * dh, peak)
        report[kernel] = dict(
            replaces="src/repro/kernels/flash_attention.py:28",
            shape=f"{shape}, {what}",
            max_abs_err=max(e, err[kernel]), bf16_rounded_rel_err=rounded[kernel],
            ms=cuda_ms(lambda: fa.flash_attention_cuda(qq, kk, vv, True), 10),
            plain_ms=cuda_ms(lambda: fa.attention_plain(qq, kk, vv, True), 3, 1),
            bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qq, kx, vx, is_causal=True),
                               10))
    report[fa.TF32].update(
        bound_cuda_cores_ms=bound_ms(nbytes, 4 * pairs * dh, F32_OPS_PER_S)[0],
        library_kernels=names)
    del q32, k32, v32, kr32, vr32, a32, p32
    for key in mine:
        r = report[key]
        log(f"[6 slice] {key}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    return mine


def slice_csrs(slices, n: int, dev, drop=None) -> list:
    """Each ELL slice's (R, n + 1) 0/1 matrix as CSR, a 1 for every real
    slot (not flagged in `drop`): torch.sparse.mm of it by vals is the one
    library call that computes copy/sum."""
    out = []
    for i, s in enumerate(slices):
        live = s.nbr != n
        if drop is not None:
            live = live & ~drop[i]
        crow = torch.zeros(s.rows + 1, dtype=torch.int32, device=dev)
        crow[1:] = live.sum(dim=1).cumsum(0)
        col = s.nbr[live]
        out.append(torch.sparse_csr_tensor(crow, col, torch.ones_like(col, dtype=torch.float32),
                                           size=(s.rows, n + 1)))
    return out


def library_copy_sum(ell, slices, vals, csrs, dead=None) -> dict:
    """ell_combine at copy/sum over the slices beside torch.sparse.mm of
    their 0/1 CSR matrices by vals (as one column): times, bound (every id,
    the flags with `dead`, vals and the output once), largest difference.
    The row's `ms` is add_w/min, which no single library call computes, so
    its `library_ms` is None and the pair is copy_sum_ms and
    library_copy_sum_ms."""
    n = vals.shape[0] - 1
    deads = dead or [None] * len(slices)
    kern = lambda: [ell.ell_combine_cuda(s.nbr, s.wgt, vals, "copy", "sum", d)
                    for s, d in zip(slices, deads)]
    col = vals[:, None]
    lib = lambda: [torch.sparse.mm(c, col) for c in csrs]
    diff = max(abs_err(a, b[:, 0]) for a, b in zip(kern(), lib()))
    slots = sum(s.nbr.numel() for s in slices)
    rows = sum(s.rows for s in slices)
    bnd = bound_ms(slots * (5 if dead else 4) + (n + 1) * 4 + rows * 4, 0)
    return dict(copy_sum_ms=cuda_ms(kern, 10), copy_sum_bound_ms=bnd[0],
                library_ms=None, library_copy_sum_ms=cuda_ms(lib, 5), library_max_abs_diff=diff,
                library_op="copy/sum: torch.sparse.mm of each slice's 0/1 CSR by vals")


# ---------------------------------------------------------------------------
# phases 7 and 8: the baseline engines, the batched engine
# ---------------------------------------------------------------------------


def baselines_phase(A, E, Bl, label: str, g, pack, online_caps, hold_pagerank: bool) -> None:
    """Phase 7 on one graph: each baseline engine (paper Fig. 5, Fig. 12)
    against `engine.run` with the kernel pull, timed beside it. run_atomic
    bfs/sssp, run_batch_filter bfs and the ballot-only ablation of sssp are
    bit-equal; run_atomic pagerank's first iteration against float64 (see
    below); its whole run within rtol 1e-5 of engine.run where
    `hold_pagerank` (a graph on which pagerank's frontier holds every
    vertex for its whole run, so that the atomic pushes gather what the
    pull gathers), else its deviation logged: its pushes skip senders that
    left the frontier. `online_caps` is a list of (frontier_cap, edge_cap,
    must overflow) for the online-only ablation of bfs; a run that must not
    overflow equals full bfs."""
    n, m = g.n_nodes, g.n_edges
    cfg = E.EngineConfig(frontier_cap=n, edge_cap=m, max_iters=16384)
    tag = f"[7 baselines] {label}"
    solo = {}
    for name, prog in (("bfs", A.bfs(0)), ("sssp", A.sssp(0)), ("pagerank", A.pagerank()),
                       ("pagerank_1", A.pagerank(max_iters=1))):
        (mm, ss), t = timed(lambda: E.run(prog, g, pack, cfg))
        solo[name] = (mm, t, int(ss["iterations"]))
        log(f"{tag} engine.run {name}: {t:.3f} s, {solo[name][2]} iterations")

    def held(what, name, field, mb, t, iters):
        if not bit_equal(mb[field], solo[name][0][field]):
            raise AssertionError(f"{label} {what} {name} differs from engine.run")
        log(f"{tag} {what} {name}: {t:.3f} s ({t / solo[name][1]:.2f}x engine.run), "
            f"{iters} iterations; bit-equal to engine.run")

    for name in ("bfs", "sssp"):
        (mb, sb), t = timed(lambda: Bl.run_atomic(A.ALL[name](0), g, cfg))
        held("run_atomic", name, "dist", mb, t, int(sb["iterations"]))
    # pagerank: one iteration (every vertex pushes, as the pull gathers)
    # against the same iteration in float64 on the same float32 inputs: the
    # engine's fixed-order trees within rtol 1e-5 of it; the atomic adds, in
    # whatever order the card takes them, within the a-priori bound of a
    # float32 sum of k positive terms in any order plus the three roundings
    # of the update, gamma_(k+3) = (k+3)u / (1 - (k+3)u) relative, k the
    # in-degree (rtol 1e-5 is not a bound on a hub's 10^5 atomic adds)
    p1 = A.pagerank(max_iters=1)
    (mb, sb), t = timed(lambda: Bl.run_atomic(p1, g, cfg))
    contrib = E.init_state(p1, g, cfg).m["contrib"].double()
    seg = torch.zeros(n, dtype=torch.float64, device=contrib.device)
    seg.index_add_(0, g.inc.src_idx.long(), contrib[g.inc.col_idx.long()])
    exact = (1.0 - 0.85) / n + 0.85 * seg
    eng = solo["pagerank_1"][0]["rank"][:-1].double()
    torch.testing.assert_close(eng, exact, rtol=1e-5, atol=0.0)
    k = g.inc.degrees().double() + 3
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    err = (mb["rank"][:-1].double() - exact).abs()
    ratio = float((err / (gamma * exact)).max())
    if not ratio <= 1.0:
        raise AssertionError(f"{label} run_atomic pagerank: off the float64 iteration by "
                             f"{ratio:.3g} of the any-order summation bound")
    log(f"{tag} run_atomic pagerank, one iteration: {t:.3f} s; largest relative deviation "
        f"from float64 {rel_max(mb['rank'][:-1], exact):.3g} (atomic adds; at most "
        f"{ratio:.3g} of the any-order bound), engine.run's {rel_max(eng, exact):.3g} (limit "
        f"1e-5), between the two {rel_max(mb['rank'][:-1], eng):.3g}")
    (mb, sb), t = timed(lambda: Bl.run_atomic(A.pagerank(), g, cfg))
    ref = solo["pagerank"][0]["rank"]
    if hold_pagerank:
        torch.testing.assert_close(mb["rank"], ref, rtol=1e-5, atol=0.0)
    log(f"{tag} run_atomic pagerank, whole run: {t:.3f} s ({t / solo['pagerank'][1]:.2f}x "
        f"engine.run), {int(sb['iterations'])} iterations against {solo['pagerank'][2]}, "
        f"largest relative deviation from engine.run {rel_max(mb['rank'][:-1], ref[:-1].double()):.3g}"
        + (" (limit 1e-5)" if hold_pagerank else " (not held: its pushes skip senders that "
                                                  "left the frontier)"))
    (mb, sb), t = timed(lambda: Bl.run_batch_filter(A.bfs(0), g, cfg))
    held("run_batch_filter", "bfs", "dist", mb, t, int(sb["iterations"]))
    (mb, sb), t = timed(lambda: Bl.run_filter_ablation(A.sssp(0), g, pack, cfg, "ballot"))
    held("ballot-only", "sssp", "dist", mb, t, int(sb["iterations"]))
    for fcap, ecap, must in online_caps:
        small = E.EngineConfig(frontier_cap=fcap, edge_cap=ecap, max_iters=16384)
        (mb, sb), t = timed(lambda: Bl.run_filter_ablation(A.bfs(0), g, pack, small, "online"))
        failed = bool(sb["failed_overflow"])
        if failed != must:
            raise AssertionError(f"{label} online-only bfs frontier_cap={fcap} edge_cap={ecap}: "
                                 f"failed_overflow {failed}, expected {must}")
        if not failed and not bit_equal(mb["dist"], solo["bfs"][0]["dist"]):
            raise AssertionError(f"{label} online-only bfs differs from full bfs")
        log(f"{tag} online-only bfs frontier_cap={fcap} edge_cap={ecap}: {t:.3f} s, "
            f"{int(sb['iterations'])} iterations, "
            + ("overflowed, as it must" if failed else "no overflow; bit-equal to full bfs"))


def time_batched_kernel(dev, ell, sr, g, pack, report, err) -> None:
    """ell_combine_batched on each RMAT-22 slice at Q = 8 and 64, on the
    route `batched_layout` picks (logged with its lanes): bit-equal to its
    plain version for copy/sum and add_w/min, and at Q = 64 for hop/min and
    mul_w/sum too; each timed beside its bound by bytes (every id, the real
    slots' weights where the op reads them, the output, and once each the
    Q-vectors of vals that the live ids name: a slice's own distinct ids,
    over the four slices the union of theirs; and with one Q-vector a real
    slot, the gathers' traffic without reuse), the plain version (copy/sum)
    and torch.sparse.mm of the slice's (R, n + 1) 0/1 matrix by vals (the
    single library call for copy/sum). Then
    segment_reduce at the batched engine's shapes (D = 64): the union push
    (E = edge_cap = 2n lanes of sorted destination ids, num = n) and each
    slice's pull merge (E = its rows, num = n + 1), each held first by
    `check_segment` (sum, min and max bit-equal to segment_reduce_ordered),
    timed beside index_add_. Fills
    report["ell_combine_batched"] (Q = 64 at the top, Q = 8 under `q8`) and
    report["segment_reduce"]["batched"]. These launches are not counted."""
    n, slices = pack.n_nodes, pack.slices
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    csrs = slice_csrs(slices, n, dev)
    reals = [int((s.nbr != n).sum()) for s in slices]
    # the rows of vals each slice's live ids name, and those the pull names
    named = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    distinct = []
    for s in slices:
        seen = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        seen[s.nbr.reshape(-1).long()] = True
        seen[n] = False
        distinct.append(int(seen.sum()))
        named |= seen
    distinct_all = int(named.sum())
    del named, seen
    log(f"[8 batched] distinct live ids a slice {distinct}, over the pull {distinct_all} "
        f"of n = {n}")
    per_q, worst = {}, err["ell_combine_batched"]
    for q in (8, 64):
        vals = torch.rand(n + 1, q, device=dev, generator=gen) * 64
        pairs = [("copy", "sum"), ("add_w", "min")]
        if q == 64:
            pairs += [("hop", "min"), ("mul_w", "sum")]
        rows = []
        for s, c, rl, nd in zip(slices, csrs, reals, distinct):
            lay = ell.batched_layout(q, s.width, vals.data_ptr(), 0)
            for op, comb in pairs:
                a = ell.ell_combine_batched_cuda(s.nbr, s.wgt, vals, op, comb)
                b = ell.ell_combine_batched_plain(s.nbr, s.wgt, vals, op, comb)
                if not bit_equal(a, b):
                    raise AssertionError(f"ell_combine_batched {op}/{comb} Q={q} differs on the "
                                         f"{tuple(s.nbr.shape)} slice")
                worst = max(worst, abs_err(a, b))
            lib_diff = abs_err(ell.ell_combine_batched_cuda(s.nbr, s.wgt, vals, "copy", "sum"),
                               torch.sparse.mm(c, vals))
            times = {f"{op}/{comb}": cuda_ms(lambda s=s, op=op, comb=comb:
                                             ell.ell_combine_batched_cuda(s.nbr, s.wgt, vals,
                                                                          op, comb), 10)
                     for op, comb in pairs}
            # each input read once (every id, the real slots' weights where
            # the op reads them, the Q-vectors the live ids name), the output
            # written once; beside it the gathers' bound, one Q-vector a real
            # slot
            ids, out = s.nbr.numel() * 4, s.rows * q * 4
            bnd = bound_ms(ids + nd * q * 4 + out, rl * q)
            wbnd = bound_ms(ids + rl * 4 + nd * q * 4 + out, rl * q)
            gather = bound_ms(ids + rl * 4 + rl * q * 4 + out, rl * q)
            row = dict(
                shape=[s.rows, s.width], real_slots=rl, distinct_ids=nd, route=lay.route,
                column_lanes=lay.column_lanes, slot_groups=lay.slot_groups, vector=lay.vector,
                ms=times["copy/sum"], min_ms=times["add_w/min"], times=times,
                plain_ms=cuda_ms(lambda s=s: ell.ell_combine_batched_plain(s.nbr, s.wgt, vals,
                                                                           "copy", "sum"), 1, 0),
                library_ms=cuda_ms(lambda c=c: torch.sparse.mm(c, vals), 5),
                bound_ms=bnd[0], bound_by=bnd[1], min_bound_ms=wbnd[0],
                bound_gather_ms=gather[0], library_max_abs_diff=lib_diff)
            rows.append(row)
            log(f"[8 batched] ell_combine_batched Q={q} slice {tuple(s.nbr.shape)}, {rl} real "
                f"slots: route {lay.route}, {lay.column_lanes} column lanes x "
                f"{lay.slot_groups} slot groups, 16-byte columns {lay.vector}; "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
                + f" (bound {row['bound_ms']:.4f} by {row['bound_by']}, {row['min_bound_ms']:.4f}"
                f" with weights, {row['bound_gather_ms']:.4f} with a Q-vector a real slot); "
                f"plain {row['plain_ms']:.4f}; torch.sparse.mm {row['library_ms']:.4f} (max "
                f"|kernel - sparse.mm| {lib_diff:.3g}); {len(pairs)} op pairs bit-equal to plain")
        tot = {k: sum(r[k] for r in rows) for k in ("ms", "min_ms", "plain_ms", "library_ms",
                                                     "bound_gather_ms")}
        # over the pull, vals's named rows count once (as row 1 counts vals)
        ids = sum(s.nbr.numel() * 4 + s.rows * q * 4 for s in slices)
        tot["bound_ms"] = bound_ms(ids + distinct_all * q * 4, sum(reals) * q)[0]
        tot["min_bound_ms"] = bound_ms(ids + sum(reals) * 4 + distinct_all * q * 4,
                                       sum(reals) * q)[0]
        tot["times"] = {k: sum(r["times"][k] for r in rows) for k in rows[0]["times"]}
        per_q[q] = dict(tot, slices=rows)
        log(f"[8 batched] ell_combine_batched Q={q}, 4 slices: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in tot["times"].items())
            + f"; bound {tot['bound_ms']:.4f} ({tot['min_bound_ms']:.4f} with weights, "
            f"{tot['bound_gather_ms']:.4f} with a Q-vector a real slot), plain "
            f"{tot['plain_ms']:.4f}, torch.sparse.mm {tot['library_ms']:.4f}")
        del vals
    del csrs
    top = per_q[64]
    report["ell_combine_batched"] = dict(
        replaces="src/repro/serving/batch_engine.py:222 (XLA, no Pallas kernel)",
        shape=f"{len(slices)} RMAT ELL slices, {sum(reals)} real slots, Q=64, copy/sum "
              f"(Q=8 under q8)",
        max_abs_err=worst, ms=top["ms"], min_ms=top["min_ms"], times=top["times"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"], bound_by="bytes",
        min_bound_ms=top["min_bound_ms"], bound_gather_ms=top["bound_gather_ms"],
        library_ms=top["library_ms"], slices=top["slices"], q8=per_q[8])

    # segment_reduce at the batched engine's shapes, D = 64
    d = 64
    e = 2 * n                                      # default_config's edge_cap
    pick = torch.randint(0, g.n_edges, (e,), device=dev, generator=gen)
    ids = torch.sort(g.out.col_idx[pick]).values
    ids64 = ids.long()
    sv = torch.rand(e, d, device=dev, generator=gen)
    s_err = check_segment(sr, sv, ids, n, f"at the batched push shape D={d}")
    lib_out = torch.zeros(n, d, device=dev)
    bnd = bound_ms(e * 4 + e * d * 4 + n * d * 4, e * d)
    push = dict(E=e, D=d, num=n, ms=cuda_ms(lambda: sr.segment_reduce_cuda(sv, ids, n, "sum")),
                min_ms=cuda_ms(lambda: sr.segment_reduce_cuda(sv, ids, n, "min")),
                bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=cuda_ms(lambda: lib_out.index_add_(0, ids64, sv), 5))
    log(f"[8 batched] segment_reduce batched push E={e} D={d} num={n}: sum {push['ms']:.4f} ms, "
        f"min {push['min_ms']:.4f}, bound {push['bound_ms']:.4f} by {push['bound_by']}, "
        f"index_add_ {push['library_ms']:.4f}; sum, min, max bit-equal to "
        f"segment_reduce_ordered")
    del pick, ids, ids64, sv, lib_out
    merges = []
    lib_out = torch.zeros(n + 1, d, device=dev)
    for s in slices:
        part = torch.rand(s.rows, d, device=dev, generator=gen)
        s_err = max(s_err, check_segment(sr, part, s.row_id, n + 1,
                                         f"at the batched merge shape E={s.rows} D={d}"))
        rid64 = s.row_id.long()
        bnd = bound_ms(s.rows * 4 + s.rows * d * 4 + (n + 1) * d * 4, s.rows * d)
        # the kernel (over 0.1 ms, an (n + 1, 64) output a call) by CUDA
        # events; index_add_ (in place, down to 0.08 ms) by CUDA-graph replay
        merges.append(dict(
            rows=s.rows,
            ms=cuda_ms(lambda: sr.segment_reduce_cuda(part, s.row_id, n + 1, "sum"), 20, 3, 3),
            bound_ms=bnd[0], library_ms=graph_ms(lambda: lib_out.index_add_(0, rid64, part))))
        r = merges[-1]
        log(f"[8 batched] segment_reduce merge E={s.rows} D={d} num={n + 1}: {r['ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f}, index_add_ {r['library_ms']:.4f} (CUDA graph); "
            f"sum, min, max bit-equal to segment_reduce_ordered")
    del lib_out, part, rid64
    report["segment_reduce"]["batched"] = dict(push=push, merges=merges)
    report["segment_reduce"]["max_abs_err"] = max(report["segment_reduce"]["max_abs_err"], s_err)


def batched_phase(dev, A, E, S, BE, obs, ops, ell, g, pack, report) -> int:
    """Phase 8: the batched engine at RMAT-22 with `default_config`, through
    `serving.run_batch`. 64 sources: vertex 0, 62 distinct vertices of
    nonzero degree drawn with numpy seed 17, and the 7th again (lanes 6 and
    63). Counted run: bfs, sssp and ppr at Q = 64 (ell_combine_batched,
    segment_reduce and frontier_pack launches against the steps taken);
    lanes 0-6 and 63 bit-equal to solo engine.run, the duplicate pair
    equal, lanes 0 and 1 of bfs/sssp equal to scipy; ppr at Q = 8 (the
    slot-lanes route) counted the same way, lanes 0, 1, 7 bit-equal to
    solo engine.run; warm times and
    queries/s at Q = 1, 8, 64; pagerank at Q = 2 bit-equal to solo; ppr with
    the masked pull (frac 0.65) beside the dense pull (its frozen sub-tol
    drift logged), ppr_delta's masked pull bit-equal to its dense pull at a
    push budget of n / 16 (so that it pulls), each with the sparse branch
    taken at least once; telemetry counters; the peak
    of device memory. Returns the counted ell_combine_batched launches."""
    n, m = g.n_nodes, g.n_edges
    deg = g.out.degrees().cpu().numpy()
    if deg[0] <= 0:
        raise AssertionError("vertex 0 has no edge")
    rng = np.random.default_rng(17)
    draw = rng.choice(np.flatnonzero(deg[1:] > 0) + 1, 62, replace=False)
    sources = [0] + [int(x) for x in draw] + [int(draw[5])]
    cfg = S.default_config(g)
    progs = {"bfs": ("dist", A.bfs), "sssp": ("dist", A.sssp), "ppr": ("rank", A.ppr)}
    log(f"[8 batched] {len(sources)} sources, lanes 6 and 63 both vertex {sources[6]}; "
        f"default_config: frontier_cap={cfg.frontier_cap} edge_cap={cfg.edge_cap}")
    torch.cuda.empty_cache()

    # -- the counted run ------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    reads0 = dict(BE.HOST_READS)
    ops.reset_launches()
    runs = {}
    for name, (field, make) in progs.items():
        (mm, ss), t = timed(lambda: S.run_batch(make(0), g, pack, cfg, sources))
        runs[name] = (mm, ss, t)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reads = {k: BE.HOST_READS[k] - reads0[k] for k in reads0}
    pushes = pulls = 0
    for name, (mm, ss, t) in runs.items():
        last = int(torch.argmax(ss["per_query_iters"]))     # lives through every step
        pushes += int(ss["push_iters"][last])
        pulls += int(ss["pull_iters"][last])
        log(f"[8 batched] {name} Q=64 (counted run, cold): {t:.3f} s, steps "
            f"{int(ss['iterations'])} (push {int(ss['push_iters'][last])}, pull "
            f"{int(ss['pull_iters'][last])}), per-query iterations "
            f"{int(ss['per_query_iters'].min())}-{int(ss['per_query_iters'].max())}, "
            f"switches {int(ss['switches'].max())}")
    k = len(pack.slices)
    want = {"ell_combine_batched": k * pulls, "frontier_pack": pushes,
            "segment_reduce": pushes + k * pulls}
    mine = {key: counts[key] for key in want}
    log(f"[8 batched] launches on the batched path: {counts}; host reads {reads}; peak device "
        f"memory {peak / 2**30:.2f} GiB (graph and ELL slices included)")
    if mine != want:
        raise AssertionError(f"batched launches {mine}, expected {want} from {pushes} pushes "
                             f"and {pulls} pulls")
    report["segment_reduce"]["batched"].update(launches_push=pushes, launches_merge=k * pulls)

    # -- lanes against solo engine.run and scipy ------------------------------
    lanes = [0, 1, 2, 3, 4, 5, 6, 63]
    t0 = time.perf_counter()
    for name, (field, make) in progs.items():
        mm = runs[name][0]
        if not all(bit_equal(mm[f][:, 6], mm[f][:, 63]) for f in mm):
            raise AssertionError(f"batched {name}: the duplicate lanes 6 and 63 differ")
        for lane in lanes:
            solo, _ = E.run(make(sources[lane]), g, pack, cfg)
            for f in mm:
                if not bit_equal(mm[f][:, lane].contiguous(), solo[f]):
                    raise AssertionError(f"batched {name} lane {lane} field {f!r} differs "
                                         "from solo engine.run")
    log(f"[8 batched] bfs, sssp, ppr at Q=64: lanes {lanes} bit-equal to solo engine.run in "
        f"every field, lanes 6 and 63 equal ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for name in ("bfs", "sssp"):
        ref = scipy_dist(g, name == "bfs", [sources[0], sources[1]])
        for i in range(2):
            check_dist(f"batched {name} lane {i}", runs[name][0]["dist"][:, i], ref[i], ell.BIG)
    log(f"[8 batched] bfs and sssp lanes 0 and 1 equal scipy's distances "
        f"({time.perf_counter() - t0:.1f} s)")
    del runs

    # -- the slot-lanes route, counted: ppr at Q = 8 ---------------------------
    routes = {ell.batched_layout(8, s.width, 0, 0).route for s in pack.slices}
    if routes != {"slots"}:
        raise AssertionError(f"Q=8 takes the routes {routes}, not slot lanes alone")
    ops.reset_launches()
    (mm, ss), t = timed(lambda: S.run_batch(A.ppr(0), g, pack, cfg, sources[:8]))
    counts8 = ops.launch_counts()
    last = int(torch.argmax(ss["per_query_iters"]))
    push8, pull8 = int(ss["push_iters"][last]), int(ss["pull_iters"][last])
    want = {"ell_combine_batched": k * pull8, "frontier_pack": push8,
            "segment_reduce": push8 + k * pull8}
    mine = {key: counts8[key] for key in want}
    if pull8 <= 0 or mine != want:
        raise AssertionError(f"batched ppr Q=8 launches {mine}, expected {want} from {push8} "
                             f"pushes and {pull8} pulls")
    lanes8 = [0, 1, 7]
    for lane in lanes8:
        solo, _ = E.run(A.ppr(sources[lane]), g, pack, cfg)
        for f in mm:
            if not bit_equal(mm[f][:, lane].contiguous(), solo[f]):
                raise AssertionError(f"batched ppr Q=8 lane {lane} field {f!r} differs from "
                                     "solo engine.run")
    log(f"[8 batched] ppr Q=8 (counted run, slot lanes on every slice): {t:.3f} s, {push8} "
        f"pushes, {pull8} pulls, launches {mine}; lanes {lanes8} bit-equal to solo engine.run "
        f"in every field")
    report["ell_combine_batched"]["launches_q8"] = mine["ell_combine_batched"]
    del mm, ss

    # -- warm times and queries/s ---------------------------------------------
    for name, (field, make) in progs.items():
        for q in (1, 8, 64):
            src = sources[:q]
            timed(lambda: S.run_batch(make(0), g, pack, cfg, src))          # warm-up
            (mm, ss), t = timed(lambda: S.run_batch(make(0), g, pack, cfg, src))
            log(f"[8 batched] {name} Q={q}: {t:.3f} s warm, {q / t:.1f} queries/s, steps "
                f"{int(ss['iterations'])}")
    mm, _ = S.run_batch(A.pagerank(), g, pack, cfg, [0, 9])
    solo, _ = E.run(A.pagerank(), g, pack, cfg)
    for lane in range(2):
        if not all(bit_equal(mm[f][:, lane].contiguous(), solo[f]) for f in mm):
            raise AssertionError(f"batched pagerank lane {lane} differs from solo")
    log("[8 batched] pagerank (source-free) at Q=2: both lanes bit-equal to solo engine.run")

    # -- masked pull, telemetry ----------------------------------------------
    # ppr pulls every step; ppr_delta's residual frontier stays under
    # default_config's push budget (2n edges) at this size, so its run takes
    # a budget of n / 16 edges, where the heavy steps pull
    fetches0 = obs.TRANSFER_COUNT
    for name, field, dense in (("ppr", "rank", cfg),
                               ("ppr_delta", "rank", dataclasses.replace(cfg, edge_cap=n // 16))):
        make = getattr(A, name)
        masked = dataclasses.replace(dense, masked_pull=True)
        (md, sd), td = timed(lambda: S.run_batch(make(0), g, pack, dense, sources))
        torch.cuda.reset_peak_memory_stats()
        r0 = BE.HOST_READS["masked"]
        (mk, sk), tk = timed(lambda: S.run_batch(make(0), g, pack, masked, sources,
                                                 telemetry=True))
        mpeak = torch.cuda.max_memory_allocated()
        pulls = BE.HOST_READS["masked"] - r0
        tele = obs.tele_dict(obs.device_fetch(sk["tele"]))
        sparse = len(pack.slices) * pulls - tele["masked_dense_fallbacks"]
        if not sparse > 0:
            raise AssertionError(f"{name}: no slice took the masked pull's sparse branch "
                                 f"({pulls} pulls)")
        if name == "ppr_delta":
            same = all(bit_equal(md[f], mk[f]) for f in md)
            if not (same and torch.equal(sd["mode_trace"], sk["mode_trace"])):
                raise AssertionError("ppr_delta: the masked pull differs from the dense pull")
            what = "bit-equal to the dense pull"
        else:
            # a tol-thresholded program: a row is recomputed only where a
            # sender moved by more than tol, so sub-tol drift stays frozen in
            # the cache (the reference's semantics; its CPU tests hold the
            # port's masked ppr to the reference's own); logged, not held
            if not bool(torch.isfinite(mk[field]).all()):
                raise AssertionError("ppr: the masked pull gave non-finite ranks")
            diff = (md[field] - mk[field]).abs()
            l1 = float(diff.sum() / md[field].abs().sum())
            what = (f"off the dense pull by at most {float(diff.max()):.3g}, {l1:.3g} in "
                    "relative L1 norm (not held)")
        log(f"[8 batched] {name} Q=64 masked pull (edge_cap {dense.edge_cap}): {tk:.3f} s "
            f"against dense {td:.3f} s, {what}; steps {int(sk['iterations'])} (dense "
            f"{int(sd['iterations'])}); {pulls} pulls, one host read each, {sparse} slice "
            f"pulls on the sparse branch; peak {mpeak / 2**30:.2f} GiB; telemetry {tele}")
    mm, ss = S.run_batch(A.bfs(0), g, pack, cfg, sources, telemetry=True)
    tele = obs.tele_dict(obs.device_fetch(ss["tele"]))
    plane = obs.shard_plane(obs.device_fetch(ss["tele"]))
    if int(plane[0]) != tele["push_edges_scanned"] + tele["pull_edges_scanned"]:
        raise AssertionError(f"bfs telemetry: shard plane {plane} off the counters {tele}")
    log(f"[8 batched] bfs Q=64 telemetry {tele}, shard plane {plane.tolist()}; "
        f"{obs.TRANSFER_COUNT - fetches0} device_fetch transfers in these runs")
    return counts["ell_combine_batched"]


# ---------------------------------------------------------------------------
# phase 9: serving on a static graph
# ---------------------------------------------------------------------------

SERVE_ALGOS = ("bfs", "sssp", "ppr")
SERVE_REQUESTS = 384
SERVE_SLOTS = 32
SERVE_QUEUE_CAP = 48           # 16 a queue: a stream of 384 meets backpressure
SERVE_CACHE = 64               # 64 x 16.8 MB of host results at n = 4 M


def serve_stream(nz: np.ndarray, requests: int, hot_frac: float, seed: int) -> list:
    """`serve_graph`'s request stream: algorithms in turn, a hot set of
    requests // 8 sources drawn with numpy `default_rng(seed)`, here from
    the vertices of nonzero degree."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(nz, size=max(1, requests // 8))
    out = []
    for i in range(requests):
        src = rng.choice(hot) if rng.random() < hot_frac else rng.choice(nz)
        out.append((SERVE_ALGOS[i % len(SERVE_ALGOS)], int(src)))
    return out


def serve(srv, stream) -> tuple:
    """Submit `stream` as `serve_graph` does (a full queue pumps a round and
    retries), drain; (completions, backpressure events, host seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pressed = 0
    for algo, src in stream:
        while srv.submit(algo, src) is None:
            pressed += 1
            srv.pump()
    comps = srv.drain()
    torch.cuda.synchronize()
    return comps, pressed, time.perf_counter() - t0


def result_bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.int32), b.view(np.int32))


def profile_once(fn, what: str, top: int = 10) -> None:
    """torch.profiler over one warm call of `fn`: the device-busy share of
    its wall time and the operations that hold the device longest."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else e.self_cuda_time_total

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()                                       # profiler start-up, not reported
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    ka = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in ka)
    log(f"[profile] {what}: wall {wall_us / 1e3:.1f} ms (profiled), device busy "
        f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}%")
    for e in sorted(ka, key=dev_us, reverse=True)[:top]:
        log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")


def profile_pump(srv, top: int = 10) -> None:
    """`profile_once` over one warm pump round of `srv`."""
    live = {name: sum(r is not None for r in p.lane_rid) for name, p in srv.pools.items()}
    profile_once(srv.pump, f"one pump round of bfs, sssp, ppr pools ({live} live lanes)", top)


def hold_serving_kernels(dev, ell, g, pack, cfg) -> None:
    """The serving path's kernels at its shapes on the RMAT-22 graph, held
    against their plain versions before the counted stream (these launches
    are not counted): `ell_combine_batched` at Q = SERVE_SLOTS on each
    slice for the served programs' op pairs (bfs hop/min, sssp add_w/min,
    ppr copy/sum), bit-equal; `segment_reduce` at D = SERVE_SLOTS on the
    union push (E = edge_cap = 2n sorted destination ids, num = n) and on
    each slice's pull merge (E = its rows, num = n + 1) by `check_segment`;
    `frontier_pack` of an (n,) mask at the union's cap, bit-equal."""
    from repro_torch.kernels import frontier_pack as fp
    from repro_torch.kernels import segment_reduce as sr

    n, q = pack.n_nodes, SERVE_SLOTS
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    t0 = time.perf_counter()
    vals = torch.rand(n + 1, q, device=dev, generator=gen) * 64
    for s in pack.slices:
        for op, comb in (("hop", "min"), ("add_w", "min"), ("copy", "sum")):
            a = ell.ell_combine_batched_cuda(s.nbr, s.wgt, vals, op, comb)
            b = ell.ell_combine_batched_plain(s.nbr, s.wgt, vals, op, comb)
            if not bit_equal(a, b):
                raise AssertionError(f"ell_combine_batched {op}/{comb} Q={q} differs on the "
                                     f"{tuple(s.nbr.shape)} slice")
    del vals, a, b
    pick = torch.randint(0, g.n_edges, (cfg.edge_cap,), device=dev, generator=gen)
    ids = torch.sort(g.out.col_idx[pick]).values
    sv = torch.rand(cfg.edge_cap, q, device=dev, generator=gen)
    check_segment(sr, sv, ids, n, f"at the serving push shape E={cfg.edge_cap} D={q}")
    del pick, ids, sv
    for s in pack.slices:
        part = torch.rand(s.rows, q, device=dev, generator=gen)
        check_segment(sr, part, s.row_id, n + 1, f"at the serving merge shape E={s.rows} D={q}")
    del part
    mask = torch.rand(n, device=dev, generator=gen) < 0.05
    if not all(bit_equal(x, y) for x, y in zip(fp.frontier_pack_cuda(mask, cfg.frontier_cap),
                                                fp.frontier_pack_plain(mask, cfg.frontier_cap))):
        raise AssertionError(f"frontier_pack differs at the serving shape n={n} "
                             f"cap={cfg.frontier_cap}")
    log(f"[9 serving] kernels at the serving shapes, against their plain versions: "
        f"ell_combine_batched Q={q} on {len(pack.slices)} slices (hop/min, add_w/min, "
        f"copy/sum) bit-equal; segment_reduce D={q} at the union push (E={cfg.edge_cap}) and "
        f"{len(pack.slices)} merges, sum/min/max bit-equal to segment_reduce_ordered; "
        f"frontier_pack n={n} cap={cfg.frontier_cap} bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")


def serving_phase(dev, A, E, S, BE, obs, ops, ell, g, pack, profile: bool) -> dict:
    """Phase 9: serving on the RMAT-22 graph of phase 4 through
    `serving.GraphServer`. First the path's kernels at its shapes
    (`hold_serving_kernels`). (a) bfs, sssp and ppr from `make_catalog()`, 32
    slots each, `default_config`, cache 64, telemetry off, 384 requests
    submitted as `serve_graph` submits them (seed 0, hot fraction 0.25,
    sources of nonzero degree), queue cap 48: counted (launches, pool host
    reads against steps and admission rounds, `device_fetch` calls), every
    request completes, no lane owned after `drain`, the first 8
    engine-served completions of each algorithm, and the last 8 admitted
    into a recycled lane beside live batch-mates, bit-equal to solo
    `engine.run`, the first bfs and sssp ones equal to scipy, each cache
    hit bit-equal to its key's first completion; `run_batch` at Q = 32 on the
    stream's first 32 engine-served sources of each algorithm for the
    scheduler's overhead; host time of admission, harvest and pool reads in
    the stream, and admission on its own pools.
    (b) the same stream with telemetry: bit-equal to (a), latency
    percentiles, audit summary, fetches a pump, overhead. (c) ppr_delta,
    4 sources of moderate degree in a pool of 5: a lane preempted after 2
    steps and resumed in another lane, bit-equal to the 4 lanes run
    through; a degraded ppr_delta stream caches no degraded result. (d) `launch.serve_graph` at RMAT-16. Returns the counted
    launches of (a)."""
    from repro_torch.launch import catalog, serve_graph
    from repro_torch.serving import AlgoPool, GraphServer, SLOPolicy
    from repro_torch.serving.cache import make_key

    n = g.n_nodes
    deg = g.out.degrees().cpu().numpy()
    nz = np.flatnonzero(deg > 0)
    cat = catalog.make_catalog()
    progs = {a: cat[a] for a in SERVE_ALGOS}
    fields = catalog.result_fields(progs)
    cfg = S.default_config(g)
    stream = serve_stream(nz, SERVE_REQUESTS, 0.25, 0)
    log(f"[9 serving] {len(stream)} requests over {SERVE_ALGOS}, {SERVE_SLOTS} slots each, "
        f"queue cap {SERVE_QUEUE_CAP}, cache {SERVE_CACHE} (of the reference's 1024 "
        f"default: a cached RMAT-{int(np.log2(n))} result is {4 * n / 1e6:.1f} MB of host "
        f"memory); {len(set(stream))} distinct (algo, source) pairs")

    # warm-up at the pools' width: allocator and every kernel at Q = 32
    warm = [int(x) for x in np.random.default_rng(1).choice(nz, SERVE_SLOTS)]
    for a, p in progs.items():
        S.run_batch(p, g, pack, cfg, warm)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    hold_serving_kernels(dev, ell, g, pack, cfg)

    # -- (a) the counted stream ---------------------------------------------
    srv = GraphServer(g, pack, progs, slots=SERVE_SLOTS, cfg=cfg,
                      queue_cap=SERVE_QUEUE_CAP, cache_capacity=SERVE_CACHE)
    # host clocks inside the stream: admission (host enqueue, no wait),
    # harvest after the pool's read (the gather and its copy to the host),
    # and the pool reads themselves (which wait for the step)
    # lanes used before, and a recycled admission's live batch-mates, by rid
    rounds_admitted, used, recycled = set(), set(), {}
    spent = collections.Counter()
    admit, harvest, flags = AlgoPool.admit, AlgoPool.harvest, BE.pool_flags

    def counted_admit(pool, lane, rid, source):
        rounds_admitted.add((pool.name, srv._round))
        if (pool.name, lane) in used:
            recycled[rid] = sum(r is not None for r in pool.lane_rid)
        used.add((pool.name, lane))
        t0 = time.perf_counter()
        admit(pool, lane, rid, source)
        spent["admit"] += time.perf_counter() - t0

    def timed_harvest(pool):
        pool._flags()
        t0 = time.perf_counter()
        out = harvest(pool)
        spent["harvest"] += time.perf_counter() - t0
        spent["harvested"] += len(out)
        return out

    def timed_flags(st):
        t0 = time.perf_counter()
        out = flags(st)
        spent["read"] += time.perf_counter() - t0
        return out

    AlgoPool.admit, AlgoPool.harvest, BE.pool_flags = counted_admit, timed_harvest, timed_flags
    torch.cuda.reset_peak_memory_stats()
    reads0, fetch0 = dict(BE.HOST_READS), obs.TRANSFER_COUNT
    ops.reset_launches()
    try:
        comps, pressed, t_a = serve(srv, stream)
    finally:
        AlgoPool.admit, AlgoPool.harvest, BE.pool_flags = admit, harvest, flags
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reads = {k: BE.HOST_READS[k] - reads0[k] for k in reads0}
    steps = {name: srv.pools[name].steps for name in SERVE_ALGOS}
    queries = {name: srv.pools[name].engine_queries for name in SERVE_ALGOS}
    hits = sum(c.from_cache for c in comps)
    if len(comps) != len(stream) or any(c.result is None for c in comps):
        raise AssertionError(f"{len(comps)} completions of {len(stream)} requests")
    if any(r is not None for p in srv.pools.values() for r in p.lane_rid):
        raise AssertionError("a lane is still owned after drain")
    if pressed <= 0:
        raise AssertionError(f"queue cap {SERVE_QUEUE_CAP} met no backpressure")
    want = {"loop": 0, "gmode": 0, "masked": 0,
            "pool": sum(steps.values()) + len(rounds_admitted)}
    if reads != want:
        raise AssertionError(f"pool host reads {reads}, expected {want} from {steps} steps "
                             f"and {len(rounds_admitted)} admission rounds")
    if obs.TRANSFER_COUNT != fetch0:
        raise AssertionError(f"{obs.TRANSFER_COUNT - fetch0} device_fetch calls with "
                             "telemetry off")
    kernels = {k: counts[k] for k in ("ell_combine_batched", "segment_reduce", "frontier_pack")}
    if not all(kernels.values()):
        raise AssertionError(f"a kernel of the serving path was not launched: {kernels}")
    MEASURED["served_qps"] = len(comps) / t_a
    log(f"[9 serving] (a) {len(comps)} requests in {t_a:.3f} s warm: {len(comps) / t_a:.1f} "
        f"queries/s ({sum(queries.values()) / t_a:.1f} engine queries/s), {hits} cache hits, "
        f"{pressed} backpressure events, {srv._round} pump rounds")
    for name in SERVE_ALGOS:
        log(f"[9 serving]   pool {name}: {queries[name]} engine queries, {steps[name]} "
            f"batched steps x {SERVE_SLOTS} slots")
    log(f"[9 serving] (a) host reads {reads}: one a pool step ({sum(steps.values())}) plus "
        f"one a round of admissions ({len(rounds_admitted)}); 0 device_fetch calls; launches "
        f"{kernels}; peak device memory {peak / 2**30:.2f} GiB")
    n_adm = sum(queries.values())
    log(f"[9 serving] (a) host time in the stream: admission {spent['admit']:.3f} s "
        f"({spent['admit'] / n_adm * 1e3:.3f} ms a lane, enqueue only), harvest after the "
        f"pool's read {spent['harvest']:.3f} s ({spent['harvest'] / spent['harvested'] * 1e3:.3f} "
        f"ms a lane: the gather and its copy of {4 * n / 1e6:.1f} MB a lane to the host), pool "
        f"reads {spent['read']:.3f} s (waiting for the steps), the rest "
        f"{t_a - spent['admit'] - spent['harvest'] - spent['read']:.3f} s (step enqueue, "
        f"scheduler)")

    # -- (a) checks ------------------------------------------------------------
    t0 = time.perf_counter()
    engine = [c for c in comps if not c.from_cache]
    first = {}
    for c in engine:
        first.setdefault((c.algo, c.source), c.result)
    for c in comps:
        if c.from_cache and not result_bits_equal(c.result, first[(c.algo, c.source)]):
            raise AssertionError(f"cache hit rid {c.rid} differs from its first completion")
    served = {a: [c for c in engine if c.algo == a] for a in SERVE_ALGOS}
    make = {"bfs": A.bfs, "sssp": A.sssp, "ppr": A.ppr}
    for a in SERVE_ALGOS:
        for c in served[a][:8]:
            solo, _ = E.run(make[a](c.source), g, pack, cfg)
            if not result_bits_equal(c.result, solo[fields[a]][:-1].cpu().numpy()):
                raise AssertionError(f"served {a} rid {c.rid} (source {c.source}) differs "
                                     "from solo engine.run")
    log(f"[9 serving] (a) every request completed; {hits} cache hits bit-equal to their "
        f"key's first completion; the first 8 engine-served completions of each algorithm "
        f"bit-equal to solo engine.run ({time.perf_counter() - t0:.1f} s)")
    # the last 8 of each admitted into a recycled lane, beside live batch-mates
    t0 = time.perf_counter()
    late = {a: [c for c in served[a] if c.rid in recycled][-8:] for a in SERVE_ALGOS}
    for a in SERVE_ALGOS:
        if len(late[a]) < 8 or not any(recycled[c.rid] for c in late[a]):
            raise AssertionError(f"{a}: {len(late[a])} engine-served completions in recycled "
                                 "lanes, or none beside live batch-mates")
        for c in late[a]:
            solo, _ = E.run(make[a](c.source), g, pack, cfg)
            if not result_bits_equal(c.result, solo[fields[a]][:-1].cpu().numpy()):
                raise AssertionError(f"served {a} rid {c.rid} (source {c.source}, a recycled "
                                     "lane) differs from solo engine.run")
    log(f"[9 serving] (a) the last 8 engine-served completions of each algorithm admitted "
        f"into a recycled lane (rids {[c.rid for a in SERVE_ALGOS for c in late[a]]}, live "
        f"batch-mates at admission {[recycled[c.rid] for a in SERVE_ALGOS for c in late[a]]}) "
        f"bit-equal to solo engine.run ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for a in ("bfs", "sssp"):
        c = served[a][0]
        ref = scipy_dist(g, a == "bfs", c.source)
        got = c.result.astype(np.float64)
        got[got >= ell.BIG] = np.inf
        if not np.array_equal(got, ref):
            raise AssertionError(f"served {a} source {c.source}: "
                                 f"{int(np.sum(got != ref))} distances differ from scipy")
    log(f"[9 serving] (a) served bfs source {served['bfs'][0].source} and sssp source "
        f"{served['sssp'][0].source} equal scipy's distances ({time.perf_counter() - t0:.1f} s)")

    # -- run_batch at Q = 32 on the stream's first engine-served sources -------
    t_rb = {}
    for a in SERVE_ALGOS:
        src = [c.source for c in served[a][:SERVE_SLOTS]]
        timed(lambda: S.run_batch(progs[a], g, pack, cfg, src))
        (_, ss), t_rb[a] = timed(lambda: S.run_batch(progs[a], g, pack, cfg, src))
        log(f"[9 serving] run_batch {a} Q={len(src)}: {t_rb[a]:.3f} s warm, "
            f"{len(src) / t_rb[a]:.1f} queries/s, steps {int(ss['iterations'])}")
    ideal = sum(queries[a] / SERVE_SLOTS * t_rb[a] for a in SERVE_ALGOS)
    rb_rate = len(SERVE_ALGOS) * SERVE_SLOTS / sum(t_rb.values())
    log(f"[9 serving] run_batch at Q={SERVE_SLOTS}: {rb_rate:.1f} queries/s over the three; "
        f"the stream's {sum(queries.values())} engine queries in full batches would take "
        f"{ideal:.3f} s, the scheduler took {t_a:.3f} s: overhead {100 * (t_a / ideal - 1):+.1f}%")
    del srv

    # -- admission on its own pools, device work included ----------------------
    for a in SERVE_ALGOS:
        pool = AlgoPool(a, progs[a], g, pack, cfg, SERVE_SLOTS)
        src = [c.source for c in served[a][:SERVE_SLOTS]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lane, s in enumerate(src):
            pool.admit(lane, lane, s)
        pool._flags()                              # the read after a round of admissions
        t_adm = (time.perf_counter() - t0) / len(src)
        log(f"[9 serving] {a} pool of {SERVE_SLOTS}: {len(src)} admissions in a row "
            f"{t_adm * 1e3:.3f} ms a lane (host clock, ending in the pool's read)")
        del pool
    torch.cuda.empty_cache()

    # -- (b) the same stream with telemetry -----------------------------------
    srv = GraphServer(g, pack, progs, slots=SERVE_SLOTS, cfg=cfg,
                      queue_cap=SERVE_QUEUE_CAP, cache_capacity=SERVE_CACHE, telemetry=True)
    fetch0 = obs.TRANSFER_COUNT
    comps_b, _, t_b = serve(srv, stream)
    fetches = obs.TRANSFER_COUNT - fetch0
    if [(c.rid, c.algo, c.source, c.iterations, c.from_cache) for c in comps_b] != [
            (c.rid, c.algo, c.source, c.iterations, c.from_cache) for c in comps]:
        raise AssertionError("telemetry changed the completions")
    if not all(result_bits_equal(a.result, b.result) for a, b in zip(comps, comps_b)):
        raise AssertionError("telemetry changed a result")
    st = srv.stats()
    log(f"[9 serving] (b) telemetry on: {t_b:.3f} s ({100 * (t_b / t_a - 1):+.1f}% against "
        f"(a)), results bit-equal to (a); {fetches} device_fetch calls in {srv._round} pump "
        f"rounds ({fetches / srv._round:.2f} a round)")
    m = st["obs"]["metrics"]
    for a in SERVE_ALGOS:
        parts = []
        for what in ("latency_total_s", "queue_wait_s", "resident_s"):
            h = m[f"{a}.{what}"]
            parts.append(f"{what} p50/p95/p99 {h['p50'] * 1e3:.1f}/{h['p95'] * 1e3:.1f}/"
                         f"{h['p99'] * 1e3:.1f} ms")
        au = st["pools"][a]["audit"]
        log(f"[9 serving] (b) {a} (n={m[f'{a}.latency_total_s']['count']}): "
            + "; ".join(parts) + f"; audit {au['push']} push / {au['pull']} pull steps, "
            f"{au['mode_switches']} switches; tele {st['pools'][a]['tele']}")
    if profile:
        srv2 = GraphServer(g, pack, progs, slots=SERVE_SLOTS, cfg=cfg, cache_capacity=0)
        for algo, src in stream[:3 * SERVE_SLOTS]:
            srv2.submit(algo, src)
        for _ in range(3):
            srv2.pump()
        profile_pump(srv2)
        del srv2
    del srv, comps_b, comps, engine, first, served
    torch.cuda.empty_cache()

    # -- (c) preempt and resume, degraded serving ------------------------------
    pd = cat["ppr_delta"]
    # moderate degrees: a hub's threshold tol x deg exceeds its unit residual
    by_deg = nz[np.argsort(deg[nz], kind="stable")]
    src4 = [int(by_deg[int(q * (len(by_deg) - 1))]) for q in (0.5, 0.75, 0.9, 0.97)]

    def run_pool(preempt_after: int) -> dict:
        # a spare fifth lane: the victim resumes in a lane that never held
        # its state, so only written-back columns can give its result
        pool = AlgoPool("ppr_delta", pd, g, pack, cfg, len(src4) + 1)
        for lane, s in enumerate(src4):
            pool.admit(lane, lane, s)
        out, moved = {}, None
        while pool.live():
            if pool.steps == preempt_after:
                live = [i for i, r in enumerate(pool.lane_rid) if r is not None]
                lane = live[0]
                rid = pool.lane_rid[lane]
                saved = pool.preempt(lane)
                to = next(i for i in pool.free_lanes() if i != lane)
                pool.admit_resume(to, rid, saved)
                moved = (rid, lane, to, saved["it"], len(live))
            pool.step()
            out.update({r: (res, it) for _l, r, res, it, _x in pool.harvest()})
        return out, moved

    whole, _ = run_pool(-1)
    cut, moved = run_pool(2)
    if moved is None or whole[moved[0]][1] <= moved[3] or moved[1] == moved[2]:
        raise AssertionError(f"no lane was preempted mid-run and resumed in another ({moved})")
    for rid in whole:
        if whole[rid][1] != cut[rid][1] or not result_bits_equal(whole[rid][0], cut[rid][0]):
            raise AssertionError(f"ppr_delta rid {rid}: preempt -> resume differs from the "
                                 "uninterrupted run")
    log(f"[9 serving] (c) ppr_delta, 4 lanes of a pool of 5 (sources {src4}, degrees "
        f"{[int(deg[x]) for x in src4]}): rid {moved[0]} preempted from lane {moved[1]} after "
        f"{moved[3]} iterations with {moved[4]} lanes live and resumed in lane {moved[2]}; all "
        f"4 bit-equal to the uninterrupted run, iterations "
        f"{[whole[r][1] for r in sorted(whole)]}")
    pol = SLOPolicy(degrade_algos=("ppr_delta",), degrade_queue_depth=2)
    srv = GraphServer(g, pack, {"ppr_delta": pd}, slots=4, cfg=cfg,
                      cache_capacity=SERVE_CACHE, slo=pol)
    dsrc = [int(x) for x in nz[1:13]]
    for s in dsrc:
        srv.submit("ppr_delta", s)
    dcomps = srv.drain()
    degraded = [c for c in dcomps if c.degraded]
    main = srv.pools["ppr_delta"]
    if len(dcomps) != len(dsrc) or not degraded:
        raise AssertionError(f"{len(dcomps)} completions, {len(degraded)} degraded")
    if any(make_key(srv.graph_version, "ppr_delta", c.source, main.cache_params) in srv.cache
           for c in degraded):
        raise AssertionError("a degraded result entered the cache")
    if len(srv.cache) != len(dcomps) - len(degraded):
        raise AssertionError(f"{len(srv.cache)} cache entries for "
                             f"{len(dcomps) - len(degraded)} full-tolerance results")
    log(f"[9 serving] (c) degraded ppr_delta stream: {len(dcomps)} requests, "
        f"{len(degraded)} served by the degraded pool (tol x {pol.degrade_factor:g}), none "
        f"cached; {len(srv.cache)} full-tolerance results cached; slo {srv.slo_counts}")
    del srv, dcomps, degraded, whole, cut
    torch.cuda.empty_cache()

    # -- (d) the CLI ------------------------------------------------------------
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve_graph.main(["--graph", "rmat", "--scale", "16", "--slots", "8",
                               "--requests", "48", "--telemetry"])
    for line in out.getvalue().splitlines():
        log(f"[9 serving] (d) {line}")
    if rc != 0 or "48 queries" not in out.getvalue():
        raise AssertionError(f"serve_graph returned {rc}")
    log(f"[9 serving] (d) serve_graph at RMAT-16 on the card: {time.perf_counter() - t0:.1f} s")
    return kernels


# ---------------------------------------------------------------------------
# phase 10: streaming updates on the RMAT-22 graph
# ---------------------------------------------------------------------------

STREAM_CAP = 1024              # delta_cap: 128 directed inserts a batch fill it in 8
STREAM_INSERTS = 64            # undirected inserts a batch (weights 1-64)
STREAM_DELETES = 32            # undirected deletes of live base edges a batch
STREAM_BATCHES = 10
STREAM_ALGOS = ("bfs", "sssp", "ppr_delta")
STREAM_REQUESTS = 192
STREAM_UPDATE_EVERY = 32
STREAM_Q = 32


def time_methods(pairs, spent: collections.Counter) -> None:
    """Wrap each (object, method name, label) so that `spent[label]` adds
    the host seconds (card synchronised) of its calls; a wrapped call inside
    another of the same `pairs` counts once, in the outer one."""
    active = []

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def timed_fn(*a, **k):
            outer = not active
            active.append(label)
            if outer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                active.pop()
                if outer:
                    torch.cuda.synchronize()
                    spent[label] += time.perf_counter() - t0

        setattr(obj, name, timed_fn)

    for obj, name, label in pairs:
        wrap(obj, name, label)


def split_apply(sg) -> collections.Counter:
    """Host seconds inside `sg`'s sweeps, boundary pass, view
    materialization and rebuild, by wrappers on the instance."""
    spent = collections.Counter()
    time_methods([(sg, name, name) for name in ("_sweep", "_boundary_of", "_materialize",
                                                "compact", "finish_compact",
                                                "begin_compact")], spent)
    return spent


def apply_split(spent, total: float) -> str:
    parts = {"sweeps": spent["_sweep"], "boundary": spent["_boundary_of"],
             "materialize": spent["_materialize"],
             "rebuild": spent["compact"] + spent["finish_compact"] + spent["begin_compact"]}
    parts["edits"] = total - sum(parts.values())
    return ", ".join(f"{k} {v:.3f}" for k, v in parts.items())


def fold_graph(sg, dev):
    """The graph folded from `sg`'s live edges (base minus deleted, then
    the pending insertions), built from scratch, and its ELL pack."""
    from repro_torch.graph import pack_ell
    from repro_torch.graph.csr import from_edges

    src, dst = sg.live_edges_coo()
    w = sg._base.out.weights[~sg._dead_out]
    if sg._ins:
        w = torch.cat([w, torch.tensor([e[2] for e in sg._ins], dtype=torch.float32,
                                       device=dev)])
    gf = from_edges(src, dst, sg.n, w, directed=True, dedupe=False, device=dev)
    return gf, pack_ell(gf.inc)


def hold_overlay(A, E, sg, srcs, dev, count) -> float:
    """bfs and sssp from `srcs` through `engine.run(delta=sg.delta)` on the
    overlay views (counted) bit-equal to runs on the graph folded from the
    live edges; returns the host seconds of the checks."""
    t0 = time.perf_counter()
    gf, pf = fold_graph(sg, dev)
    cfg_o = E.EngineConfig(frontier_cap=sg.n, edge_cap=sg.graph.n_edges)
    cfg_f = E.EngineConfig(frontier_cap=sg.n, edge_cap=gf.n_edges)
    for name in ("bfs", "sssp"):
        for s in srcs:
            m_o, _ = count(lambda: E.run(A.ALL[name](s), sg.graph, sg.pack, cfg_o,
                                         delta=sg.delta))
            m_f, _ = E.run(A.ALL[name](s), gf, pf, cfg_f)
            if not bit_equal(m_o["dist"], m_f["dist"]):
                bad = int((m_o["dist"] != m_f["dist"]).sum())
                raise AssertionError(f"overlay {name}({s}) differs from the folded graph's "
                                     f"in {bad} vertices (version {sg.version})")
    del gf, pf
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def hold_streaming_kernels(dev, ell, sr, fp, sg, nz) -> None:
    """The streaming path's kernels at its shapes against their plain
    versions (these launches are not counted): `ell_combine_batched` at
    Q = 32 and `ell_combine` on the overlay's neutralized slices and on a
    full delta slice of `STREAM_CAP` rows whose receivers are out of order
    and repeat (bit-equal); `segment_reduce` at D = 32 on the union push
    with the delta's COO lanes (E = 2n + cap) and on the delta slice's
    merge after its stable sort, by `check_segment`; `frontier_pack` at the
    union's cap."""
    from repro_torch.graph.packing import delta_ell_slice

    n, q = sg.n, STREAM_Q
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    recv = rng.permutation(np.repeat(rng.choice(nz, STREAM_CAP // 4, replace=False), 4))
    send = rng.choice(nz, STREAM_CAP)
    dsl = delta_ell_slice(recv, send, rng.integers(1, 65, STREAM_CAP).astype(np.float32),
                          n, STREAM_CAP, device=dev)
    if dsl.rows_ascending or bool((dsl.row_id[1:] >= dsl.row_id[:-1]).all()):
        raise AssertionError("the delta slice's receivers should be out of order")
    slices = list(sg.pack.slices[:-1]) + [dsl]
    dead = sum(int((s.nbr[:, :] == n).sum()) for s in slices[:-1])
    vals = torch.rand(n + 1, q, device=dev, generator=gen) * 64
    v1 = vals[:, 0].contiguous()
    for s in slices:
        for op, comb in (("hop", "min"), ("add_w", "min"), ("copy", "sum")):
            if not bit_equal(ell.ell_combine_batched_cuda(s.nbr, s.wgt, vals, op, comb),
                             ell.ell_combine_batched_plain(s.nbr, s.wgt, vals, op, comb)):
                raise AssertionError(f"ell_combine_batched {op}/{comb} Q={q} differs on the "
                                     f"streaming {tuple(s.nbr.shape)} slice")
            if not bit_equal(ell.ell_combine_cuda(s.nbr, s.wgt, v1, op, comb),
                             ell.ell_combine_plain(s.nbr, s.wgt, v1, op, comb)):
                raise AssertionError(f"ell_combine {op}/{comb} differs on the streaming "
                                     f"{tuple(s.nbr.shape)} slice")
    del vals, v1
    e_push = 2 * n
    pick = torch.randint(0, sg.graph.n_edges, (e_push,), device=dev, generator=gen)
    lanes = torch.full((STREAM_CAP,), n, dtype=torch.int32, device=dev)
    lanes[:STREAM_CAP // 2] = torch.from_numpy(recv[:STREAM_CAP // 2].astype(np.int32)).to(dev)
    ids = torch.sort(torch.cat([sg.graph.out.col_idx[pick], lanes])).values
    sv = torch.rand(ids.shape[0], q, device=dev, generator=gen)
    check_segment(sr, sv, ids, n, f"streaming push E={ids.shape[0]} D={q}")
    del pick, ids, sv
    mids, order = torch.sort(dsl.row_id, stable=True)
    part = torch.rand(dsl.rows, q, device=dev, generator=gen)[order].contiguous()
    check_segment(sr, part, mids, n + 1, f"delta merge E={dsl.rows} D={q}")
    mask = torch.rand(n, device=dev, generator=gen) < 0.05
    if not all(bit_equal(x, y) for x, y in zip(fp.frontier_pack_cuda(mask, n),
                                                fp.frontier_pack_plain(mask, n))):
        raise AssertionError(f"frontier_pack differs at the streaming shape n={n} cap={n}")
    log(f"[10 streaming] kernels at the streaming shapes, against their plain versions: "
        f"ell_combine_batched Q={q} and ell_combine on {len(slices) - 1} overlay slices "
        f"({dead} neutralized or padding slots) and a full delta slice of {dsl.rows} rows "
        f"(receivers out of order, each 4 times), hop/min, add_w/min, copy/sum bit-equal; "
        f"segment_reduce D={q} at the union push with delta lanes (E={e_push + STREAM_CAP}) "
        f"and the delta merge (E={dsl.rows}), sum/min/max bit-equal to "
        f"segment_reduce_ordered; frontier_pack n={n} bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")


def streaming_phase(dev, A, E, S, ops, ell, sr, fp, g, nz) -> dict:
    """Phase 10: streaming updates on phase 4's RMAT-22 graph. (a) a
    `StreamingGraph` at delta_cap 1024 (device sweeps): ten update batches
    of 64 inserts and 32 deletes drawn as `stream_graph` draws them (seed
    0), so the pending insertions pass the cap and rebuild; then a
    compaction begun, a batch mid-flight and the compaction finished; after
    each, bfs and sssp from two sources through `engine.run(delta=)` held
    bit-equal to runs on the graph folded from the live edges. Then the
    path's kernels at its shapes (`hold_streaming_kernels`). (b)
    `incremental_batch` after an insert+delete batch at Q = 32 (bfs, sssp,
    wcc, ppr, ppr_delta) and after a deletion-only batch at Q = 1 (kcore(16),
    mis), each against `run_batch` from scratch on the same views, timed
    beside it. (c) a `GraphServer(delta_cap=1024)` of bfs, sssp and
    ppr_delta, 32 slots each, serving 192 requests with an update batch
    every 32, every completion held against `run_batch` on the views of the
    version it completed under. (d) `stream_graph --verify` at RMAT-16.
    Returns the counted launches of (a)-(c)."""
    from repro_torch.launch import stream_graph
    from repro_torch.serving import GraphServer
    from repro_torch.streaming import StreamingGraph, incremental_batch
    from repro_torch import streaming as STREAM
    from repro_torch.serving import scheduler as SCHED
    from repro_torch.streaming import incremental as INC

    n = g.n_nodes
    counted = collections.Counter()

    def count(fn):
        ops.reset_launches()
        out = fn()
        counted.update(ops.launch_counts())
        return out

    # -- (a) the overlay ----------------------------------------------------------
    (sg, t_build) = timed(lambda: StreamingGraph(g, delta_cap=STREAM_CAP))
    log(f"[10 streaming] (a) StreamingGraph(delta_cap={STREAM_CAP}, sweep=auto) over RMAT-22 "
        f"(n={n}, m={g.n_edges}): {t_build:.3f} s (pack with edge->slot map, host copies "
        f"of row_ptr/col_idx)")
    spent = split_apply(sg)
    rng = np.random.default_rng(0)
    srcs = [int(x) for x in np.random.default_rng(3).choice(nz, 2)]
    t_hold, rebuilt = 0.0, []
    for b in range(1, STREAM_BATCHES + 1):
        ins, dels = stream_graph.random_update_batch(rng, sg, STREAM_INSERTS, STREAM_DELETES)
        pending = len(sg._ins)
        spent.clear()
        rep, t = timed(lambda: count(lambda: sg.apply(ins, dels)))
        if rep.rebuild:
            rebuilt.append(b)
        if rep.rebuild != (pending + rep.n_inserted > STREAM_CAP):
            raise AssertionError(f"batch {b}: rebuild {rep.rebuild} with {pending} pending "
                                 f"and {rep.n_inserted} inserted at cap {STREAM_CAP}")
        log(f"[10 streaming] (a) batch {b}: +{rep.n_inserted}/-{rep.n_deleted} "
            f"(ignored {rep.n_ignored}), pending {len(sg._ins)}, rebuild={rep.rebuild}; "
            f"apply {t:.3f} s ({apply_split(spent, t)}); dirty {int(rep.dirty_src.sum())}, "
            f"affected {int(rep.affected_del.sum())}, boundary {rep.boundary.size}")
        t_hold += hold_overlay(A, E, sg, srcs, dev, count)
    if not rebuilt:
        raise AssertionError("no batch overflowed the delta buffer")
    spent.clear()
    _, t_begin = timed(sg.begin_compact)
    ins, dels = stream_graph.random_update_batch(rng, sg, STREAM_INSERTS, STREAM_DELETES)
    mid, t_mid = timed(lambda: count(lambda: sg.apply(ins, dels)))
    t_hold += hold_overlay(A, E, sg, srcs, dev, count)
    merged, t_fin = timed(sg.finish_compact)
    if not merged.rebuild or merged.n_inserted != mid.n_inserted or sg.rebuilds != len(rebuilt) + 1:
        raise AssertionError(f"compaction: merged {merged.n_inserted} inserts of "
                             f"{mid.n_inserted}, {sg.rebuilds} rebuilds")
    t_hold += hold_overlay(A, E, sg, srcs, dev, count)
    log(f"[10 streaming] (a) rebuild on batch {rebuilt} (pending insertions past the cap); "
        f"compaction: begin {t_begin:.3f} s, a batch mid-flight {t_mid:.3f} s "
        f"(+{mid.n_inserted}/-{mid.n_deleted}), finish {t_fin:.3f} s (merged report "
        f"+{merged.n_inserted}/-{merged.n_deleted}); bfs and sssp from {srcs} on the overlay "
        f"bit-equal to the folded graph after every batch, the mid-flight one and the "
        f"finish ({t_hold:.1f} s of checks); stats {sg.stats()}")

    # -- the kernels at the streaming shapes -----------------------------------------
    hold_streaming_kernels(dev, ell, sr, fp, sg, nz)
    torch.cuda.empty_cache()

    # -- (b) incremental against full recompute ------------------------------------
    cfg = S.default_config(sg.graph)
    src32 = [int(x) for x in np.random.default_rng(17).choice(nz, STREAM_Q)]
    progs = {"bfs": A.bfs(0), "sssp": A.sssp(0), "wcc": A.wcc(), "ppr": A.ppr(0),
             "ppr_delta": A.ppr_delta(0)}
    prev = {k: S.run_batch(p, sg.graph, sg.pack, cfg, src32, delta=sg.delta)[0]
            for k, p in progs.items()}
    ins, dels = stream_graph.random_update_batch(rng, sg, STREAM_INSERTS, STREAM_DELETES)
    rep, t = timed(lambda: count(lambda: sg.apply(ins, dels)))
    log(f"[10 streaming] (b) insert+delete batch +{rep.n_inserted}/-{rep.n_deleted}: apply "
        f"{t:.3f} s; dirty sources {int(rep.dirty_src.sum())} of {n}, affected "
        f"{int(rep.affected_del.sum())}, boundary {rep.boundary.size}")
    ratios = {}

    def refresh(name, prog, sources, prev_m, report, exact_fields, mode):
        count(lambda: incremental_batch(prog, sg, cfg, sources, prev_m, report))   # warm
        (m_i, info), t_i = timed(lambda: count(
            lambda: incremental_batch(prog, sg, cfg, sources, prev_m, report)))
        S.run_batch(prog, sg.graph, sg.pack, cfg, sources, delta=sg.delta)        # warm
        (m_f, st_f), t_f = timed(lambda: S.run_batch(prog, sg.graph, sg.pack, cfg, sources,
                                                     delta=sg.delta))
        if info["mode"] != mode:
            raise AssertionError(f"{name}: regime {info['mode']}, expected {mode}")
        if mode == "selective-rerun":
            # re-run (dirty) lanes bit-equal to full recompute; clean lanes keep
            # their previous result (a lane's sums fold in an order its
            # batch-mates' frontiers set, so only the re-run lanes share bits
            # with a batch of other lanes)
            dirty = torch.from_numpy(report.dirty_src[np.asarray(sources)]).to(dev)
            for k in exact_fields:
                want = torch.where(dirty[None, :], m_f[k], prev_m[k])
                if not bit_equal(m_i[k], want):
                    raise AssertionError(f"selective {name} field {k} differs")
        else:
            for k in (exact_fields or ()):
                if not bit_equal(m_i[k], m_f[k]):
                    raise AssertionError(f"incremental {name} field {k} differs from full "
                                         "recompute")
        if not exact_fields:
            d = float((m_i["rank"] - m_f["rank"]).abs().max())
            if not d < 2e-3:
                raise AssertionError(f"incremental {name} rank {d:.3g} from full recompute")
            how = f"rank within {d:.3g} of it (limit 2e-3)"
        else:
            how = "bit-equal"
        ratios[name] = t_f / t_i
        log(f"[10 streaming] (b) {name} Q={len(sources)} {info['mode']}: incremental "
            f"{t_i:.3f} s ({info['iterations']} iterations), full recompute {t_f:.3f} s "
            f"({int(st_f['iterations'])} iterations): {t_f / t_i:.2f}x; {how}")
        return m_i

    for name in ("bfs", "sssp", "wcc"):
        refresh(name, progs[name], src32, prev[name], rep, list(prev[name]),
                "monotone-incremental")
    refresh("ppr", progs["ppr"], src32, prev["ppr"], rep, list(prev["ppr"]),
            "selective-rerun")
    refresh("ppr_delta", progs["ppr_delta"], src32, prev["ppr_delta"], rep, None,
            "residual-resume")
    del prev
    torch.cuda.empty_cache()
    one = src32[:1]
    progs1 = {"kcore": A.kcore(16), "mis": A.mis()}
    prev1 = {k: S.run_batch(p, sg.graph, sg.pack, cfg, one, delta=sg.delta)[0]
             for k, p in progs1.items()}
    _, dels = stream_graph.random_update_batch(rng, sg, 0, STREAM_DELETES)
    rep, t = timed(lambda: count(lambda: sg.apply(deletes=dels)))
    log(f"[10 streaming] (b) deletion-only batch -{rep.n_deleted}: apply {t:.3f} s; "
        f"affected {int(rep.affected_del.sum())}, boundary {rep.boundary.size}")
    refresh("kcore(16)", progs1["kcore"], one, prev1["kcore"], rep, list(prev1["kcore"]),
            "cascade-resume")
    refresh("mis", progs1["mis"], one, prev1["mis"], rep, list(prev1["mis"]),
            "reelect-resume")
    log(f"[10 streaming] (b) full recompute / incremental: "
        + ", ".join(f"{k} {v:.2f}x" for k, v in ratios.items()))
    del prev1, sg, progs, progs1
    torch.cuda.empty_cache()

    # -- (c) the streaming server ------------------------------------------------------
    cat_progs = {"bfs": A.bfs(0), "sssp": A.sssp(0), "ppr_delta": A.ppr_delta(0)}
    cfg = S.default_config(g)
    torch.cuda.reset_peak_memory_stats()
    srv = GraphServer(g, None, cat_progs, slots=SERVE_SLOTS, cfg=cfg,
                      queue_cap=SERVE_QUEUE_CAP, cache_capacity=SERVE_CACHE,
                      delta_cap=STREAM_CAP)
    snapshots = {0: (srv.sg.graph, srv.sg.pack, srv.sg.delta)}
    checked = {"exact": 0, "residual": 0, "worst": 0.0}

    def verify(versions):
        """Hold every completion of `versions` against `run_batch` on that
        version's views, grouped by (version, algo); drop the views."""
        for ver in versions:
            gv, pv, dv = snapshots.pop(ver)
            for algo, prog in cat_progs.items():
                group = [c for c in srv.completions if c.graph_version == ver and c.algo == algo]
                for lo in range(0, len(group), STREAM_Q):
                    part = group[lo:lo + STREAM_Q]
                    ref, _ = S.run_batch(prog, gv, pv, cfg, [c.source for c in part], delta=dv)
                    want = ref[prog.param("result", prog.primary)][:-1].T.cpu().numpy()
                    for c, w in zip(part, want):
                        if algo == "ppr_delta":
                            d = float(np.abs(c.result - w).max())
                            checked["worst"] = max(checked["worst"], d)
                            if not d < 1e-3:
                                raise AssertionError(f"ppr_delta rid {c.rid} v{ver}: {d:.3g} "
                                                     "from run_batch")
                            checked["residual"] += 1
                        else:
                            if not result_bits_equal(c.result, w):
                                raise AssertionError(f"{algo} rid {c.rid} (source {c.source}) "
                                                     f"v{ver} differs from run_batch")
                            checked["exact"] += 1
            del gv, pv, dv
        torch.cuda.empty_cache()

    # apply_updates split by wrappers on the server, its graph and pools;
    # residual_correct (inside the refresh and the resume) on its own
    upd = collections.Counter()
    time_methods([(srv, "_harvest_pool", "harvest"), (srv.sg, "apply", "graph apply"),
                  (srv, "_refresh_cached", "cache refresh")]
                 + [(p, m, lbl) for p in srv.pools.values()
                    for m, lbl in (("set_graph", "set_graph"),
                                   ("resume_residual", "in-flight resume"),
                                   ("readmit", "in-flight restart"))], upd)
    # inside the refresh and the resume, each on its own
    rc_spent = collections.Counter()
    inner = [(INC, "residual_correct"), (STREAM, "incremental_batch"),
             (SCHED, "_lane_rows")]
    originals = [(obj, name, getattr(obj, name)) for obj, name in inner]
    for obj, name in inner:
        time_methods([(obj, name, name)], rc_spent)
    rng = np.random.default_rng(0)
    hot = rng.choice(nz, size=max(1, STREAM_REQUESTS // 8))
    t_verify, t_updates, pressed, log_upd = 0.0, 0.0, 0, []
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STREAM_REQUESTS):
        algo = STREAM_ALGOS[i % len(STREAM_ALGOS)]
        src = int(rng.choice(hot)) if rng.random() < 0.25 else int(rng.choice(nz))
        while srv.submit(algo, src) is None:
            pressed += 1
            srv.pump()
        srv.pump()
        if (i + 1) % STREAM_UPDATE_EVERY == 0:
            ins, dels = stream_graph.random_update_batch(rng, srv.sg, STREAM_INSERTS,
                                                         STREAM_DELETES)
            upd.clear()
            rc_spent.clear()
            st, t_u = timed(lambda: srv.apply_updates(ins, dels, refresh="incremental"))
            t_updates += t_u
            snapshots[st["version"]] = (srv.sg.graph, srv.sg.pack, srv.sg.delta)
            split = dict(upd, rest=t_u - sum(upd.values()))
            split.update({f"in them: {k}": v for k, v in rc_spent.items()})
            log_upd.append((st, t_u, split))
            counted.update(ops.launch_counts())            # bank the stream's launches
            (_, t_v) = timed(lambda: verify([v for v in snapshots if v < st["version"]]))
            t_verify += t_v
            ops.reset_launches()
    comps = srv.drain()
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0 - t_verify
    counted.update(ops.launch_counts())
    for obj, name, fn in originals:
        setattr(obj, name, fn)
    peak = torch.cuda.max_memory_allocated()
    _, t_v = timed(lambda: verify(list(snapshots)))
    t_verify += t_v
    if len(comps) != STREAM_REQUESTS or any(c.result is None for c in comps):
        raise AssertionError(f"{len(comps)} completions of {STREAM_REQUESTS} requests")
    if checked["exact"] + checked["residual"] != len(comps):
        raise AssertionError(f"{checked} checks for {len(comps)} completions")
    stats = srv.stats()
    for st, t_u, split in log_upd:
        log(f"[10 streaming] (c) update v{st['version']}: +{st['inserted']}/-{st['deleted']}, "
            f"rebuild={st['rebuild']}; cache retained {st['cache_retained']} refreshed "
            f"{st['cache_refreshed']} dropped {st['cache_dropped']}; in flight re-enqueued "
            f"{st['reenqueued_inflight']} resumed {st['resumed_inflight']}; apply_updates "
            f"{t_u:.3f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + ")")
    hits = sum(c.from_cache for c in comps)
    log(f"[10 streaming] (c) {len(comps)} requests in {t_stream:.3f} s (verification "
        f"excluded; {t_updates:.3f} s of it in {len(log_upd)} apply_updates): "
        f"{len(comps) / t_stream:.1f} queries/s, {hits} cache hits, {pressed} backpressure "
        f"events; every completion checked against run_batch on its version's views: "
        f"{checked['exact']} bfs/sssp bit-equal, {checked['residual']} ppr_delta within "
        f"{checked['worst']:.3g} (limit 1e-3) ({t_verify:.1f} s of checks); peak device "
        f"memory {peak / 2**30:.2f} GiB; stats graph.streaming {stats['graph']['streaming']}")
    for name in STREAM_ALGOS:
        p = stats["pools"][name]
        log(f"[10 streaming] (c)   pool {name}: {p['engine_queries']} engine queries, "
            f"{p['steps']} batched steps x {p['slots']} slots")
    del srv, comps, snapshots
    torch.cuda.empty_cache()

    # -- (d) the CLI --------------------------------------------------------------------
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = stream_graph.main(["--graph", "rmat", "--scale", "16", "--verify"])
    for line in out.getvalue().splitlines():
        log(f"[10 streaming] (d) {line}")
    if rc != 0 or "verify: 24/24 OK" not in out.getvalue():
        raise AssertionError(f"stream_graph returned {rc}")
    log(f"[10 streaming] (d) stream_graph --verify at RMAT-16 on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    kernels = {k: counted[k] for k in ("ell_combine", "ell_combine_batched",
                                       "segment_reduce", "frontier_pack")}
    if not all(kernels.values()):
        raise AssertionError(f"a kernel of the streaming path was not launched: {kernels}")
    log(f"[10 streaming] launches in (a)-(c): {kernels}")
    return kernels


# ---------------------------------------------------------------------------
# phase 11: SLO replay and sharded serving
# ---------------------------------------------------------------------------

SHARD_D = 4                    # query shards of the replicated placement
SHARD_S = 4                    # edge shards of the edge-sharded placement
SHARD_Q = 32                   # replicated lanes: Q/D = 8 a query shard
SHARD_Q_EDGE = 8               # edge-sharded lanes (each shard's scan is (E_s, Q))
SHARD_REQUESTS = 64             # 128 before phase 15 (the smoke's 1,200 s)
SHARD_UPDATE_EVERY = 32
SLO_SECONDS = 10.0
SLO_UPDATE_EVERY = 2.5
SLO_DEADLINE_MS = 1500.0
#: numbers one phase hands a later one (phase 9's served queries/s sets
#: phase 11's arrival rate)
MEASURED: dict = {}


def phase_sources(g) -> list:
    """Phase 8's 64 sources: vertex 0, 62 distinct vertices of nonzero
    degree drawn with numpy seed 17, and the 7th again."""
    deg = g.out.degrees().cpu().numpy()
    rng = np.random.default_rng(17)
    draw = rng.choice(np.flatnonzero(deg[1:] > 0) + 1, 62, replace=False)
    return [0] + [int(x) for x in draw] + [int(draw[5])]


def hold_sharded_kernels(dev, A, S, ell, sr, fp, g, pack, cfg, report) -> None:
    """The sharded path's kernels at its shapes on the RMAT-22 graph, held
    against their plain versions (not counted): `segment_reduce` at
    D = SHARD_Q_EDGE on edge shard 0's scan of a (1, SHARD_S) mesh (its
    destinations as the shard holds them, sorted), by `check_segment`;
    `frontier_pack` of the shard's union-frontier edge mask at the compacted
    scan's cap, bit-equal; `ell_combine_batched` at Q = SHARD_Q / SHARD_D on
    the four slices (a replicated query shard's pull) for hop/min, add_w/min
    and copy/sum, bit-equal. Each timed beside its byte bound, its plain
    version and its library call; into `report`."""
    from repro_torch.serving import sharded as SH

    n, q = g.n_nodes, SHARD_Q_EDGE
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    mesh = S.make_serving_mesh(1, SHARD_S, devices=[dev] * SHARD_S)
    eng = S.ShardedBatchEngine(A.bfs(0), g, pack, cfg, mesh, placement="edge_sharded")
    v = eng.shard_views(0)[0]
    e = v.src.shape[0]
    vals = torch.rand(e, q, device=dev, generator=gen)
    t0 = time.perf_counter()
    s_err = check_segment(sr, vals, v.dst, n + 1, f"on edge shard 0's scan E={e} D={q}")
    ids64 = v.dst.long()
    lib_out = torch.zeros(n + 1, q, device=dev)
    bnd = bound_ms(e * 4 + e * q * 4 + (n + 1) * q * 4, e * q)
    seg = dict(E=e, D=q, num=n + 1,
               ms=cuda_ms(lambda: sr.segment_reduce_cuda(vals, v.dst, n + 1, "sum"), 10),
               min_ms=cuda_ms(lambda: sr.segment_reduce_cuda(vals, v.dst, n + 1, "min"), 10),
               plain_ms=cuda_ms(lambda: sr.segment_reduce_plain(vals, v.dst, n + 1, "sum"), 2, 1),
               bound_ms=bnd[0], bound_by=bnd[1],
               library_ms=cuda_ms(lambda: lib_out.index_add_(0, ids64, vals), 5),
               library_min_ms=cuda_ms(lambda: lib_out.scatter_reduce_(
                   0, ids64[:, None].expand(e, q), vals, "amin"), 3))
    report["segment_reduce"]["edge_shard_scan"] = seg
    report["segment_reduce"]["max_abs_err"] = max(report["segment_reduce"]["max_abs_err"], s_err)
    log(f"[11 sharded] (k) segment_reduce on edge shard 0's scan E={e} D={q} num={n + 1}: sum "
        f"{seg['ms']:.4f} ms, min {seg['min_ms']:.4f}, bound {seg['bound_ms']:.4f} by "
        f"{seg['bound_by']}, plain {seg['plain_ms']:.4f}, index_add_ {seg['library_ms']:.4f}, "
        f"scatter_reduce_ amin {seg['library_min_ms']:.4f}; sum, min, max bit-equal to "
        f"segment_reduce_ordered")
    del vals, ids64, lib_out
    cap = SH._compact_cap(e, cfg)
    union = torch.rand(n + 1, device=dev, generator=gen) < 0.2
    eact = union[v.src.long()] & v.valid
    pk = lambda: fp.frontier_pack_cuda(eact, cap)
    pp = lambda: fp.frontier_pack_plain(eact, cap)
    if not all(bit_equal(x, y) for x, y in zip(pk(), pp())):
        raise AssertionError(f"frontier_pack differs on the shard's edge mask E={e} cap={cap}")
    live = int(eact.sum())
    lib = lambda: torch.nonzero_static(eact, size=cap, fill_value=e)
    if not torch.equal(pk()[0].long(), lib()[:, 0]):
        raise AssertionError("frontier_pack and torch.nonzero_static disagree on the shard")
    bnd = bound_ms(e + cap * 4 + 5, e * 2)
    sel = dict(E=e, cap=cap, live=live, ms=cuda_ms(pk, 20), plain_ms=cuda_ms(pp, 3, 1),
               bound_ms=bnd[0], bound_by=bnd[1], library_ms=cuda_ms(lib, 20))
    report["frontier_pack"]["edge_shard_select"] = sel
    log(f"[11 sharded] (k) frontier_pack of edge shard 0's union-frontier mask E={e} "
        f"({live} set) at cap {cap}: {sel['ms']:.4f} ms, bound {sel['bound_ms']:.4f}, plain "
        f"{sel['plain_ms']:.4f}, torch.nonzero_static {sel['library_ms']:.4f}; bit-equal")
    del union, eact, eng, v
    qd = SHARD_Q // SHARD_D
    vals = torch.rand(n + 1, qd, device=dev, generator=gen) * 64
    times = collections.Counter()
    for s in pack.slices:
        for op, comb in (("hop", "min"), ("add_w", "min"), ("copy", "sum")):
            a = ell.ell_combine_batched_cuda(s.nbr, s.wgt, vals, op, comb)
            if not bit_equal(a, ell.ell_combine_batched_plain(s.nbr, s.wgt, vals, op, comb)):
                raise AssertionError(f"ell_combine_batched {op}/{comb} Q={qd} differs on the "
                                     f"{tuple(s.nbr.shape)} slice")
            times[f"{op}/{comb}"] += cuda_ms(
                lambda s=s, op=op, comb=comb: ell.ell_combine_batched_cuda(s.nbr, s.wgt, vals,
                                                                           op, comb), 10)
    q8 = report["ell_combine_batched"]["q8"]
    rep = dict(Q=qd, ms=times["copy/sum"], times=dict(times), bound_ms=q8["bound_ms"],
               plain_ms=q8["plain_ms"], library_ms=q8["library_ms"],
               route=ell.batched_layout(qd, pack.slices[0].width, vals.data_ptr(), 0).route)
    report["ell_combine_batched"]["replicated_shard"] = rep
    log(f"[11 sharded] (k) ell_combine_batched Q={qd} (a replicated query shard's pull) on "
        f"{len(pack.slices)} slices, route {rep['route']}: "
        + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items())
        + f"; bound {rep['bound_ms']:.4f}, plain {rep['plain_ms']:.4f}, torch.sparse.mm "
        f"{rep['library_ms']:.4f} (phase 8's Q = 8 at these shapes); hop/min, add_w/min, "
        f"copy/sum bit-equal ({time.perf_counter() - t0:.1f} s)")
    del vals


def reset_peak() -> None:
    """Free what earlier work left on the card, reference cycles included,
    and restart the peak count, so that a peak is this part's own."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


class ResidualCheck:
    """Holds a server's ppr_delta completions against `run_batch`. A lane
    in flight across an update (resumed by `resume_residual`), a cache
    entry that an update refreshed, the completions served from either,
    and a preempted lane carry a resumed fixpoint: within 1e-3. Every other
    completion within rtol 1e-5, atol 1e-7, as (a) holds the engine."""

    def __init__(self, srv, algo: str = "ppr_delta"):
        self.srv, self.algo = srv, algo
        self.rids, self.keys = set(), set()
        self.n = {"fresh": 0, "resumed": 0}
        self.worst = {"fresh": 0.0, "resumed": 0.0}

    def apply(self, fn):
        """Run one `apply_updates` (`fn`, returning (stats, seconds)) and
        mark the lanes and cache entries it resumes."""
        if self.algo in self.srv.pools:
            self.rids |= {r for r in self.srv.pools[self.algo].lane_rid if r is not None}
        st, t = fn()
        self.keys |= {(k[0], k[2]) for k in self.srv.cache._entries
                      if k[0] == st["version"] and k[1] == self.algo}
        return st, t

    def hold(self, c, want: np.ndarray, label: str) -> None:
        """Completions in the order they were served, so that a cache hit
        on a resumed lane's entry is marked before it is held."""
        key = (c.graph_version, c.source)
        kind = ("resumed" if c.rid in self.rids or c.preempted
                or (c.from_cache and key in self.keys) else "fresh")
        d = float(np.abs(c.result - want).max())
        self.n[kind] += 1
        self.worst[kind] = max(self.worst[kind], d)
        if kind == "resumed":
            self.keys.add(key)
            if not d < 1e-3:
                raise AssertionError(f"{label}: a resumed lane {d:.3g} from run_batch")
        else:
            np.testing.assert_allclose(c.result, want, rtol=1e-5, atol=1e-7, err_msg=label)

    def summary(self) -> str:
        return (f"ppr_delta {self.n['fresh']} within {self.worst['fresh']:.3g} (rtol 1e-5, "
                f"atol 1e-7) and {self.n['resumed']} resumed across an update within "
                f"{self.worst['resumed']:.3g} (limit 1e-3)")


def lanes_equal(name, a, b, exact) -> float:
    """bit-equal (exact) or within rtol 1e-5, atol 1e-7; the worst gap."""
    if exact:
        if not bit_equal(a, b):
            raise AssertionError(f"{name}: lanes differ")
        return 0.0
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    return abs_err(a, b)


def engine_runs(dev, A, S, ops, g, pack, cfg, sources) -> collections.Counter:
    """(a): `ShardedBatchEngine` through `run_sharded` against `run_batch`:
    replicated on a (SHARD_D, 1) mesh at Q = SHARD_Q for bfs, sssp and ppr
    (lanes and mode trace bit-equal); edge-sharded on a (1, SHARD_S) mesh at
    Q = SHARD_Q_EDGE, bfs and sssp bit-equal with the compacted scan on and
    off, ppr and ppr_delta within rtol 1e-5, atol 1e-7, its per-shard scan
    volumes from the telemetry plane of a run with telemetry on; a (1, 1)
    mesh bit-equal for all four. Warm queries/s of runs with telemetry off
    beside run_batch, peak memory. Only the sharded runs' launches count
    (run_batch, the oracle, runs uncounted), per placement; the replicated
    runs must have launched ell_combine_batched, the edge-sharded ones
    segment_reduce and frontier_pack. Returns the counted launches."""
    from repro_torch.obs import shard_plane, tele_dict

    paths = {"replicated": collections.Counter(), "edge_sharded": collections.Counter()}
    field = {"bfs": "dist", "sssp": "dist", "ppr": "rank", "ppr_delta": "rank"}
    make = {k: getattr(A, k) for k in field}
    rep_mesh = S.make_serving_mesh(SHARD_D, 1, devices=[dev] * SHARD_D)
    edge_mesh = S.make_serving_mesh(1, SHARD_S, devices=[dev] * SHARD_S)
    one = S.make_serving_mesh(1, 1, devices=[dev])

    def run(fn, path=None):
        """(fn(), host seconds); the launches of a sharded run on `path`
        are counted, the oracle's (path None) are not."""
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        if path is not None:
            paths[path].update(ops.launch_counts())
        return out, t

    reset_peak()
    resident = torch.cuda.memory_allocated()
    for name in ("bfs", "sssp", "ppr"):
        for half in (sources[:SHARD_Q], sources[SHARD_Q:2 * SHARD_Q]):
            (mb, sb), tb = run(lambda: S.run_batch(make[name](0), g, pack, cfg, half))
            (ms_, ss), ts = run(lambda: S.run_sharded(make[name](0), g, pack, cfg, rep_mesh,
                                                      half), "replicated")
            for k in mb:
                lanes_equal(f"replicated {name} {k}", ms_[k], mb[k], True)
            if not torch.equal(ss["mode_trace"], sb["mode_trace"]):
                raise AssertionError(f"replicated {name}: the mode trace differs")
        log(f"[11 sharded] (a) replicated ({SHARD_D}, 1) {name} Q={SHARD_Q} x 2: lanes and mode "
            f"trace bit-equal to run_batch; warm {SHARD_Q / ts:.1f} queries/s against "
            f"run_batch's {SHARD_Q / tb:.1f}, {int(ss['iterations'])} steps")
    peak_rep = torch.cuda.max_memory_allocated()
    q = SHARD_Q_EDGE
    srcs = sources[:q]
    reset_peak()
    for name in ("bfs", "sssp", "ppr", "ppr_delta"):
        exact = make[name](0).combiner.name != "sum"
        (mb, sb), tb = run(lambda: S.run_batch(make[name](0), g, pack, cfg, srcs))
        eng = S.ShardedBatchEngine(make[name](0), g, pack, cfg, edge_mesh,
                                   placement="edge_sharded", telemetry=True)
        (me, se), _tt = run(lambda: eng.run(eng.init(srcs)), "edge_sharded")
        (mo, _so), te = run(lambda: S.run_sharded(make[name](0), g, pack, cfg, edge_mesh, srcs,
                                                  placement="edge_sharded"), "edge_sharded")
        for k in mo:
            lanes_equal(f"edge-sharded {name} telemetry on/off {k}", mo[k], me[k], True)
        gap = lanes_equal(f"edge-sharded {name}", me[field[name]], mb[field[name]], exact)
        plane = [int(x) for x in shard_plane(se["tele"].cpu().numpy())]
        named = tele_dict(se["tele"].cpu().numpy())
        line = (f"[11 sharded] (a) edge-sharded (1, {SHARD_S}) {name} Q={q}: "
                + ("bit-equal to run_batch" if exact else f"within {gap:.3g} of run_batch")
                + f"; warm {q / te:.2f} queries/s (telemetry off) against run_batch's "
                f"{q / tb:.2f}, "
                f"{int(se['iterations'])} steps; per-shard scan volumes {plane} (skew "
                f"{max(plane) / max(sum(plane) / len(plane), 1):.3f}), compact hits "
                f"{named['compact_hits']}, dense fallbacks {named['compact_dense_fallbacks']}")
        if name in ("bfs", "sssp"):
            dense = dataclasses.replace(cfg, shard_compact=False)
            (md, _sd), td = run(lambda: S.run_sharded(make[name](0), g, pack, dense, edge_mesh,
                                                      srcs, placement="edge_sharded"),
                                "edge_sharded")
            for k in me:
                lanes_equal(f"edge-sharded {name} compact/dense {k}", me[k], md[k], True)
            line += f"; the dense scan bit-equal, {q / td:.2f} queries/s"
        log(line)
        (m1, s1), _t1 = run(lambda: S.run_sharded(make[name](0), g, pack, cfg, one, srcs),
                            "replicated")
        for k in mb:
            lanes_equal(f"(1, 1) {name} {k}", m1[k], mb[k], True)
        if not torch.equal(s1["mode_trace"], sb["mode_trace"]):
            raise AssertionError(f"(1, 1) {name}: the mode trace differs")
        del eng, me, mo, mb, m1
    peak_edge = torch.cuda.max_memory_allocated()
    need = {"replicated": ("ell_combine_batched",),
            "edge_sharded": ("segment_reduce", "frontier_pack")}
    for path, names in need.items():
        if not all(paths[path][k] for k in names):
            raise AssertionError(f"(a) the {path} runs did not launch {names}: "
                                 f"{dict(paths[path])}")
    log(f"[11 sharded] (a) (1, 1) mesh bit-equal to run_batch for bfs, sssp, ppr, ppr_delta "
        f"(lanes and mode trace); peak device memory replicated {peak_rep / 2**30:.2f} GiB, "
        f"edge-sharded {peak_edge / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB of the graph "
        f"and earlier phases resident before); sharded runs' launches "
        + "; ".join(f"{p} {dict(+c)}" for p, c in paths.items()))
    torch.cuda.empty_cache()
    return paths["replicated"] + paths["edge_sharded"]


def placed_servers(dev, A, S, ops, g, nz) -> collections.Counter:
    """(b): two `GraphServer`s with placed pools and streaming updates, each
    serving SHARD_REQUESTS requests drawn as `stream_graph` draws them (hot
    0.25, seed 0, nonzero degree) with phase 10's update batch every
    SHARD_UPDATE_EVERY: bfs, sssp, ppr replicated on a (SHARD_D, 1) mesh at
    SHARD_Q slots, and bfs, sssp, ppr_delta edge-sharded on a (1, SHARD_S)
    mesh at SHARD_Q_EDGE slots. Every completion held against `run_batch`
    on its version's views: bit-equal, ppr_delta by `ResidualCheck`. The
    replicated server must have launched ell_combine_batched, the
    edge-sharded one segment_reduce and frontier_pack. Returns the counted
    launches."""
    from repro_torch.launch import stream_graph

    counted = collections.Counter()
    need = {"replicated": ("ell_combine_batched",),
            "edge_sharded": ("segment_reduce", "frontier_pack")}
    cfg = S.default_config(g)
    setups = [("replicated", (SHARD_D, 1), ("bfs", "sssp", "ppr"), SHARD_Q),
              ("edge_sharded", (1, SHARD_S), ("bfs", "sssp", "ppr_delta"), SHARD_Q_EDGE)]
    for kind, shape, algos, slots in setups:
        mesh = S.make_serving_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        n_shards = shape[0] if kind == "replicated" else shape[1]
        progs = {a: getattr(A, a)(0) for a in algos}
        reset_peak()
        srv = S.GraphServer(g, None, progs, slots=slots, cfg=cfg, queue_cap=SERVE_QUEUE_CAP,
                            cache_capacity=SERVE_CACHE, delta_cap=STREAM_CAP, mesh=mesh,
                            placements={a: (kind, n_shards) for a in algos})
        snapshots = {0: (srv.sg.graph, srv.sg.pack, srv.sg.delta)}
        checked = {"exact": 0}
        resid = ResidualCheck(srv)
        mine = collections.Counter()

        def verify(versions):
            """Hold the completions of `versions` against `run_batch` on
            that version's views (bit-equal; ppr_delta by `resid`), then
            drop the views."""
            for ver in versions:
                gv, pv, dv = snapshots.pop(ver)
                for algo, prog in progs.items():
                    group = [c for c in srv.completions
                             if c.graph_version == ver and c.algo == algo]
                    for lo in range(0, len(group), STREAM_Q):
                        part = group[lo:lo + STREAM_Q]
                        ref, _ = S.run_batch(prog, gv, pv, cfg, [c.source for c in part],
                                             delta=dv)
                        want = ref[srv.pools[algo].result_field][:-1].T.cpu().numpy()
                        for c, w in zip(part, want):
                            if algo == "ppr_delta":
                                resid.hold(c, w, f"{kind} ppr_delta rid {c.rid} v{ver}")
                            elif not result_bits_equal(c.result, w):
                                raise AssertionError(f"{kind} {algo} rid {c.rid} v{ver} "
                                                     "differs from run_batch")
                            else:
                                checked["exact"] += 1
                del gv, pv, dv
                torch.cuda.empty_cache()

        rng = np.random.default_rng(0)
        hot = rng.choice(nz, size=max(1, SHARD_REQUESTS // 8))
        upd, t_verify = [], 0.0
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(SHARD_REQUESTS):
            algo = algos[i % len(algos)]
            src = int(rng.choice(hot)) if rng.random() < 0.25 else int(rng.choice(nz))
            while srv.submit(algo, src) is None:
                srv.pump()
            srv.pump()
            if (i + 1) % SHARD_UPDATE_EVERY == 0:
                ins, dels = stream_graph.random_update_batch(rng, srv.sg, STREAM_INSERTS,
                                                             STREAM_DELETES)
                st, t_u = resid.apply(lambda: timed(lambda: srv.apply_updates(ins, dels)))
                snapshots[st["version"]] = (srv.sg.graph, srv.sg.pack, srv.sg.delta)
                upd.append((st, t_u))
                mine.update(ops.launch_counts())          # bank the stream's launches
                _, t_v = timed(lambda: verify([v for v in snapshots if v < st["version"]]))
                t_verify += t_v
                ops.reset_launches()
        comps = srv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - t_verify
        mine.update(ops.launch_counts())
        if not all(mine[k] for k in need[kind]):
            raise AssertionError(f"(b) the {kind} server did not launch {need[kind]}: "
                                 f"{dict(+mine)}")
        counted.update(mine)
        peak = torch.cuda.max_memory_allocated()
        if len(comps) != SHARD_REQUESTS or any(c.result is None for c in comps):
            raise AssertionError(f"{kind}: {len(comps)} completions of {SHARD_REQUESTS}")
        verify(list(snapshots))
        if checked["exact"] + sum(resid.n.values()) != len(comps):
            raise AssertionError(f"{kind}: {checked} checks for {len(comps)} completions")
        t_upd = sum(t for _s, t in upd)
        log(f"[11 sharded] (b) {kind} {shape} pools of {slots} slots ({', '.join(algos)}): "
            f"{len(comps)} requests in {wall:.3f} s, checks excluded ({len(comps) / wall:.2f} "
            f"queries/s, {t_upd:.3f} s of it in {len(upd)} apply_updates); "
            f"{checked['exact']} completions bit-equal to run_batch on their version's views"
            + (f", {resid.summary()}" if sum(resid.n.values()) else "")
            + f"; peak device memory {peak / 2**30:.2f} GiB; launches {dict(+mine)}")
        for st, t_u in upd:
            log(f"[11 sharded] (b)   update v{st['version']}: apply_updates {t_u:.3f} s, "
                f"cache refreshed {st['cache_refreshed']}, resumed {st['resumed_inflight']}, "
                f"re-enqueued {st['reenqueued_inflight']}, shipped {st['shipped']}")
        stats = srv.stats()
        log(f"[11 sharded] (b)   shard_delta {stats['shard_delta']}; steps "
            + ", ".join(f"{a} {stats['pools'][a]['steps']}" for a in algos))
        del srv, comps, snapshots
        torch.cuda.empty_cache()
    return counted


def slo_replays(dev, A, S, ops, g, rate: float) -> collections.Counter:
    """(c): open-loop SLO replay at RMAT-22 through `repro_torch.slo`: an
    mmpp workload of SLO_SECONDS (burst factor 6) at `rate` queries/s, two
    tenants ("paid" 0.3, bfs and sssp, deadline SLO_DEADLINE_MS; "batch"
    0.7, ppr_delta, best effort, hot fraction 0.25), an update batch every
    SLO_UPDATE_EVERY s, against a single-device server with the full policy
    after `warmup`, then a (SHARD_D, 1) replicated mesh with the drop half
    only. Zero crashed lanes; completed + shed + dropped == offered; goodput
    > 0; the last 8 engine-served completions of each algorithm held
    against `run_batch` on their version's views. Returns the counted
    launches."""
    from repro_torch import slo as SLO
    from repro_torch.streaming.incremental import is_residual

    counted = collections.Counter()
    cfg = S.default_config(g)
    algos = ("bfs", "sssp", "ppr_delta")
    w = SLO.Workload(
        arrival="mmpp", rate_qps=rate, duration_s=SLO_SECONDS, burst_factor=6.0, seed=0,
        update_every_s=SLO_UPDATE_EVERY, update_batch=STREAM_INSERTS,
        tenants=(SLO.TenantClass("paid", 0.3, (("bfs", 1.0), ("sssp", 1.0)),
                                 deadline_ms=SLO_DEADLINE_MS),
                 SLO.TenantClass("batch", 0.7, (("ppr_delta", 1.0),), hot_frac=0.25)))
    arrivals = SLO.generate(w, g.n_nodes)
    log(f"[11 sharded] (c) workload {SLO.describe(w)}: "
        f"{sum(a.kind == 'query' for a in arrivals)} queries, "
        f"{sum(a.kind == 'update' for a in arrivals)} update batches")
    for label, mesh in (("one device", None),
                        (f"({SHARD_D}, 1) replicated mesh",
                         S.make_serving_mesh(SHARD_D, 1, devices=[dev] * SHARD_D))):
        progs = {a: getattr(A, a)(0) for a in algos}
        slots = SERVE_SLOTS
        policy = S.SLOPolicy(
            degrade_algos=() if mesh is not None else tuple(
                a for a, p in progs.items() if is_residual(p) and p.with_tol is not None),
            degrade_queue_depth=max(2, slots // 2), degrade_slots=max(2, slots // 4),
            preempt=mesh is None, preempt_slack_s=SLO_DEADLINE_MS / 1e3 / 4,
            preempt_min_resident_s=SLO_DEADLINE_MS / 1e3 / 4)
        reset_peak()
        srv = S.GraphServer(g, None, progs, slots=slots, cfg=cfg, queue_cap=SERVE_QUEUE_CAP,
                            cache_capacity=SERVE_CACHE, delta_cap=STREAM_CAP,
                            tenant_weights={"paid": 2.0, "batch": 1.0}, slo=policy,
                            mesh=mesh, placements=None if mesh is None else {
                                a: ("replicated", SHARD_D) for a in algos})
        t0 = time.perf_counter()
        SLO.warmup(srv, {a: 1 for a in algos})
        t_warm = time.perf_counter() - t0
        snapshots = {srv.graph_version: (srv.sg.graph, srv.sg.pack, srv.sg.delta)}
        applied = []
        real_apply = srv.apply_updates

        resid = ResidualCheck(srv)

        def apply_and_keep(*a, **k):
            st, t_u = resid.apply(lambda: timed(lambda: real_apply(*a, **k)))
            snapshots[st["version"]] = (srv.sg.graph, srv.sg.pack, srv.sg.delta)
            applied.append(t_u)
            return st

        srv.apply_updates = apply_and_keep
        n0 = len(srv.completions)
        ops.reset_launches()
        rep = SLO.replay(srv, arrivals, max_wall_s=4 * SLO_SECONDS + 60)
        counted.update(ops.launch_counts())
        peak = torch.cuda.max_memory_allocated()
        if rep.crashed_lanes or rep.completed + rep.shed + rep.dropped != rep.offered:
            raise AssertionError(f"SLO replay on {label}: {rep}")
        if not rep.goodput > 0:
            raise AssertionError(f"SLO replay on {label}: goodput {rep.goodput}")
        served = [c for c in srv.completions[n0:]
                  if not (c.from_cache or c.dropped or c.degraded)]
        checked = 0
        for algo, prog in progs.items():
            last = [c for c in served if c.algo == algo][-8:]
            for c in last:
                gv, pv, dv = snapshots[c.graph_version]
                ref, _ = S.run_batch(prog, gv, pv, cfg, [c.source], delta=dv)
                want = ref[srv.pools[algo].result_field][:-1, 0].cpu().numpy()
                if algo == "ppr_delta":
                    resid.hold(c, want, f"SLO {label} ppr_delta rid {c.rid}")
                elif not result_bits_equal(c.result, want):
                    raise AssertionError(f"SLO {label} {algo} rid {c.rid} differs from run_batch")
                checked += 1
        pct = lambda p: ("-" if p is None else
                         f"p50 {p['p50_seconds'] * 1e3:.0f} / p95 {p['p95_seconds'] * 1e3:.0f} / "
                         f"p99 {p['p99_seconds'] * 1e3:.0f} ms (n={p['n']})")
        log(f"[11 sharded] (c) {label}: offered {rep.offered}, completed {rep.completed}, "
            f"good {rep.good}, goodput {rep.goodput:.3f}; shed {rep.shed}, dropped "
            f"{rep.dropped}, degraded {rep.degraded}, preempted {rep.preempted}, deadline "
            f"missed {rep.deadline_missed}, cache hits {rep.cache_hits}; wall {rep.wall_s:.2f} s "
            f"for {SLO_SECONDS:.0f} s of arrivals, {len(applied)} updates "
            f"({sum(applied):.2f} s in apply_updates), crashed lanes {rep.crashed_lanes}; "
            f"warmup {t_warm:.1f} s; {checked} late completions held against run_batch"
            f" ({resid.summary()}); peak {peak / 2**30:.2f} GiB")
        for k, p in list(rep.per_tenant.items()) + list(rep.per_algo.items()):
            log(f"[11 sharded] (c)   {label} {k}: {pct(p)}")
        log(f"[11 sharded] (c)   {label} total: {pct(rep.total)}")
        del srv, snapshots
        torch.cuda.empty_cache()
    return counted


def launcher_runs(dev, root: Path) -> None:
    """(d): the launchers on the card at the reference's defaults:
    `slo_replay --assert-goodput --trace` on one device and with `--mesh
    4x1 --device cuda:0`, `obs_report` on the trace and
    `scripts/trace_schema.py` accepting it; `serve_graph --mesh 1x4
    --placement edge_sharded --verify` and `stream_graph --mesh 4x1
    --verify` at RMAT-16."""
    import contextlib
    import io

    from repro_torch.launch import obs_report, serve_graph, slo_replay, stream_graph

    trace_dir = root / "build" / "smoke"
    trace_dir.mkdir(parents=True, exist_ok=True)

    def run(tag, fn, args, must):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = fn(args)
        for line in out.getvalue().splitlines():
            log(f"[11 sharded] (d) {line}")
        if rc != 0 or must not in out.getvalue():
            raise AssertionError(f"{tag} returned {rc}")
        log(f"[11 sharded] (d) {tag}: {time.perf_counter() - t0:.1f} s")

    for tag, extra in (("slo_replay", []), ("slo_replay --mesh 4x1",
                                            ["--mesh", "4x1", "--device", f"cuda:{dev.index or 0}"])):
        trace = trace_dir / f"slo_trace{len(extra)}.jsonl"
        run(tag, slo_replay.main, ["--assert-goodput", "--trace", str(trace)] + extra,
            "smoke gate: goodput>0 and zero crashed lanes -> PASS")
        run("obs_report", obs_report.main, ["--trace", str(trace)], "== trace:")
        r = subprocess.run([sys.executable, str(root / "scripts" / "trace_schema.py"), str(trace)],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise AssertionError(f"trace_schema refused {trace}: {r.stdout} {r.stderr}")
        log(f"[11 sharded] (d) trace_schema: {r.stdout.strip().splitlines()[-1:]}")
    run("serve_graph --mesh 1x4", serve_graph.main,
        ["--graph", "rmat", "--scale", "16", "--mesh", "1x4", "--placement", "edge_sharded",
         "--device", f"cuda:{dev.index or 0}", "--verify"], "verify: 8/8 OK")
    run("stream_graph --mesh 4x1", stream_graph.main,
        ["--graph", "rmat", "--scale", "16", "--mesh", "4x1", "--device",
         f"cuda:{dev.index or 0}", "--verify"], "verify: 24/24 OK")


def sharded_phase(dev, A, S, ops, ell, sr, fp, g, nz, report, rate: float) -> dict:
    """Phase 11: SLO replay and sharded serving on phase 4's RMAT-22 graph,
    every mesh a grid of this one card: (k) `hold_sharded_kernels`; (a)
    `engine_runs`; (b) `placed_servers`; (c) `slo_replays` at `rate`
    queries/s (phase 9's served rate); (d) `launcher_runs`. Returns the
    counted launches of (a)-(c)."""
    from repro_torch.graph import pack_ell

    pack = pack_ell(g.inc)
    cfg = S.default_config(g)
    counted = collections.Counter()
    t0 = time.perf_counter()
    hold_sharded_kernels(dev, A, S, ell, sr, fp, g, pack, cfg, report)
    t_k = time.perf_counter()
    counted.update(engine_runs(dev, A, S, ops, g, pack, cfg, phase_sources(g)))
    del pack
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    counted.update(placed_servers(dev, A, S, ops, g, nz))
    t_b = time.perf_counter()
    counted.update(slo_replays(dev, A, S, ops, g, rate))
    t_c = time.perf_counter()
    launcher_runs(dev, Path(__file__).resolve().parent)
    kernels = {k: counted[k] for k in ("ell_combine_batched", "segment_reduce", "frontier_pack")}
    if not all(kernels.values()):
        raise AssertionError(f"a kernel of the sharded path was not launched: {kernels}")
    log(f"[11 sharded] launches in (a)-(c): {kernels}; (k) {t_k - t0:.1f} s, (a) "
        f"{t_a - t_k:.1f} s, (b) {t_b - t_a:.1f} s, (c) {t_c - t_b:.1f} s, (d) "
        f"{time.perf_counter() - t_c:.1f} s")
    return kernels


# ---------------------------------------------------------------------------
# phase 12: the model stacks' serving path at the published widths
# ---------------------------------------------------------------------------

#: the reference launcher's serving defaults (src/repro/launch/serve.py:37-43)
LM_SLOTS, LM_REQUESTS, LM_PROMPT, LM_GEN, LM_MAX_LEN, LM_SEED = 4, 8, 16, 24, 64, 0
#: check 2: the batch and sequence of the forward held flash against plain
LM_FORWARD = (2, 1024)
#: bf16 logits of two forwards whose attention differs only by rounding
#: are far apart: every later bf16 product rounds a difference up to its own
#: ulp, and a MoE router turns one into another expert. Plain attention
#: against float64 attention rounded once, in PyTorch on the CPU: 0.8e-2
#: after one layer and 2.2e-2 after 40 (d_model 512, S 512); 3.5e-2 at
#: granite-moe-1b-a400m's full width (24 layers, S 512). So logits are held
#: at 0.1 (a wiring fault moves them by O(1)), and a dense model's flash
#: forward must come no further from the float64-attention forward than
#: 1.25 times the plain forward does (`attention_rounded`, which rounds
#: where the kernel does, came 0.75-0.95 times as far in the same runs; a
#: MoE's flipped routes make that ratio a draw). Each flash call of the
#: forward is held on its own inputs at BF16_REL_ERR and ROUNDED_REL_ERR
LOGITS_REL_ERR = 0.1
EXACT_RATIO = 1.25
#: the graph zoo's cells (src/repro/configs/registry.py:24-33)
GRAPH_CELLS = (("gcn-cora", "full_graph_sm"), ("gatedgcn", "full_graph_sm"),
               ("gin-tu", "molecule"), ("dimenet", "molecule"))
MODEL_KERNELS = ("flash_attention", "flash_attention_f32", "segment_reduce", "embedding_bag")
#: inputs kept a (kernel, shapes) key for the holds after the counted runs
KEEP_CALLS = 64


class Captured:
    """While `run` runs, each call of the model path's CUDA wrappers
    (`segment_reduce_cuda`, `embedding_bag_cuda`, `flash_attention_cuda`,
    and with `backward` `flash_attention_bwd_cuda`) goes through as it is
    (and counts its launch there), and the inputs of up to `keep` calls a
    (kernel, part, shapes, mode) key are kept, detached, so that every
    kernel is held against its plain version, and timed, on the inputs the
    path gave it."""

    def __init__(self, sr, bag, fa, keep: int = KEEP_CALLS, backward: bool = False):
        self.mods = {"segment_reduce": (sr, "segment_reduce_cuda"),
                     "embedding_bag": (bag, "embedding_bag_cuda"),
                     "flash_attention": (fa, "flash_attention_cuda")}
        if backward:
            self.mods["flash_attention_bwd"] = (fa, "flash_attention_bwd_cuda")
        self.keep = keep
        self.calls: dict = collections.defaultdict(list)
        self.count = collections.Counter()
        self.where = ""

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            key = (name, self.where) + tuple(
                (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else a
                for a in args)
            self.count[key] += 1
            if len(self.calls[key]) < self.keep:
                self.calls[key].append(tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                             for a in args))
            return fn(*args, **kw)
        return wrapped

    def run(self, where: str, fn):
        """fn() with the wrappers swapped in, its calls filed under `where`."""
        saved = {k: getattr(m, a) for k, (m, a) in self.mods.items()}
        self.where = where
        for k, (m, a) in self.mods.items():
            setattr(m, a, self._wrap(k, saved[k]))
        try:
            return fn()
        finally:
            for k, (m, a) in self.mods.items():
                setattr(m, a, saved[k])


def with_ops(ops, swaps: dict, fn):
    """fn() with the functions of module `ops` named in `swaps` replaced (a
    path on a plain route, for the comparisons)."""
    saved = {k: getattr(ops, k) for k in swaps}
    for k, f in swaps.items():
        setattr(ops, k, f)
    try:
        return fn()
    finally:
        for k, f in saved.items():
            setattr(ops, k, f)


def counted(ops, run, what: str) -> collections.Counter:
    """Model-path launches of run(), with the counts set to 0 just before."""
    torch.cuda.synchronize()
    ops.reset_launches()
    run()
    torch.cuda.synchronize()
    got = collections.Counter({k: v for k, v in ops.launch_counts().items()
                               if k in MODEL_KERNELS and v})
    log(f"[12 models] {what}: launches {dict(got)}")
    return got


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def lm_phase(dev, name: str, ops, fa, cap: Captured, profile: bool) -> collections.Counter:
    """(a)/(b): `name` at its published widths in bf16, weights from a seeded
    generator on the card; the reference launcher's defaults through
    `launch.serve.serve` and a (2, 1024) forward, counted; then check 1
    (the last decode step's logits against `forward` over the same tokens)
    and check 2 (the forward with the flash kernel against the same forward
    with the plain attention). `profile`: also one decode step under
    torch.profiler."""
    from repro_torch import configs
    from repro_torch.launch import serve as lm
    from repro_torch.models import transformer as tfm
    from repro_torch.nn import layers as L

    cfg = configs.get(name).make_config()
    reset_peak()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SEED), dev)
    torch.cuda.synchronize()
    weights = tensor_bytes(params)
    log(f"[12 models] {name}: {cfg.param_count() / 1e9:.3f} B parameters by param_count() "
        f"({cfg.active_param_count() / 1e9:.3f} B active), {weights / 1e9:.2f} GB of bf16 "
        f"weights materialised in {time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(0, cfg.vocab, size=(1, LM_PROMPT)).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, LM_FORWARD).astype(np.int32)).to(dev)
    lm.serve(cfg, params, prompts[:1], 1, 2, LM_MAX_LEN, dev)     # warm-up
    out = {}

    def drive():
        t = time.perf_counter()
        out["done"], out["steps"] = lm.serve(cfg, params, prompts, LM_SLOTS, LM_GEN,
                                             LM_MAX_LEN, dev)
        torch.cuda.synchronize()
        out["serve_s"] = time.perf_counter() - t
        out["logits"], _ = tfm.forward(params, tokens, cfg)

    reset_peak()
    launches = counted(ops, lambda: cap.run(name, drive), f"{name} served + forward")
    peak = torch.cuda.max_memory_allocated() / 2**30
    done, logits = out["done"], out["logits"]
    if sorted(r for r, _ in done) != list(range(LM_REQUESTS)) or \
            any(len(g) != LM_GEN or not all(0 <= t < cfg.padded_vocab for t in g)
                for _, g in done):
        raise AssertionError(f"{name}: served {[(r, len(g)) for r, g in done]}")
    if logits.shape != LM_FORWARD + (cfg.padded_vocab,) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: forward logits {tuple(logits.shape)}, or not finite")
    n_tok = sum(len(g) for _, g in done)

    # prefill and decode times of one slot (batch 1), and its cache copies
    cache = tfm.init_cache(cfg, 1, LM_MAX_LEN, device=dev)
    prompt = torch.from_numpy(prompts[0]).to(dev)
    prefill_ms = cuda_ms(lambda: tfm.decode_step(params, cache, prompt, cfg), 5, 2)
    _, cache = tfm.decode_step(params, cache, prompt, cfg)
    tok = torch.tensor([[done[0][1][0]]], dtype=torch.int32, device=dev)
    decode_ms = cuda_ms(lambda: tfm.decode_step(params, cache, tok, cfg), 10, 2)
    new = torch.zeros((1, cfg.n_kv, 1, cfg.dh), dtype=cache["k"].dtype, device=dev)
    copies_ms = cuda_ms(lambda: [
        torch.stack([L._cache_update(c[i], new, LM_PROMPT) for i in range(cfg.n_layers)])
        for c in (cache["k"], cache["v"])], 10, 2)
    forward_ms = cuda_ms(lambda: tfm.forward(params, tokens, cfg), 3, 1)
    if profile:
        profile_once(lambda: tfm.decode_step(params, cache, tok, cfg),
                     f"one {name} decode step (batch 1, {cache['len']} cached positions)")
    log(f"[12 models] {name}: {LM_REQUESTS} requests, {n_tok} tokens, {out['steps']} batch "
        f"steps in {out['serve_s']:.2f} s = {n_tok / out['serve_s']:.1f} tokens/s "
        f"({LM_SLOTS} slots, prompt {LM_PROMPT}, gen {LM_GEN}, max_len {LM_MAX_LEN}); prefill "
        f"{prefill_ms:.2f} ms, decode {decode_ms:.2f} ms a token (batch 1), of it the "
        f"cache copies {copies_ms:.3f} ms; forward B={LM_FORWARD[0]} S={LM_FORWARD[1]} "
        f"{forward_ms:.1f} ms; peak {peak:.2f} GiB")

    # check 1: the last decode step against forward over the same tokens
    # (capacity factor 8 for MoE, so that no pair drops in either)
    ccfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    rid, gen = done[0]
    cache = tfm.init_cache(ccfg, 1, LM_MAX_LEN, device=dev)
    last, cache = tfm.decode_step(params, cache, torch.from_numpy(prompts[rid]).to(dev), ccfg)
    for t in gen[:-1]:
        last, cache = tfm.decode_step(
            params, cache, torch.tensor([[t]], dtype=torch.int32, device=dev), ccfg)
    seq = np.concatenate([prompts[rid][0], gen[:-1]])[None].astype(np.int32)
    full, _ = tfm.forward(params, torch.from_numpy(seq).to(dev), ccfg)
    c1 = rel_err(last[0, -1], full[0, -1])
    log(f"[12 models] {name} check 1: the last decode step of request {rid} ({cache['len']} "
        f"positions) against forward over its tokens: relative norm {c1:.3g} (limit "
        f"{LOGITS_REL_ERR}), argmax {int(last[0, -1].argmax())} and {int(full[0, -1].argmax())}")
    if not c1 <= LOGITS_REL_ERR:
        raise AssertionError(f"{name} check 1: {c1:.3g} > {LOGITS_REL_ERR}")

    # check 2: the forward with the flash kernel against plain attention
    # (and, for the scale of bf16 noise, both against float64 attention
    # rounded once); MoE at capacity factor 8 again: a capacity drop turns
    # a last-bit difference in the router's input into another expert
    if ccfg is not cfg:
        logits, _ = tfm.forward(params, tokens, ccfg)
    plain = with_ops(ops, {"attention": fa.attention_plain},
                     lambda: tfm.forward(params, tokens, ccfg)[0])
    exact = with_ops(ops, {"attention": lambda q, k, v, causal: fa.attention_plain(
        q.double(), k.double(), v.double(), causal).to(q.dtype)},
        lambda: tfm.forward(params, tokens, ccfg)[0])
    c2, fe, pe = rel_err(logits, plain), rel_err(logits, exact), rel_err(plain, exact)
    log(f"[12 models] {name} check 2: forward B={LM_FORWARD[0]} S={LM_FORWARD[1]} with the "
        f"flash kernel against plain attention: relative norm {c2:.3g} (limit "
        f"{LOGITS_REL_ERR}); against float64 attention rounded once: flash {fe:.3g}, plain "
        f"{pe:.3g}{'' if cfg.moe else f' (limit {EXACT_RATIO} x plain)'}")
    if not (c2 <= LOGITS_REL_ERR and (cfg.moe or fe <= EXACT_RATIO * pe)):
        raise AssertionError(f"{name} check 2: {c2:.3g} from plain, {fe:.3g} from float64 "
                             f"attention against plain's {pe:.3g}")
    MEASURED[name] = dict(tokens_per_s=n_tok / out["serve_s"], prefill_ms=prefill_ms,
                          decode_ms=decode_ms, cache_copy_ms=copies_ms, forward_ms=forward_ms,
                          peak_gib=peak, check1_rel=c1, check2_rel=c2, flash_exact_rel=fe,
                          plain_exact_rel=pe, weights_gb=weights / 1e9)
    return launches


def deepfm_phase(dev, ops, bag, cap: Captured) -> collections.Counter:
    """(c): DeepFM at its published config: forward at serve_p99 and
    serve_bulk, user_vector + score_candidates at retrieval_cand, counted;
    then each against the plain route (rtol 1e-5, atol 1e-6)."""
    from repro_torch import configs
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.models import deepfm

    cfg = configs.get("deepfm").make_config()
    gen = torch.Generator(device=dev).manual_seed(12)
    params = deepfm.init_params(cfg, gen, dev)
    batches = [RECSYS_SHAPES[s]["batch"] for s in ("serve_p99", "serve_bulk")]
    ids = torch.randint(0, cfg.vocab_per_field, (max(batches), cfg.n_fields), device=dev,
                        generator=gen, dtype=torch.int32)
    cand = torch.randn(RECSYS_SHAPES["retrieval_cand"]["n_candidates"], cfg.embed_dim,
                       device=dev, generator=gen)
    query = ids[:RECSYS_SHAPES["retrieval_cand"]["batch"]]
    retrieve = lambda: deepfm.score_candidates(deepfm.user_vector(params, query, cfg), cand)
    plain = {"embedding_bag": bag.embedding_bag_plain}
    out = {}

    def drive():
        for b in batches:
            out[b] = deepfm.forward(params, ids[:b], cfg)
        out["scores"] = retrieve()

    launches = counted(ops, lambda: cap.run("deepfm", drive), "deepfm")
    for b in batches:
        want = with_ops(ops, plain, lambda: deepfm.forward(params, ids[:b], cfg))
        torch.testing.assert_close(out[b], want, rtol=1e-5, atol=1e-6)
        ms = cuda_ms(lambda: deepfm.forward(params, ids[:b], cfg), 10, 2)
        MEASURED[f"deepfm_forward_{b}_ms"] = ms
        log(f"[12 models] deepfm forward B={b}: {ms:.4f} ms; within rtol 1e-5, atol 1e-6 of "
            f"the plain route (max abs diff {abs_err(out[b], want):.3g}); logits "
            f"{tuple(out[b].shape)}")
    torch.testing.assert_close(out["scores"], with_ops(ops, plain, retrieve),
                               rtol=1e-5, atol=1e-6)
    ms = MEASURED["deepfm_retrieval_ms"] = cuda_ms(retrieve, 10, 2)
    log(f"[12 models] deepfm retrieval: user_vector + score_candidates against "
        f"{cand.shape[0]} candidates {ms:.4f} ms, within rtol 1e-5 of the plain route; scores "
        f"{tuple(out['scores'].shape)}")
    return launches


def graph_inputs(dev, arch: str, shape: dict, seed: int):
    """(forward, params, args, edges, triplets) of `arch` at a GNN cell,
    its config at the cell's feature width as the reference's dry-run sets
    it (`repro/launch/steps.py:351`), on a graph from `graph/generators.py`:
    a uniform random graph of the cell's nodes and edges (undirected) for
    full_graph_sm, `batched_molecules` for molecule."""
    from repro_torch import configs
    from repro_torch.graph import generators as G
    from repro_torch.models import dimenet, gnn

    spec = configs.get(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if shape["kind"] == "batched":
        n_graphs = shape["batch"]
        g = G.batched_molecules(n_graphs, shape["n_nodes"], shape["n_edges"], seed=seed,
                                device=dev)
    else:
        n_graphs = 1
        g = G.uniform_random(shape["n_nodes"], shape["n_edges"] // 2, seed=seed, device=dev)
    n = g.n_nodes
    src, dst, w = g.out.src_idx, g.out.col_idx, g.out.weights
    gids = torch.arange(n, device=dev, dtype=torch.int32) // (n // n_graphs)
    if spec.family == "dimenet":
        cfg = spec.make_config()
        tkj, tji = (torch.from_numpy(a).to(dev) for a in dimenet.build_triplets(
            src.cpu().numpy(), dst.cpu().numpy(), n, cfg.t_per_edge))
        types = torch.randint(0, cfg.d_in, (n,), device=dev, generator=gen)
        args = (torch.eye(cfg.d_in, device=dev)[types],
                torch.randn(n, 3, device=dev, generator=gen), src, dst, tkj, tji, cfg, gids,
                n_graphs)
        return dimenet.forward, dimenet.init_params(cfg, gen, dev), args, g.n_edges, \
            int(tkj.shape[0])
    cfg = dataclasses.replace(spec.make_config(), d_in=shape["d_feat"])
    feats = torch.randn(n, cfg.d_in, device=dev, generator=gen)
    return gnn.forward, gnn.init_params(cfg, gen, dev), \
        (feats, src, dst, w, cfg, gids, n_graphs), g.n_edges, 0


def double(x):
    """Floating tensors of a nest of dicts, lists and tuples in float64."""
    if isinstance(x, dict):
        return {k: double(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(double(v) for v in x)
    return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x


#: a graph forward's float32 output on the kernels, in relative norm from
#: the same forward in float64: within GRAPH_F64_RATIO times the plain
#: route's float32 distance (sums in another order, amplified through the
#: layers: DimeNet's six blocks move single outputs of ~500 by 1.5e-4
#: relative between the two float32 routes), or GRAPH_F64_FLOOR
GRAPH_F64_RATIO, GRAPH_F64_FLOOR = 2.0, 1e-5


def graph_phase(dev, ops, sr, cap: Captured) -> collections.Counter:
    """(d): the graph zoo at the registry's shapes, counted, then each
    forward against its plain route, both against the same forward in
    float64 (GRAPH_F64_RATIO, GRAPH_F64_FLOOR)."""
    from repro_torch.configs.registry import GNN_SHAPES

    models = {arch: graph_inputs(dev, arch, GNN_SHAPES[cell], seed=20 + i)
              for i, (arch, cell) in enumerate(GRAPH_CELLS)}
    out = {}

    def drive():
        for arch, (fwd, params, args, _, _) in models.items():
            out[arch] = fwd(params, *args)

    launches = counted(ops, lambda: cap.run("graphs", drive), "graph zoo")
    for arch, cell in GRAPH_CELLS:
        fwd, params, args, m, t = models[arch]
        plain = {"segment_reduce": sr.segment_reduce_plain}
        want = with_ops(ops, plain, lambda: fwd(params, *args))
        exact = with_ops(ops, plain, lambda: fwd(double(params), *double(args)))
        if not bool(torch.isfinite(out[arch]).all()):
            raise AssertionError(f"{arch}: non-finite output")
        ek = float((out[arch].double() - exact).norm() / exact.norm())
        ep = float((want.double() - exact).norm() / exact.norm())
        ms = MEASURED[f"{arch}_forward_ms"] = cuda_ms(lambda: fwd(params, *args), 5, 2)
        log(f"[12 models] {arch} at {cell}: n={args[0].shape[0]} edges={m}"
            f"{f' triplets={t}' if t else ''}, output {tuple(out[arch].shape)}, forward "
            f"{ms:.3f} ms; from the float64 forward {ek:.3g} in relative norm (plain route "
            f"{ep:.3g}; limit {GRAPH_F64_RATIO} x plain or {GRAPH_F64_FLOOR}); max |kernel - "
            f"plain| {abs_err(out[arch], want):.3g}")
        if not ek <= max(GRAPH_F64_RATIO * ep, GRAPH_F64_FLOOR):
            raise AssertionError(f"{arch}: {ek:.3g} from float64 against the plain route's "
                                 f"{ep:.3g}")
    return launches


def hold_call(sr, bag, fa, name: str, args) -> tuple[float, dict]:
    """One kept call against its kernel's plain version on the same inputs:
    segment_reduce bit-equal to segment_reduce_ordered, and each sum within
    L * 2^-24 * sum|v| of the float64 sum over its L rows (the bound of a
    float32 sum of L terms in any order; the model's values have both signs,
    so a relative bound would not hold where they cancel); embedding_bag
    bit-equal to embedding_bag_ordered and within rtol 1e-5 of plain; flash
    within 5e-2 and BF16_REL_ERR (relative norm) of plain and
    ROUNDED_REL_ERR of attention_rounded. Returns the largest |kernel -
    plain| and the sums' largest share of their bound (`bound_share`) or
    the flash output's relative norm from attention_rounded
    (`rounded_rel_err`)."""
    if name == "segment_reduce":
        vals, ids, num, comb, fill = args
        a = sr.segment_reduce_cuda(*args)
        if not bit_equal(a, sr.segment_reduce_ordered(*args)):
            raise AssertionError("differs from segment_reduce_ordered")
        v64 = vals.double()
        exact = sr.segment_reduce_plain(v64, ids, num, comb, fill)
        mass = sr.segment_reduce_plain(v64.abs(), ids, num, comb, fill)
        rows = sr.segment_reduce_plain(torch.ones_like(ids, dtype=torch.float64), ids, num)
        bound = (rows * 2.0 ** -24).reshape((num,) + (1,) * (vals.dim() - 1)) * mass
        off = (a.double() - exact).abs()
        if bool((off > bound).any()):
            raise AssertionError(f"a sum is {float((off - bound).max()):.3g} beyond "
                                 "L * 2^-24 * sum|v| from float64")
        share = float((off / bound.clamp_min(1e-300)).max()) if off.numel() else 0.0
        return abs_err(a, sr.segment_reduce_plain(*args)), {"bound_share": share}
    if name == "embedding_bag":
        a = bag.embedding_bag_cuda(*args)
        if not bit_equal(a, bag.embedding_bag_ordered(*args)):
            raise AssertionError("differs from embedding_bag_ordered")
        p = bag.embedding_bag_plain(*args)
        torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-5)
        return abs_err(a, p), {}
    a, p = fa.flash_attention_cuda(*args), fa.attention_plain(*args)
    torch.testing.assert_close(a.float(), p.float(), rtol=5e-2, atol=5e-2)
    check_rel("against plain", a, p, fa.BF16_REL_ERR)
    r = fa.attention_rounded(*args)
    check_rel("against attention_rounded", a, r, fa.ROUNDED_REL_ERR)
    return abs_err(a.float(), p.float()), {"rounded_rel_err": rel_err(a, r)}


def time_call(sr, bag, fa, name: str, args) -> dict:
    """A kept call timed on the card beside its bound, its plain version and
    the library call that computes the same function."""
    if name == "segment_reduce":
        vals, ids, num = args[:3]
        d = vals.shape[1] if vals.dim() == 2 else 1
        bnd = bound_ms(ids.numel() * 4 + vals.numel() * 4 + num * d * 4, vals.numel())
        out, ids64, v2 = torch.zeros((num, d), device=vals.device), ids.long(), vals.reshape(-1, d)
        row = dict(shape=f"E={vals.shape[0]} D={d} num={num} {args[3]}",
                   ms=graph_ms(lambda: sr.segment_reduce_cuda(*args)),
                   plain_ms=cuda_ms(lambda: sr.segment_reduce_plain(*args), 3, 1),
                   library_ms=graph_ms(lambda: out.index_add_(0, ids64, v2)))
    elif name == "embedding_bag":
        table, idx, mode = args
        nrows = int(torch.unique(idx).numel())
        d = table.shape[1]
        bnd = bound_ms(nrows * d * 4 + idx.numel() * 4 + idx.shape[0] * d * 4, idx.numel() * d)
        idx64 = idx.long()
        row = dict(shape=f"table {tuple(table.shape)}, B={idx.shape[0]} K={idx.shape[1]} "
                         f"{mode}, {nrows} distinct rows",
                   ms=graph_ms(lambda: bag.embedding_bag_cuda(*args)),
                   plain_ms=cuda_ms(lambda: bag.embedding_bag_plain(*args), 3, 1),
                   library_ms=graph_ms(lambda: F.embedding_bag(idx64, table, mode=mode)))
    else:
        q, k, v, causal = args
        b_, hq, sq, dh = q.shape
        skv = k.shape[2]
        pairs = b_ * hq * (sum(min(skv, i + 1 + skv - sq) for i in range(sq)) if causal
                           else sq * skv)
        nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
        peak = BF16_OPS_PER_S if fa.route(q.dtype, dh) == fa.TENSOR_CORES else TF32_OPS_PER_S
        bnd = bound_ms(nbytes, 4 * pairs * dh * (1 if q.dtype == torch.bfloat16 else 3), peak)
        group = hq // k.shape[1]
        kr, vr = k.repeat(1, group, 1, 1), v.repeat(1, group, 1, 1)     # group-major
        row = dict(shape=f"q {tuple(q.shape)}, kv {tuple(k.shape)}, {q.dtype}, "
                         f"{'causal' if causal else 'full'}",
                   ms=cuda_ms(lambda: fa.flash_attention_cuda(*args), 10),
                   plain_ms=cuda_ms(lambda: fa.attention_plain(*args), 3, 1),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       q, kr, vr, is_causal=causal), 10))
    row.update(bound_ms=bnd[0], bound_by=bnd[1])
    return row


def hold_model_kernels(sr, bag, fa, cap: Captured, launches, report) -> None:
    """Every kept call of the counted runs held by `hold_call`, the first of
    each (kernel, part, shapes) key timed by `time_call`; the rows go under
    report[kernel]['model_path'] beside the model path's launches."""
    rows = collections.defaultdict(list)
    for key, calls in cap.calls.items():
        name, where = key[:2]
        worst, most = 0.0, {}
        for args in calls:
            try:
                e, extra = hold_call(sr, bag, fa, name, args)
            except AssertionError as exc:
                raise AssertionError(f"{name} in {where}, {key[2:]}: {exc}") from exc
            worst = max(worst, e)
            most = {k: max(v, most.get(k, 0.0)) for k, v in extra.items()}
        row = time_call(sr, bag, fa, name, calls[0])
        row.update(where=where, launches=cap.count[key], held=len(calls), max_abs_err=worst,
                   **most)
        note = "".join(f"; {k} {v:.3g}" for k, v in most.items())
        if name == "flash_attention":
            name = fa.route(calls[0][0].dtype, calls[0][0].shape[3])
        rows[name].append(row)
        log(f"[12 models] {name} in {where}, {row['shape']}: {row['launches']} launches, "
            f"{row['held']} held against the plain version (max abs err {worst:.3g}{note}); "
            f"card {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} by {row['bound_by']}, "
            f"plain {row['plain_ms']:.4f}, library {row['library_ms']:.4f}")
    for name in MODEL_KERNELS:
        report[name]["model_path"] = dict(launches=launches[name], shapes=rows[name])
        report[name]["max_abs_err"] = max([report[name]["max_abs_err"]]
                                          + [r["max_abs_err"] for r in rows[name]])


def models_phase(dev, ops, sr, bag, fa, report, profile: bool = False) -> dict:
    """Phase 12: the model stacks' serving path at the published widths:
    (a) granite-3-8b and (b) granite-moe-1b-a400m served and forwarded in
    bf16, (c) DeepFM, (d) the graph zoo; each driven path counted, then
    checked against its plain route, then every kept kernel call held and
    timed (`hold_model_kernels`). Returns the counted launches."""
    cap = Captured(sr, bag, fa)
    launches = collections.Counter()
    t = [time.perf_counter()]
    for name in ("granite-3-8b", "granite-moe-1b-a400m"):
        launches.update(lm_phase(dev, name, ops, fa, cap, profile))
        reset_peak()
        t.append(time.perf_counter())
    launches.update(deepfm_phase(dev, ops, bag, cap))
    t.append(time.perf_counter())
    launches.update(graph_phase(dev, ops, sr, cap))
    t.append(time.perf_counter())
    for name in ("flash_attention", "segment_reduce", "embedding_bag"):
        if not launches[name]:
            raise AssertionError(f"{name} was not launched on the model path: {dict(launches)}")
    hold_model_kernels(sr, bag, fa, cap, launches, report)
    del cap
    reset_peak()
    log(f"[12 models] launches on the model path {dict(launches)}; (a) {t[1] - t[0]:.1f} s, "
        f"(b) {t[2] - t[1]:.1f} s, (c) {t[3] - t[2]:.1f} s, (d) {t[4] - t[3]:.1f} s, holds "
        f"{time.perf_counter() - t[4]:.1f} s")
    return {k: launches[k] for k in MODEL_KERNELS}


# ---------------------------------------------------------------------------
# phase 13: acclint on the card
# ---------------------------------------------------------------------------

#: the engine kernels phase 13 launches (combiner probes, captured steps)
ACCLINT_KERNELS = ("segment_reduce", "frontier_pack", "ell_combine", "ell_combine_batched")
#: the programs whose solo and batched steps are also checked on phase 4's graph
ACCLINT_WIDE = ("bfs", "sssp", "pagerank")


def acclint_run(acclint, argv: list) -> tuple[int, dict]:
    """`python -m repro_torch.launch.acclint <argv> --json -` in this
    process: (exit code, report)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = acclint.run([*argv, "--json", "-"])
    return rc, json.loads(buf.getvalue())


def acclint_phase(dev, ops, g) -> collections.Counter:
    """Phase 13: acclint on the card (module docstring). Returns the
    phase's launches of ACCLINT_KERNELS."""
    from repro_torch.analysis import apply_baseline, load_baseline, trace_check
    from repro_torch.analysis.findings import BASELINE_PATH, RULES
    from repro_torch.graph import pack_ell
    from repro_torch.launch import acclint
    from repro_torch.launch.catalog import make_catalog

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rc, rep = acclint_run(acclint, ["--device", str(dev)])
    secs = rep["seconds"]
    per = secs.pop("trace_entries")
    log(f"[13 acclint] every backend, scale 6: exit {rc}, checked {rep['checked']}, "
        f"active {len(rep['findings'])}, suppressed {len(rep['suppressed'])}, "
        f"stale {len(rep['stale_suppressions'])}; seconds "
        f"{ {k: round(v, 3) for k, v in secs.items()} } "
        f"({time.perf_counter() - t0:.1f} s with the graph build)")
    slow = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    log(f"[13 acclint] trace entries: {len(per)}, mean {sum(per.values()) / len(per):.4f} s, "
        f"slowest {[(k, round(v, 4)) for k, v in slow]}")
    if rc != 0 or rep["findings"] or rep["stale_suppressions"]:
        raise AssertionError(f"acclint on the card: exit {rc}, active {rep['findings']}, "
                             f"stale {rep['stale_suppressions']}")

    t0 = time.perf_counter()
    pack = pack_ell(g.inc)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    cat = make_catalog()
    findings, wide = [], {}
    for entry, make in trace_check.catalog_entries(
            {k: cat[k] for k in ACCLINT_WIDE}, sharded=False, device=dev, graph=(g, pack)):
        if "masked" in entry:
            continue
        t1 = time.perf_counter()
        findings += trace_check.check_step(entry, make)
        wide[entry] = time.perf_counter() - t1
    del pack
    active, suppressed, _stale = apply_baseline(findings, load_baseline(BASELINE_PATH))
    log(f"[13 acclint] trace backend on phase 4's graph (n={g.n_nodes}, m={g.n_edges}; "
        f"re-pack {t_pack:.2f} s): {len(wide)} entries, active {len(active)}, "
        f"suppressed {len(suppressed)}; seconds {[(k, round(v, 4)) for k, v in wide.items()]}")
    if active:
        raise AssertionError(f"acclint trace findings at RMAT scale 22: {active}")

    rc, fx = acclint_run(acclint, ["--fixtures", "--device", str(dev)])
    fired = {f["rule"] for f in fx["findings"]}
    log(f"[13 acclint] --fixtures: exit {rc}, rules fired {sorted(fired)}")
    if rc != 1 or fired != set(RULES):
        raise AssertionError(f"acclint fixtures: exit {rc}, missing {sorted(set(RULES) - fired)}")
    torch.cuda.synchronize()
    got = collections.Counter({k: v for k, v in ops.launch_counts().items()
                               if k in ACCLINT_KERNELS})
    log(f"[13 acclint] launches {dict(got)}")
    missing = [k for k in ACCLINT_KERNELS if not got[k]]
    if missing:
        raise AssertionError(f"acclint launched no {missing}")
    return got


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

#: the backward sweep: (B, Hq, Hkv, Sq, Skv, Dh), ragged across the 64-row
#: tiles, Sq < Skv and (last) Sq > Skv, Hq / Hkv of 1, 2, 4 and 8, Dh 12,
#: 16, 64, 96 and 128
BWD_SWEEP = [(1, 1, 1, 37, 37, 12), (2, 2, 1, 70, 133, 16), (1, 4, 2, 129, 200, 64),
             (1, 8, 8, 64, 64, 128), (2, 8, 2, 100, 257, 64), (1, 8, 4, 1, 77, 128),
             (1, 4, 1, 257, 513, 16), (1, 8, 1, 65, 130, 64), (1, 4, 2, 300, 90, 96)]
#: (c): granite-moe-1b-a400m at its published config, `main`'s batch at S 1024
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "granite-moe-1b-a400m", 8, 1024, 10
#: (d): `main` end to end on the reference's 100m preset, resumed from step 10
MAIN_ARGV = ["--arch", "granite-moe-1b-a400m", "--preset", "100m", "--steps", "20",
             "--ckpt-every", "10"]
#: (e): AdamW steps a family; a gradient leaf's float32 distance from the
#: float64 plain route (relative norm) may be GRAPH_F64_RATIO times the
#: float32 plain route's, or GRAPH_F64_FLOOR. The plain route is the
#: kernels' fold-order models (`segment_reduce_ordered`,
#: `embedding_bag_ordered`), so its forward sums are the kernels' and its
#: reading does not move from run to run (`index_add_`'s does)
FAMILY_STEPS = 5
#: (b): the gradient scatters at the main path's shapes: the granite-moe
#: embedding (vocab padded to 51200, d 1024) at 8 x 1024 tokens, its MoE
#: combine (8,192 tokens x top 8 pairs), DeepFM's table at B = 4,096
SCATTER_CASES = (("gather_rows", 51200, 1024, (8, 1024)),
                 ("segment_reduce", 8192, 1024, 65536),
                 ("embedding_bag", 3_900_000, 10, (4096, 39)))
#: the flash backward's timed shapes: granite-moe-1b-a400m's layer ((c)'s,
#: in bf16: the wgmma backward; and in float32), granite-3-8b's, and (d)'s
#: 100m layer in float32 (the TF32 backward's main path); each
#: kernel's row is its first shape
BWD_TIMED = (("granite-moe", (8, 16, 8, 1024, 64), torch.bfloat16),
             ("100m float32", (8, 12, 6, 128, 64), torch.float32),
             ("granite-moe float32", (8, 16, 8, 1024, 64), torch.float32),
             ("granite-3-8b", (2, 32, 8, 1024, 128), torch.bfloat16))
TRAIN_KERNELS = ("flash_attention", "flash_attention_f32", "flash_attention_bwd",
                 "flash_attention_bwd_wgmma", "segment_reduce", "embedding_bag")
#: the kernels (d)'s float32 MoE run must launch, read from its summary line
MAIN_KERNELS = ("flash_attention_f32", "flash_attention_bwd", "segment_reduce")


def exact_attention_grads(fa, q, k, v, dout, causal: bool):
    """float64 autograd of `attention_plain` on the (rounded) inputs. Under
    `causal` with Sq > Skv the first Sq - Skv rows see no key: autograd
    gives them NaN and nothing to dk and dv, so they are left out (the
    sweep checks apart that the kernels' dq is 0 there)."""
    lo = max(0, q.shape[2] - k.shape[2]) if causal else 0
    qq, kk, vv = (t.double().requires_grad_() for t in (q[:, :, lo:], k, v))
    out = fa.attention_plain(qq, kk, vv, causal)
    return torch.autograd.grad(out, (qq, kk, vv), dout[:, :, lo:].double())


def bwd_err(fa, got, exact) -> float:
    """The backward's error as its tolerance reads it: float32, the largest
    |a - x| over the largest |x| of each gradient; bfloat16, the relative
    norm. A dq with more rows than the exact one is compared on its last
    rows (`exact_attention_grads`)."""
    got = (got[0][:, :, got[0].shape[2] - exact[0].shape[2]:],) + tuple(got[1:])
    if got[0].dtype == torch.float32:
        return max(float((a.double() - x).abs().max() / x.abs().max()) for a, x in zip(got, exact))
    return max(float((a.double() - x).norm() / x.norm()) for a, x in zip(got, exact))


def rounded_err(got, rounded) -> float:
    """The wgmma backward's distance from `attention_bwd_rounded`: the
    largest relative norm over (dq, dk, dv)."""
    return max(rel_err(a, r) for a, r in zip(got, rounded))


def forward_for_bwd(fa, q, k, v, causal: bool):
    """(out, lse) of the flash forward as training runs it: either forward
    route writes lse for its backward."""
    return fa.flash_attention_cuda(q, k, v, causal, with_lse=True)


def sweep_flash_bwd(dev, rng, fa, ops) -> dict:
    """(a) The backward that `route_bwd` picks, one launch a call under its
    own counter, against float64 autograd of the plain attention on the
    same inputs, both dtypes, causal and not; the wgmma kernel also against
    `attention_bwd_rounded`, the TF32 one in float32 against
    `attention_bwd_3xtf32` (BWD_F32_ERR of the largest entry); each call
    repeated and bit-equal; a row that sees nothing gets a zero dq. The
    control: the kernel's gradients with key 0's row of dK and dV set to 0
    must miss every tolerance. Returns each kernel's worst max |kernel -
    reference| (float64 autograd for the TF32 kernel,
    `attention_bwd_rounded` for the wgmma one)."""
    worst_abs = {fa.BACKWARD: 0.0, fa.BACKWARD_WGMMA: 0.0}
    worst = {fa.BACKWARD: 0.0, fa.BACKWARD_WGMMA: 0.0, "rounded": 0.0, "3xtf32": 0.0}
    least_control = {"exact": float("inf"), "rounded": float("inf")}
    for b, hq, hkv, sq, skv, d in BWD_SWEEP:
        base = [rng.standard_normal(s) for s in ((b, hq, sq, d), (b, hkv, skv, d),
                                                  (b, hkv, skv, d), (b, hq, sq, d))]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, dout = (torch.from_numpy(x).to(dev).to(dt) for x in base)
            tol = fa.BWD_F32_ERR if dt == torch.float32 else fa.BWD_BF16_REL_ERR
            kernel = fa.route_bwd(dt, d)
            for causal in (True, False):
                out, lse = forward_for_bwd(fa, q, k, v, causal)
                ops.reset_launches()
                got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, causal, lse)
                counts = ops.launch_counts()
                if counts[kernel] != 1 or sum(counts.values()) != 1:
                    raise AssertionError(f"the flash backward did not launch {kernel} alone, "
                                         f"once: {counts}")
                again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, causal, lse)
                what = (f"{kernel} B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} {dt} "
                        f"{causal=}")
                if not all(bit_equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"{what}: two calls differ")
                exact = exact_attention_grads(fa, q, k, v, dout, causal)
                lo = sq - exact[0].shape[2]
                if bool(got[0][:, :, :lo].any()):
                    raise AssertionError(f"{what}: a row that sees nothing has a nonzero dq")
                e = bwd_err(fa, got, exact)
                if not e <= tol:
                    raise AssertionError(f"{what}: error {e:.3g} > {tol}")
                worst[kernel] = max(worst[kernel], e)
                dropped = [x.clone() for x in got]
                for x in dropped[1:]:
                    x[:, :, 0] = 0
                control = bwd_err(fa, dropped, exact)
                if not control > tol:
                    raise AssertionError(f"{what}: with key 0's row of dK and dV dropped the "
                                         f"error is {control:.3g}, within the tolerance")
                least_control["exact"] = min(least_control["exact"], control / tol)
                if kernel == fa.BACKWARD:
                    if dt == torch.float32:
                        worst_abs[kernel] = max(worst_abs[kernel], max(
                            abs_err(a.double()[:, :, a.shape[2] - x.shape[2]:], x)
                            for a, x in zip(got, exact)))
                        model = fa.attention_bwd_3xtf32(q, k, v, out, dout, causal)
                        m = max(float((a.double() - x.double()).abs().max()
                                      / x.double().abs().max()) for a, x in zip(got, model))
                        if not m <= fa.BWD_F32_ERR:
                            raise AssertionError(f"{what}: {m:.3g} from attention_bwd_3xtf32 "
                                                 f"> {fa.BWD_F32_ERR}")
                        worst["3xtf32"] = max(worst["3xtf32"], m)
                    continue
                rounded = fa.attention_bwd_rounded(q, k, v, out, dout, causal)
                r = rounded_err(got, rounded)
                if not r <= fa.BWD_ROUNDED_REL_ERR:
                    raise AssertionError(f"{what}: {r:.3g} from attention_bwd_rounded > "
                                         f"{fa.BWD_ROUNDED_REL_ERR}")
                worst["rounded"] = max(worst["rounded"], r)
                worst_abs[kernel] = max(worst_abs[kernel], max(
                    abs_err(a.float(), x.float()) for a, x in zip(got, rounded)))
                control = rounded_err(dropped, rounded)
                if not control > fa.BWD_ROUNDED_REL_ERR:
                    raise AssertionError(f"{what}: with key 0's row of dK and dV dropped it is "
                                         f"{control:.3g} from attention_bwd_rounded")
                least_control["rounded"] = min(least_control["rounded"],
                                               control / fa.BWD_ROUNDED_REL_ERR)
    log(f"[14 training] (a) flash backward sweep ({len(BWD_SWEEP)} shapes x 2 dtypes x causal "
        f"and not) against float64 autograd of attention_plain: {fa.BACKWARD} (float32 and "
        f"bf16 with Dh % 8 != 0) worst {worst[fa.BACKWARD]:.3g} (float32: of the largest entry, "
        f"limit {fa.BWD_F32_ERR}; bf16: relative norm, limit {fa.BWD_BF16_REL_ERR}), float32 "
        f"{worst['3xtf32']:.3g} of the largest entry from attention_bwd_3xtf32, "
        f"{fa.BACKWARD_WGMMA} (bf16) worst relative norm {worst[fa.BACKWARD_WGMMA]:.3g} (limit "
        f"{fa.BWD_BF16_REL_ERR}) and {worst['rounded']:.3g} from attention_bwd_rounded (limit "
        f"{fa.BWD_ROUNDED_REL_ERR}); every call bit-equal on a repeat; with key 0's row of dK "
        f"and dV dropped, at least {least_control['exact']:.3g} times the float64 tolerance "
        f"and {least_control['rounded']:.3g} times the rounded one")
    return worst_abs


def check_scatter(got: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor, num: int,
                  what: str) -> float:
    """`got` (num, D), a float32 scatter-sum of `rows` by `ids` (ids outside
    [0, num) dropped), within L * 2^-24 * sum|v| of the float64 sum of each
    entry's L rows (a float32 sum in any order). Returns the largest share
    of that bound."""
    ok = (ids >= 0) & (ids < num)
    ids, rows = ids[ok].long(), rows.reshape(ids.shape[0], -1)[ok].double()
    d = rows.shape[1]
    exact = torch.zeros((num, d), dtype=torch.float64, device=rows.device).index_add_(0, ids, rows)
    mass = torch.zeros_like(exact).index_add_(0, ids, rows.abs())
    count = torch.bincount(ids, minlength=num).double()[:, None]
    bound = count * 2.0 ** -24 * mass
    off = (got.reshape(num, d).double() - exact).abs()
    if bool((off > bound).any()):
        raise AssertionError(f"{what}: a sum is {float((off - bound).max()):.3g} beyond its "
                             "float32 bound")
    return float((off / bound.clamp_min(1e-300)).max())


def hold_scatters(dev, ops, sr, bag) -> None:
    """(b) `gather_rows`, the sum backwards of `segment_reduce` and of
    `embedding_bag` at SCATTER_CASES' shapes, on the card: each gradient
    within the float32 bound of the float64 sum (`check_scatter`), against
    plain autograd, and two backward calls bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(14)
    for name, v, d, shape in SCATTER_CASES:
        grads = []
        if name == "gather_rows":
            table = torch.randn(v, d, device=dev, generator=gen)
            idx = torch.randint(0, 49155, shape, device=dev, generator=gen)
            g = torch.randn(shape + (d,), device=dev, generator=gen)
            for _ in range(2):
                t = table.clone().requires_grad_()
                ops.reset_launches()
                (ops.gather_rows(t, idx) * g).sum().backward()
                grads.append(t.grad)
            ids, rows, num = idx.reshape(-1), g.reshape(-1, d), v
            t = table.clone().requires_grad_()
            (t[idx] * g).sum().backward()
            plain = t.grad
        elif name == "segment_reduce":
            vals = torch.randn(shape, d, device=dev, generator=gen)
            sid = torch.sort(torch.randint(0, v, (shape,), device=dev, generator=gen,
                                           dtype=torch.int32)).values
            g = torch.randn(v, d, device=dev, generator=gen)
            for _ in range(2):
                x = vals.clone().requires_grad_()
                ops.reset_launches()
                (ops.segment_reduce(x, sid, v) * g).sum().backward()
                grads.append(x.grad)
            x = vals.clone().requires_grad_()
            (sr.segment_reduce_plain(x, sid, v) * g).sum().backward()
            plain = x.grad
            if not bit_equal(grads[0], plain):      # a gather: exact
                raise AssertionError("segment_reduce's backward differs from plain autograd")
        else:
            table = torch.randn(v, d, device=dev, generator=gen) * 0.01
            idx = torch.randint(0, v, shape, device=dev, generator=gen, dtype=torch.int32)
            g = torch.randn(shape[0], d, device=dev, generator=gen)
            for _ in range(2):
                t = table.clone().requires_grad_()
                ops.reset_launches()
                (ops.embedding_bag(t, idx, "sum") * g).sum().backward()
                grads.append(t.grad)
            ids, rows, num = idx.reshape(-1), g[:, None].expand(shape + (d,)).reshape(-1, d), v
            t = table.clone().requires_grad_()
            (bag.embedding_bag_plain(t, idx, "sum") * g).sum().backward()
            plain = t.grad
        counts = ops.launch_counts()
        if not bit_equal(grads[0], grads[1]):
            raise AssertionError(f"{name}: two backward calls differ")
        share = None
        if name != "segment_reduce":
            if counts["segment_reduce"] != 1:
                raise AssertionError(f"{name}'s backward launched segment_reduce "
                                     f"{counts['segment_reduce']} times")
            share = check_scatter(grads[0], ids, rows, num, name)
            check_scatter(plain, ids, rows, num, f"{name} (plain autograd)")
        log(f"[14 training] (b) {name} backward at {shape} over ({v}, {d}): bit-equal on a "
            f"repeat; max |kernel route - plain autograd| {abs_err(grads[0], plain):.3g}"
            f"{' (a gather: equal)' if share is None else f'; {share:.3g} of its float32 bound'}")
    reset_peak()


def grad_leaves_ok(grads, what: str) -> None:
    for i, g in enumerate(grads):
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            raise AssertionError(f"{what}: gradient leaf {i} {tuple(g.shape)} is not finite or "
                                 "all zero")


def granite_moe_training(dev, ops) -> collections.Counter:
    """(c) granite-moe-1b-a400m at its published width and depth in bf16:
    TRAIN_STEPS steps of `train_step` at main's batch and S = 1024, through
    the functions `main` uses (`preset_config`, `init_params`, `adamw.init`,
    `TokenStream`, `train_step`), counted; the loss must fall; then one
    step's gradients twice, bit-equal, every leaf finite and nonzero."""
    from repro_torch import obs
    from repro_torch import tree as T
    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    cfg = train.preset_config(TRAIN_ARCH, "full")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, total_steps=TRAIN_STEPS,
                                warmup_steps=max(10, TRAIN_STEPS // 20), weight_decay=0.01)
    reset_peak()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw.init(params, opt_cfg)
    params = train.trainable(params)
    stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in next(stream))
               for _ in range(TRAIN_STEPS + 1)]
    losses, times = [], []

    def drive():
        for x, y in batches[:TRAIN_STEPS]:
            t = time.perf_counter()
            m = train.train_step(params, opt, x, y, cfg, opt_cfg)
            losses.append(float(obs.device_fetch(m["loss"])))
            times.append(time.perf_counter() - t)

    torch.cuda.synchronize()
    ops.reset_launches()
    drive()
    torch.cuda.synchronize()
    launches = collections.Counter({k: v for k, v in ops.launch_counts().items() if v})
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = sum(times[1:]) / (len(times) - 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[14 training] (c) {TRAIN_ARCH} ({cfg.param_count() / 1e9:.3f} B parameters, bf16, "
        f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.moe.n_experts} experts top "
        f"{cfg.moe.top_k}, remat): {TRAIN_STEPS} steps at B={TRAIN_BATCH} S={TRAIN_SEQ}; losses "
        f"{[round(x, 4) for x in losses]}; {per_step:.3f} s/step after the first "
        f"({times[0]:.3f} s), {tokens / per_step:.0f} tokens/s; peak {peak:.2f} GiB; launches "
        f"{dict(launches)}")
    if not (losses[-1] < losses[0] and all(np.isfinite(losses))):
        raise AssertionError(f"{TRAIN_ARCH}: the loss did not fall: {losses}")
    for k in ("flash_attention", "flash_attention_bwd_wgmma", "segment_reduce"):
        if not launches[k]:
            raise AssertionError(f"{TRAIN_ARCH} training did not launch {k}")
    if (launches["flash_attention_bwd_wgmma"] != cfg.n_layers * TRAIN_STEPS
            or launches["flash_attention_bwd"]):
        raise AssertionError(f"{TRAIN_ARCH} training: the backward should launch the wgmma "
                             f"kernel once a layer a step and the TF32 one never: "
                             f"{dict(launches)}")
    x, y = batches[-1]
    leaves = T.leaves(params)
    runs = []
    for _ in range(2):
        loss = tfm.loss_fn(params, x, y, cfg)
        runs.append(torch.autograd.grad(loss, leaves))
        del loss
    same = all(bit_equal(a, b) for a, b in zip(*runs))
    grad_leaves_ok(runs[0], TRAIN_ARCH)
    log(f"[14 training] (c) one step's backward twice: {len(leaves)} gradient leaves "
        f"{'bit-equal' if same else 'DIFFER'}, all finite and nonzero")
    if not same:
        raise AssertionError(f"{TRAIN_ARCH}: two backward passes differ")
    MEASURED["train"] = dict(s_per_step=per_step, tokens_per_s=tokens / per_step,
                             peak_gib=peak, first_loss=losses[0], last_loss=losses[-1])
    del params, opt, runs, batches
    reset_peak()
    return launches


def main_resume(root: Path) -> collections.Counter:
    """(d) `python -m repro_torch.launch.train` end to end on the 100m
    preset, then step_20 set aside and the run resumed from step_10: the
    resumed step-20 parameters and moments bit-equal to the straight run's.
    Returns the straight run's launches, from its JSON summary line, which
    must hold every kernel of MAIN_KERNELS."""
    import shutil

    from repro_torch.launch import train

    ckpt = root / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps = int(MAIN_ARGV[MAIN_ARGV.index("--steps") + 1])
    every = int(MAIN_ARGV[MAIN_ARGV.index("--ckpt-every") + 1])
    last, mid = f"step_{steps}", steps - every
    argv = [sys.executable, "-m", "repro_torch.launch.train", *MAIN_ARGV, "--ckpt-dir", str(ckpt)]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    outs, launches = [], collections.Counter()
    for run in ("straight", "resumed"):
        t0 = time.perf_counter()
        out = subprocess.run(argv, cwd=root, env=env, capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"train {run} rc={out.returncode}:\n{out.stdout[-2000:]}"
                                 f"\n{out.stderr[-3000:]}")
        lines = out.stdout.strip().splitlines()
        log(f"[14 training] (d) {' '.join(MAIN_ARGV)} ({run}, "
            f"{time.perf_counter() - t0:.1f} s): " + " | ".join(lines))
        outs.append(out.stdout)
        if run == "straight":
            os.replace(ckpt / last, ckpt / "straight")
            launches.update(json.loads(lines[-1])["launches"])
            missing = [k for k in MAIN_KERNELS if not launches[k]]
            if missing:
                raise AssertionError(f"the straight run launched no {missing}: {dict(launches)}")
            layers = train.preset_config(MAIN_ARGV[MAIN_ARGV.index("--arch") + 1],
                                         MAIN_ARGV[MAIN_ARGV.index("--preset") + 1]).n_layers
            if launches["flash_attention_bwd"] != layers * steps or launches[
                    "flash_attention_bwd_wgmma"]:
                raise AssertionError(f"the float32 run should launch the TF32 backward "
                                     f"once a layer a step and the wgmma one never: "
                                     f"{dict(launches)}")
    if f"[resume] from step {mid}" not in outs[1]:
        raise AssertionError(f"the second run did not resume from step {mid}")
    with np.load(ckpt / "straight" / "arrays.npz") as a, \
            np.load(ckpt / last / "arrays.npz") as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError(f"the two {last} checkpoints hold other keys")
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        n_keys = len(a.files)
    log(f"[14 training] (d) resumed {last} against the straight run's: {n_keys} arrays, "
        f"{len(differ)} differ {differ[:5]}")
    if differ:
        raise AssertionError(f"the resumed run's {last} differs in {differ}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches


def family_inputs(dev, arch: str):
    """(loss_fn, params, args) of a family at phase 12's published widths:
    DeepFM on a ClickStream batch of 4,096, the GNNs on `gnn_dataset` over
    phase 12's graphs (graph labels drawn for the graph readout), DimeNet on
    phase 12's molecules with drawn targets."""
    from repro_torch import configs
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data import ClickStream, gnn_dataset
    from repro_torch.models import deepfm, dimenet, gnn

    if arch == "deepfm":
        cfg = configs.get("deepfm").make_config()
        stream = ClickStream(cfg.n_fields, cfg.vocab_per_field, cfg.embed_dim, 4096, seed=0)
        params = deepfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        batches = [tuple(torch.from_numpy(a).to(dev) for a in next(stream))
                   for _ in range(FAMILY_STEPS)]
        return deepfm.loss_fn, params, [(ids, y, cfg) for ids, y in batches]
    cell = dict(GRAPH_CELLS)[arch]
    fwd, params, args, _, _ = graph_inputs(dev, arch, GNN_SHAPES[cell], seed=30)
    rng = np.random.default_rng(30)
    if arch == "dimenet":
        cfg, gids, n_graphs = args[6], args[7], args[8]
        tgt = torch.from_numpy(rng.standard_normal((n_graphs, cfg.n_targets))
                               .astype(np.float32)).to(dev)
        return dimenet.loss_fn, params, [args[:6] + (tgt, cfg, gids, n_graphs)]
    feats, src, dst, w, cfg, gids, n_graphs = args
    n = feats.shape[0]
    f, labels, mask = gnn_dataset(n, src.cpu().numpy(), dst.cpu().numpy(), cfg.d_in,
                                  cfg.n_classes, seed=30)
    if cfg.readout == "graph":
        labels, mask = rng.integers(0, cfg.n_classes, n_graphs).astype(np.int32), None
    feats = torch.from_numpy(f).to(dev)
    mask = None if mask is None else torch.from_numpy(mask).to(dev)
    return gnn.loss_fn, params, [(feats, src, dst, w, torch.from_numpy(labels).to(dev), cfg,
                                  mask, gids, n_graphs)]


def grads_of(loss_fn, params, args):
    """Gradients of loss_fn(params, *args) in `walk` order (a leaf the loss
    does not reach gets zeros)."""
    from repro_torch import tree as T

    return torch.autograd.grad(loss_fn(params, *args), T.leaves(params), allow_unused=True,
                               materialize_grads=True)


def grad_rel(grads, exact) -> float:
    """The largest relative norm error of a gradient leaf against float64."""
    return max(float((a.double() - x).norm() / x.norm().clamp_min(1e-300))
               for a, x in zip(grads, exact))


def family_training(dev, ops, sr, bag, fa) -> collections.Counter:
    """(e) FAMILY_STEPS AdamW steps of DeepFM, gcn-cora, gatedgcn, gin-tu and
    DimeNet, counted; before the first, the gradients on the kernels and
    with every kernel op swapped to its plain version and autograd's own
    backward (`with_ops`), each against the plain route's gradients in
    float64: the kernels' worst leaf (relative norm) within GRAPH_F64_RATIO
    times the plain route's or GRAPH_F64_FLOOR; the losses finite."""
    from repro_torch import tree as T
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    plain = {"segment_reduce": sr.segment_reduce_ordered,
             "embedding_bag": bag.embedding_bag_ordered, "attention": fa.attention_plain,
             "gather_rows": lambda t, i: t[i.long()]}
    launches = collections.Counter()
    for arch in ("deepfm",) + tuple(a for a, _ in GRAPH_CELLS):
        loss_fn, params, batches = family_inputs(dev, arch)
        params = train.trainable(params)
        leaves = T.leaves(params)
        opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=FAMILY_STEPS)
        opt = adamw.init(params, opt_cfg)
        p64 = T.unflatten(params, [x.detach().double().requires_grad_() for x in leaves])
        exact = with_ops(ops, plain, lambda: grads_of(loss_fn, p64, double(batches[0])))
        ep = grad_rel(with_ops(ops, plain, lambda: grads_of(loss_fn, params, batches[0])), exact)
        del p64
        losses = []
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        for step in range(FAMILY_STEPS):
            args = batches[step % len(batches)]
            loss = loss_fn(params, *args)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            if step == 0:
                ek = grad_rel(grads, exact)
            adamw.update(T.unflatten(params, grads), opt, params, opt_cfg)
            losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        got = collections.Counter({k: v for k, v in ops.launch_counts().items() if v})
        launches.update(got)
        log(f"[14 training] (e) {arch}: {FAMILY_STEPS} AdamW steps in "
            f"{time.perf_counter() - t0:.2f} s, losses {[round(x, 4) for x in losses]}; first "
            f"gradients from the float64 plain route: kernels {ek:.3g}, plain route {ep:.3g} "
            f"(worst leaf, relative norm; limit {GRAPH_F64_RATIO} x plain or "
            f"{GRAPH_F64_FLOOR}); launches {dict(got)}")
        if not (ek <= max(GRAPH_F64_RATIO * ep, GRAPH_F64_FLOOR) and all(np.isfinite(losses))):
            raise AssertionError(f"{arch}: gradients {ek:.3g} from float64 against the plain "
                                 f"route's {ep:.3g}, or a loss not finite: {losses}")
        del params, opt, batches, exact, grads
    reset_peak()
    return launches


def time_flash_bwd(dev, fa, report, worst_abs: dict, launches) -> None:
    """The flash backward's rows, timed at BWD_TIMED's shapes by the kernel
    that `route_bwd` picks (given its forward's lse), beside its plain
    version (`attention_bwd_rounded` for the wgmma kernel,
    `attention_bwd_plain` for the TF32 one), its operations bound (five products over the causal pairs) and the backward
    of scaled_dot_product_attention with the query heads permuted so that
    the library's h // group map reads the kv head the port's h % Hkv map
    reads. At each shape one call's (dq, dk, dv) is held against float64
    autograd of the plain attention, as the sweep holds them (`bwd_err`),
    and the wgmma kernel's also against `attention_bwd_rounded`. Each
    kernel's first shape is its row; `launches` are the main path's."""
    gen = torch.Generator(device=dev).manual_seed(15)
    rows = {fa.BACKWARD: {}, fa.BACKWARD_WGMMA: {}}
    for label, (b, hq, hkv, s, d), dt in BWD_TIMED:
        q = torch.randn(b, hq, s, d, device=dev, generator=gen).to(dt)
        k, v = (torch.randn(b, hkv, s, d, device=dev, generator=gen).to(dt) for _ in range(2))
        dout = torch.randn(b, hq, s, d, device=dev, generator=gen).to(dt)
        kernel = fa.route_bwd(dt, d)
        out, lse = forward_for_bwd(fa, q, k, v, True)
        pairs = b * hq * s * (s + 1) // 2
        nbytes = (3 * q.numel() + 2 * k.numel() + q.numel() + 2 * k.numel()) * q.element_size()
        # five products over the causal pairs; float32 as three TF32 products
        bf16 = dt == torch.bfloat16
        bnd = bound_ms(nbytes, 10 * pairs * d * (1 if bf16 else 3),
                       BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S)
        group = hq // hkv
        perm = [h for j in range(hkv) for h in range(j, hq, hkv)]     # library head j*group+t
        ql = q[:, perm].contiguous().requires_grad_()
        kl, vl = k.clone().requires_grad_(), v.clone().requires_grad_()
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
        back = lib_out.detach()[:, [perm.index(h) for h in range(hq)]]
        if not rel_err(back, out) <= fa.BF16_REL_ERR:
            raise AssertionError("the permuted library attention is not the port's")
        dl = dout[:, perm].contiguous()
        got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, True, lse)
        exact = exact_attention_grads(fa, q, k, v, dout, True)
        err, tol = bwd_err(fa, got, exact), (fa.BWD_F32_ERR if not bf16 else fa.BWD_BF16_REL_ERR)
        if kernel == fa.BACKWARD and not bf16:
            worst_abs[kernel] = max(worst_abs[kernel],
                                    max(abs_err(a.double(), x) for a, x in zip(got, exact)))
        del exact
        if not err <= tol:
            raise AssertionError(f"{kernel} at {label}: error {err:.3g} > {tol}")
        r = dict(err=err, tol=tol, shape=f"q {tuple(q.shape)}, kv {tuple(k.shape)}, {dt}, causal")
        if kernel == fa.BACKWARD_WGMMA:
            rounded = fa.attention_bwd_rounded(q, k, v, out, dout, True)
            r["rounded_err"] = rounded_err(got, rounded)
            if not r["rounded_err"] <= fa.BWD_ROUNDED_REL_ERR:
                raise AssertionError(f"{kernel} at {label}: {r['rounded_err']:.3g} from "
                                     f"attention_bwd_rounded > {fa.BWD_ROUNDED_REL_ERR}")
            worst_abs[kernel] = max(worst_abs[kernel], max(
                abs_err(a.float(), x.float()) for a, x in zip(got, rounded)))
            del rounded
            plain = fa.attention_bwd_rounded
        else:
            plain = fa.attention_bwd_plain
        r.update(ms=cuda_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout, True, lse),
                            5, 2),
                 plain_ms=cuda_ms(lambda: plain(q, k, v, out, dout, True), 2, 1),
                 library_ms=cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dl,
                                                                retain_graph=True), 5, 2),
                 bound_ms=bnd[0], bound_by=bnd[1])
        rows[kernel][label] = r
        log(f"[14 training] {kernel} at {label} {r['shape']}: "
            f"{'max |a - x| / max |x|' if not bf16 else 'relative norm'} {err:.3g} from float64 "
            f"autograd (limit {tol})"
            + (f", {r['rounded_err']:.3g} from attention_bwd_rounded" if 'rounded_err' in r
               else "")
            + f"; {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} by {r['bound_by']}, plain "
            f"{r['plain_ms']:.3f}, scaled_dot_product_attention backward (heads permuted, "
            f"group {group}) {r['library_ms']:.4f}")
        del q, k, v, dout, out, lse, ql, kl, vl, lib_out, dl, got
    replaces = "src/repro/nn/layers.py:97 (jax.grad of XLA attention, no Pallas kernel)"
    for kernel, by in rows.items():
        main = by.pop(next(iter(by)))
        report[kernel] = dict(replaces=replaces, max_abs_err=worst_abs[kernel],
                              main_path_launches=launches[kernel], other_shapes=by, **main)
    reset_peak()


def training_phase(dev, ops, sr, bag, fa, report, root: Path) -> dict:
    """Phase 14: training. (a) the flash backward sweep, (b) the gradient
    scatters, (c) granite-moe-1b-a400m at full width, (d) `main` end to end
    and resumed, (e) the other families; the counted launches of (c), (d)
    and (e) (launches of the kernels, (d)'s from its summary line) are returned."""
    t = [time.perf_counter()]
    worst_abs = sweep_flash_bwd(dev, np.random.default_rng(14), fa, ops)
    hold_scatters(dev, ops, sr, bag)
    t.append(time.perf_counter())
    launches = granite_moe_training(dev, ops)
    t.append(time.perf_counter())
    launches.update(main_resume(root))
    t.append(time.perf_counter())
    launches.update(family_training(dev, ops, sr, bag, fa))
    t.append(time.perf_counter())
    time_flash_bwd(dev, fa, report, worst_abs, launches)
    log(f"[14 training] launches {dict(launches)}; (a)+(b) {t[1] - t[0]:.1f} s, (c) "
        f"{t[2] - t[1]:.1f} s, (d) {t[3] - t[2]:.1f} s, (e) {t[4] - t[3]:.1f} s, timing "
        f"{time.perf_counter() - t[4]:.1f} s")
    return {k: launches[k] for k in TRAIN_KERNELS}


# ---------------------------------------------------------------------------
# phase 15: the distributed stack on meshes of this one card
# ---------------------------------------------------------------------------

#: (a) granite-3-8b at its published width, depth cut to DIST_LAYERS (the
#: card holds the pipeline's float32 gradients, ~8 GB at 8 layers, beside the
#: single-device reference's and the weights); DIST_MICRO micro-batches of
#: (1, DIST_SEQ) tokens: the registry's train_4k cell cut from B 256, S 4,096
DIST_ARCH, DIST_LAYERS, DIST_MICRO, DIST_SEQ = "granite-3-8b", 8, 4, 1024
#: (pipeline, (stages, TP ranks)) on meshes of cuda:0; (3, 1) pads 8 layers
#: to 9 with an identity layer
DIST_RUNS = (("pipeline_tp", (4, 1)), ("pipeline_tp", (2, 2)), ("pipeline_tp", (1, 2)),
             ("pipeline", (4, 1)), ("pipeline_tp", (3, 1)))
#: the loss within DIST_LOSS_ERR of the bf16 single-device step's
#: (tests/test_pipeline.py's loss tolerance; the float32 step's is logged). The gradients are bf16: two
#: bf16 computations of one step differ by their rounding (the bf16
#: single-device gradient is ~2 % in relative norm from the float32 one at a
#: d 512 cut on the CPU, and a TP = 2 pipeline as far again from it), so
#: tests/test_pipeline.py's 2 % of the largest entry between them is no
#: test of the wiring in bf16. Each pipeline gradient leaf is held instead
#: no further from the float32 single-device gradient than the bf16
#: single-device one is, times EXACT_RATIO in relative norm (1.00-1.07 times
#: on the CPU) and times DIST_MAX_RATIO in the largest |entry| of the
#: difference (a fault confined to a few rows, such as a vocab-shard
#: boundary off by one, barely moves a 200 M-entry leaf's norm); its largest
#: |pipeline - bf16 single device| over the largest entry is logged beside
DIST_LOSS_ERR, DIST_MAX_RATIO = 5e-3, 1.5
#: (b) granite-3-8b at full width and depth: B = DECODE_B against a
#: DECODE_SEQ-token cache (decode_32k cut from B 128), split over
#: DECODE_SHARDS 'model' shards; each layer's attention within
#: DECODE_ATTN_REL_ERR (relative norm) of the unsharded decode's on the same
#: inputs, the logits within LOGITS_REL_ERR
DECODE_B, DECODE_SEQ, DECODE_SHARDS, DECODE_ATTN_REL_ERR, DECODE_STEPS = 4, 32768, 4, 1e-2, 3
#: (c) gatedgcn on phase 12's full_graph_sm graph; each gradient leaf within
#: GNN_REL_ERR of its largest entry from the (1, 1) run
GNN_MESHES, GNN_REL_ERR = ((1, 4), (2, 2)), 1e-5
#: (d) top-k fraction of the compressed all-reduce, 4 'data' shards
TOPK_FRAC, ALLREDUCE_SHARDS = 0.01, 4
#: (e) phase 6's embedding_bag batch (max), the push Combine's shape at D = 1
#: and the union push's (E = 2n) at D = 64
MINMAX_BAG_B, MINMAX_D = 16_384, 64
DIST_KERNELS = ("flash_attention", "flash_attention_bwd_wgmma", "segment_reduce",
                "embedding_bag")
#: kept inputs a (kernel, shapes) key for the holds
DIST_KEEP = 2


def cuda_mesh(d: int, s: int):
    from repro_torch import mesh as M

    return M.make_mesh(d, s, devices=["cuda:0"] * (d * s))


def hold_dist_calls(sr, bag, fa, cap: Captured) -> None:
    """Each kept call against its plain version on its own inputs: the flash
    forward and `segment_reduce` by `hold_call`; the backward within
    BWD_ROUNDED_REL_ERR of `attention_bwd_rounded` (which rounds where the
    kernel does), no further from float64 autograd than BWD_BF16_REL_ERR or
    EXACT_RATIO times that model (a step's dout is not the sweep's N(0, 1)),
    and bit-equal on a repeat."""
    for key, calls in cap.calls.items():
        name, worst = key[0], 0.0
        for args in calls:
            if name != "flash_attention_bwd":
                worst = max(worst, hold_call(sr, bag, fa, name, args)[0])
                continue
            q, k, v, out, dout, causal, lse = args
            got = fa.flash_attention_bwd_cuda(*args)
            if not all(bit_equal(a, b) for a, b in zip(got, fa.flash_attention_bwd_cuda(*args))):
                raise AssertionError(f"the flash backward at {key[2:]} differs on a repeat")
            exact = exact_attention_grads(fa, q, k, v, dout, causal)
            rounded = fa.attention_bwd_rounded(q, k, v, out, dout, causal)
            e, r = bwd_err(fa, got, exact), rounded_err(got, rounded)
            e_model = bwd_err(fa, rounded, exact)
            if not (r <= fa.BWD_ROUNDED_REL_ERR
                    and e <= max(fa.BWD_BF16_REL_ERR, EXACT_RATIO * e_model)):
                raise AssertionError(f"the flash backward at {key[2:]}: {e:.3g} from float64 "
                                     f"(the rounded model {e_model:.3g}), {r:.3g} from "
                                     "attention_bwd_rounded")
            worst = max(worst, e)
        log(f"[15 distributed] held {len(calls)} of the {cap.count[key]} {name} calls in "
            f"{key[1]} at {[x[0] if isinstance(x, tuple) else x for x in key[2:]]} against "
            f"the plain version: worst {worst:.3g}")


def grad_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want| (a leaf's tolerance)."""
    w = want.float()
    return float((got.float() - w).abs().max() / w.abs().max().clamp_min(1e-30))


def single_step(tfm, T, cfg, params, toks, lbls):
    """(loss, gradient tree) of the single-device `loss_fn` + autograd over
    the micro-batches as one batch."""
    leaves = [t.detach().requires_grad_() for t in T.leaves(params)]
    loss = tfm.loss_fn(T.unflatten(params, leaves), toks.reshape(-1, toks.shape[-1]),
                       lbls.reshape(-1, lbls.shape[-1]), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), T.unflatten(params, grads)


def leaf_dists(grads, ref, n_layers: int) -> dict:
    """Each leaf's (relative norm, largest |entry|) of its difference from
    `ref` (the layer stacks' first n_layers: padding layers have no
    counterpart)."""
    def dist(a, b):
        b = b.float()
        d = a.float() - b
        return float(d.norm() / b.norm()), float(d.abs().max())

    out = {k: dist(grads["layers"][k][:n_layers], ref["layers"][k]) for k in ref["layers"]}
    out.update({k: dist(grads[k], ref[k]) for k in ("embed", "lm_head", "final_norm")})
    return out


def pipeline_runs(dev, ops, sr, bag, fa):
    """(a): the pipelines on meshes of cuda:0 against the single-device
    `loss_fn` + autograd, in bf16 (the loss, DIST_LOSS_ERR) and in float32
    (the gradients, EXACT_RATIO and DIST_MAX_RATIO). Returns
    (launches, the (4, 1) pipeline_tp run's gradient leaves, float32, a
    leaf a layer, as (path, leaf) pairs, for (d))."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.distributed import pipeline as pp
    from repro_torch.distributed import pipeline_tp as pptp
    from repro_torch.models import transformer as tfm

    fns = {"pipeline": pp.pipeline_loss_and_grads,
           "pipeline_tp": pptp.pipeline_tp_loss_and_grads}
    cfg = dataclasses.replace(configs.get(DIST_ARCH).make_config(), n_layers=DIST_LAYERS)
    reset_peak()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SEED), dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    toks, lbls = (torch.randint(0, cfg.vocab, (DIST_MICRO, 1, DIST_SEQ), device=dev,
                                generator=gen, dtype=torch.int32) for _ in range(2))
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref_loss, ref32 = single_step(tfm, T, cfg32, T.map_leaves(lambda t: t.float(), params),
                                  toks, lbls)
    loss16, ref16 = single_step(tfm, T, cfg, params, toks, lbls)
    base = leaf_dists(ref16, ref32, cfg.n_layers)
    torch.cuda.synchronize()
    log(f"[15 distributed] (a) {DIST_ARCH} at its published width (d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads, Dh {cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, remat {cfg.remat}), {DIST_LAYERS} layers, {DIST_MICRO} micros of "
        f"(1, {DIST_SEQ}): single-device loss {loss16:.5f} (float32 {ref_loss:.5f}); the bf16 "
        f"gradients' relative norm from the float32 ones {min(v[0] for v in base.values()):.3g}"
        f"..{max(v[0] for v in base.values()):.3g}, their largest |difference| "
        f"{min(v[1] for v in base.values()):.3g}..{max(v[1] for v in base.values()):.3g} "
        f"({time.perf_counter() - t0:.2f} s for both)")
    launches = collections.Counter()
    keep, first = None, None
    cap = Captured(sr, bag, fa, keep=DIST_KEEP, backward=True)
    for name, shape in DIST_RUNS + (DIST_RUNS[1],):
        repeat = first is not None and (name, shape) == DIST_RUNS[1]
        mesh = cuda_mesh(*shape)
        pc = pp.plan(cfg, shape[0], DIST_MICRO)
        pparams = dict(params, layers=pp.pad_layer_stack(params["layers"], cfg, pc))
        reset_peak()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        run = lambda: fns[name](pparams, toks, lbls, cfg, pc, mesh)
        loss, grads = (cap.run(f"{name} {shape}", run) if shape == (2, 2) and not repeat
                       else run())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = collections.Counter({k: v for k, v in ops.launch_counts().items() if v})
        peak = torch.cuda.max_memory_allocated() / 2**30
        if repeat:
            same = bit_equal(loss, first[0]) and all(
                bit_equal(a, b) for a, b in zip(T.leaves(grads), T.leaves(first[1])))
            log(f"[15 distributed] (a) {name} {shape} repeated: "
                f"{'bit-equal' if same else 'DIFFERS'} ({secs:.3f} s)")
            if not same:
                raise AssertionError(f"{name} {shape}: a repeat differs")
            del first
            continue
        launches.update(got)
        tp, lps = shape[1], pc.layers_per_stage
        fwd_ticks = (shape[0] - 1) + shape[0] * (2 if cfg.remat else 1)
        want = {"flash_attention": tp * DIST_MICRO * lps * fwd_ticks,
                "flash_attention_bwd_wgmma": tp * DIST_MICRO * pp.padded_layers(cfg, pc),
                "segment_reduce": (tp if name == "pipeline_tp" else 1) * DIST_MICRO}
        if dict(got) != want:
            raise AssertionError(f"{name} {shape}: launches {dict(got)}, expected {want}")
        dists = leaf_dists(grads, ref32, cfg.n_layers)
        ratio = {k: v[0] / base[k][0] for k, v in dists.items()}
        mratio = {k: v[1] / max(base[k][1], 1e-30) for k, v in dists.items()}
        worst, mworst = max(ratio, key=ratio.get), max(mratio, key=mratio.get)
        errs = [grad_err(grads["layers"][k][:cfg.n_layers], ref16["layers"][k])
                for k in ref16["layers"]]
        errs += [grad_err(grads[k], ref16[k]) for k in ("embed", "lm_head", "final_norm")]
        pad = max([float(g[cfg.n_layers:].abs().max()) for g in grads["layers"].values()
                   if g.shape[0] > cfg.n_layers] or [0.0])
        log(f"[15 distributed] (a) {name} on a {shape} mesh of cuda:0 "
            f"({pp.padded_layers(cfg, pc)} layers, {lps} a stage): {secs:.3f} s a step, peak "
            f"{peak:.2f} GiB, loss {float(loss):.5f} (single device {loss16:.5f}, float32 "
            f"{ref_loss:.5f}); "
            f"gradients at most {ratio[worst]:.3f} times as far from the float32 ones as the "
            f"bf16 single device's in relative norm ({worst}; limit {EXACT_RATIO}) and "
            f"{mratio[mworst]:.3f} times in the largest |entry| ({mworst}; limit "
            f"{DIST_MAX_RATIO}), largest |pipeline - bf16 "
            f"single device| {max(errs):.3g} of the largest entry; padding gradients max "
            f"{pad}; launches {dict(got)}")
        if not (abs(float(loss) - loss16) < DIST_LOSS_ERR and ratio[worst] <= EXACT_RATIO
                and mratio[mworst] <= DIST_MAX_RATIO and pad == 0.0):
            raise AssertionError(f"{name} {shape} disagrees with the single-device step")
        MEASURED[f"pipe_{name}_{shape[0]}x{shape[1]}"] = dict(
            s=secs, peak_gib=peak, loss=float(loss), worst_ratio=ratio[worst],
            worst_max_ratio=mratio[mworst], max_err_bf16=max(errs))
        if shape == (2, 2):
            first = (loss, grads)
        elif (name, shape) == DIST_RUNS[0]:
            keep = grads
        del grads, pparams
    del params, ref16, ref32
    hold_dist_calls(sr, bag, fa, cap)
    del cap
    reset_peak()
    # a leaf a layer, as `transformer.layer_stack` hands the stacks to the
    # model (views: the stack is not copied)
    return launches, [(path + (i,), g[i]) if path[0] == "layers" else (path, g)
                      for path, g in T.walk(keep) for i in range(
                          g.shape[0] if path[0] == "layers" else 1)]


def decode_run(dev, ops):
    """(b): granite-3-8b at full width and depth, split-KV decode on a
    (1, DECODE_SHARDS) mesh of cuda:0 against the unsharded decode, from a
    cache filled by a seeded generator with len = seq - 1 (no prefill)."""
    import functools

    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.nn import decode_attn
    from repro_torch.nn import layers as L

    cfg = configs.get(DIST_ARCH).make_config()
    reset_peak()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SEED), dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    cache = tfm.init_cache(cfg, DECODE_B, DECODE_SEQ, device=dev)
    for key in ("k", "v"):
        for layer in cache[key]:
            layer.copy_(torch.randn(layer.shape, device=dev, generator=gen))
    cache["len"] = DECODE_SEQ - 1
    tok = torch.randint(0, cfg.vocab, (DECODE_B, 1), device=dev, generator=gen,
                        dtype=torch.int32)
    mesh = cuda_mesh(1, DECODE_SHARDS)
    split = functools.partial(decode_attn.decode_attention_splitkv, mesh=mesh)
    errs = []

    def checked(q, k, v, valid):
        out = split(q, k, v, valid)
        errs.append(rel_err(out, L._decode_attention(q, k, v, valid)))
        return out

    with torch.no_grad():
        # each step returns a new cache (21.5 GB): keep only the logits
        with_split = tfm.decode_step(params, cache, tok, cfg, attn_override=checked)[0]
        plain = tfm.decode_step(params, cache, tok, cfg)[0]
        rel = rel_err(with_split, plain)
        times = {}
        for name, over in (("split-KV", split), ("unsharded", None)):
            runs = []
            for _ in range(DECODE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tfm.decode_step(params, cache, tok, cfg, attn_override=over)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            times[name] = min(runs) * 1e3
        ops.reset_launches()
        tfm.decode_step(params, cache, tok, cfg, attn_override=split)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[15 distributed] (b) {DIST_ARCH} ({cfg.n_layers} layers, bf16) decode, B={DECODE_B} "
        f"against a {DECODE_SEQ}-token cache (len {DECODE_SEQ - 1}), split over "
        f"{DECODE_SHARDS} 'model' shards of cuda:0: {len(errs)} layers' attention within "
        f"{max(errs):.3g} (relative norm, limit {DECODE_ATTN_REL_ERR}) of the unsharded "
        f"decode's, logits within {rel:.3g} (limit {LOGITS_REL_ERR}); "
        f"{times['split-KV']:.2f} ms a step (a token for each of B={DECODE_B} sequences) "
        f"split-KV, {times['unsharded']:.2f} unsharded (best of {DECODE_STEPS}); peak {peak:.2f} GiB; kernel launches "
        f"{ {k: v for k, v in ops.launch_counts().items() if v} }")
    if len(errs) != cfg.n_layers or max(errs) > DECODE_ATTN_REL_ERR or rel > LOGITS_REL_ERR:
        raise AssertionError("split-KV decode disagrees with the unsharded decode")
    MEASURED["decode_splitkv"] = dict(split_ms=times["split-KV"], plain_ms=times["unsharded"],
                                      worst_attn=max(errs), logits=rel, peak_gib=peak)
    del params, cache, with_split, plain
    reset_peak()


def gnn_runs(dev, ops) -> collections.Counter:
    """(c): the edge-sharded GatedGCN at phase 12's width and graph on meshes
    of cuda:0 against the (1, 1) run; a repeat bit-equal."""
    from repro_torch import tree as T
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.models import gnn

    # phase 12's gatedgcn cell: the same graph, width and weights (seed 21)
    _, params, (feats, src, dst, w, cfg, _, _), n_edges, _ = graph_inputs(
        dev, "gatedgcn", GNN_SHAPES["full_graph_sm"], 21)
    n = feats.shape[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    labels = torch.randint(0, cfg.n_classes, (n,), device=dev, generator=gen)
    mask = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
    pad = -n_edges % 4
    fill = lambda t, v: torch.cat([t, torch.full((pad,), v, dtype=t.dtype, device=dev)])
    src, dst, w = fill(src, n), fill(dst, n), fill(w, 0.0)
    leaves = T.leaves(params)
    for p in leaves:
        p.requires_grad_()

    def run(shape_):
        loss = gnn.make_edgesharded_gatedgcn(cfg, cuda_mesh(*shape_), n)(
            params, feats, src, dst, w, labels, mask)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    base = run((1, 1))
    launches = collections.Counter()
    for shape_ in GNN_MESHES:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, grads = run(shape_)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = collections.Counter({k: v for k, v in ops.launch_counts().items() if v})
        launches.update(got)
        worst = max(grad_err(a, b) for a, b in zip(grads, base[1]))
        rel = abs(float(loss) - float(base[0])) / abs(float(base[0]))
        again = run(shape_)
        same = bit_equal(loss, again[0]) and all(bit_equal(a, b) for a, b in zip(grads, again[1]))
        log(f"[15 distributed] (c) edge-sharded gatedgcn ({cfg.n_layers} layers, d "
            f"{cfg.d_hidden}, d_in {cfg.d_in}; {n} nodes, {n_edges} edges padded by {pad}) on a "
            f"{shape_} mesh of cuda:0: loss {float(loss):.6f} ({rel:.3g} from the (1, 1) run), "
            f"gradients within {worst:.3g} of their largest entry (limit {GNN_REL_ERR}), "
            f"repeat {'bit-equal' if same else 'DIFFERS'}; {secs:.3f} s for loss and gradients; "
            f"launches {dict(got)}")
        if not (rel <= GNN_REL_ERR and worst <= GNN_REL_ERR and same):
            raise AssertionError(f"edge-sharded gatedgcn on {shape_} disagrees")
        if not got["segment_reduce"]:
            raise AssertionError("the edge-sharded gatedgcn launched no segment_reduce")
    return launches


def fold_check(red: torch.Tensor, parts: list, what: str, host: int = 1 << 22) -> float:
    """`red` (float32) against the float64 fold of `parts`, within
    3 * 2^-24 * sum |part| an entry (three float32 adds): every entry folded
    in float64 on the card, and the first `host` entries also folded on the
    host. Returns the largest share of that bound."""
    worst = 0.0
    flat = red.reshape(-1)
    step = 1 << 26
    chunks = [(lo, min(lo + step, flat.numel()), red.device) for lo in range(0, flat.numel(), step)]
    chunks.append((0, min(host, flat.numel()), torch.device("cpu")))
    for lo, hi, where in chunks:
        exact = torch.zeros(hi - lo, dtype=torch.float64, device=where)
        mass = torch.zeros_like(exact)
        for p in parts:
            x = p.reshape(-1)[lo:hi].to(where).double()
            exact += x
            mass += x.abs()
        off = (flat[lo:hi].to(where).double() - exact).abs()
        bound = 3 * 2.0 ** -24 * mass
        if bool((off > bound).any()):
            raise AssertionError(f"{what}: {float((off - bound).max()):.3g} beyond the bound "
                                 f"({where} fold)")
        worst = max(worst, float((off / bound.clamp_min(1e-300)).max()))
    return worst


def check_topk(idx, sel, new_res, want, k: int, what: str) -> None:
    """A top-k shard's selection, with no reference: k distinct entries,
    none left in `new_res` larger in magnitude than the least one sent, and
    the entries tied at that magnitude taken lowest index first (the set
    `jax.lax.top_k` picks)."""
    taken = torch.zeros(want.numel(), dtype=torch.bool, device=want.device)
    taken[idx] = True
    if idx.numel() != k or int(taken.sum()) != k:
        raise AssertionError(f"top-k {what}: {idx.numel()} indices, "
                             f"{int(taken.sum())} distinct, for k = {k}")
    thr = sel.abs().min()
    if not bool(new_res.abs().max() <= thr):
        raise AssertionError(f"top-k {what}: an entry left behind is larger than "
                             f"the least one sent ({float(thr):.3g})")
    tied = want.reshape(-1).abs() == thr
    t_in, t_out = torch.nonzero(tied & taken), torch.nonzero(tied & ~taken)
    if t_in.numel() and t_out.numel() and not bool(t_in.max() < t_out.min()):
        raise AssertionError(f"top-k {what}: ties at {float(thr):.3g} not taken lowest "
                             "index first")


def allreduce_runs(dev, ops, leaves: list) -> collections.Counter:
    """(d): bf16 and top-k compressed all-reduce over ALLREDUCE_SHARDS 'data'
    shards of (a)'s gradient tree, a leaf at a time (`leaves`, (path, leaf)
    pairs, a leaf a layer, emptied as it goes; k is k_frac of a leaf): shard d's partial is the leaf times c_d, its
    residual a shifted copy times 2^-8; the reduced leaf against the
    float64 fold of what the shards sent (`fold_check`), each shard's
    send plus its new residual equal to gradient plus residual bit for
    bit, and each top-k shard's selection checked (`check_topk`)."""
    from repro_torch.distributed import collectives as C

    mesh = cuda_mesh(ALLREDUCE_SHARDS, 1)
    scale = (1.0, 0.5, -0.25, 2.0)
    launches = collections.Counter()
    worst = {"bf16": 0.0, "topk": 0.0}
    secs = {"bf16": 0.0, "topk": 0.0}
    n_el, n_leaves = 0, len(leaves)
    while leaves:
        path, g = leaves.pop(0)
        n_el += g.numel()
        for method in ("bf16", "topk"):
            torch.cuda.empty_cache()         # earlier phases leave the cache fragmented
            parts = [g * c for c in scale]
            res = [torch.roll(g, d + 1).mul_(2.0 ** -8) for d in range(ALLREDUCE_SHARDS)]
            apply = C.make_compressed_allreduce(mesh, "data", method, k_frac=TOPK_FRAC)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            red, new_res = apply([{"g": p} for p in parts], [{"g": r} for r in res])
            torch.cuda.synchronize()
            secs[method] += time.perf_counter() - t0
            launches.update({k: v for k, v in ops.launch_counts().items() if v})
            if not all(r["g"] is red[0]["g"] or bit_equal(r["g"], red[0]["g"]) for r in red):
                raise AssertionError(f"{method} {path}: the shards' sums differ")
            red = red[0]["g"]
            sent = []
            for d in range(ALLREDUCE_SHARDS):
                p, r, nr = parts[d], res[d], new_res[d]["g"]
                if method == "bf16":
                    s, _ = C.compress_bf16(p, r)
                else:
                    k = max(1, int(p.numel() * TOPK_FRAC))
                    idx, sel, _ = C.compress_topk(p, r, k)
                    check_topk(idx, sel, nr, p.float() + r, k, f"{path} shard {d}")
                    s = torch.zeros(p.numel(), device=dev).index_put_((idx,), sel).reshape(p.shape)
                if not bit_equal(s + nr, p.float() + r):
                    raise AssertionError(f"{method} {path}: sent + new residual != want")
                sent.append(s)
                parts[d] = res[d] = new_res[d] = None      # this shard is checked
                del p, r, nr, s
            worst[method] = max(worst[method], fold_check(red, sent, f"{method} {path}"))
            del red, new_res, sent, parts, res
        del g
    log(f"[15 distributed] (d) compressed all-reduce over {ALLREDUCE_SHARDS} 'data' shards of "
        f"cuda:0, (a)'s gradient tree ({n_leaves} leaves, {n_el} float32 entries): bf16 "
        f"{secs['bf16']:.3f} s, top-k (k_frac {TOPK_FRAC}) {secs['topk']:.3f} s; within "
        f"{worst['bf16']:.3g} and {worst['topk']:.3g} of the float32 bound from the float64 "
        f"fold (every entry on the card, the first 2^22 of each leaf on the host too); every "
        f"shard's send + new residual == gradient + residual bit for bit; every top-k shard "
        f"sent k distinct entries, none left behind larger, ties lowest index first; launches "
        f"{dict(launches)}")
    return launches


def minmax_runs(dev, ops, sr, bag, push_ids: torch.Tensor) -> collections.Counter:
    """(e): the min/max backwards at phase 6's embedding_bag (max) and the
    push Combine's segment_reduce shapes (D = 1 at E = m, D = 64 at
    E = 2n), values drawn from a few integers so that ties abound; each
    gradient bit-equal to the kernels' fold-order plain route on the card
    and on a repeat, and each segment's (bag's) shares summing back to its
    cotangent."""
    gen = torch.Generator(device=dev).manual_seed(18)
    sid = push_ids.to(dev)
    m = sid.numel()
    n = int(sid[-1]) + 1

    def plain_route(fn):
        """fn() with the CUDA wrappers swapped for the kernels' fold orders."""
        return with_ops(sr, {"segment_reduce_cuda": sr.segment_reduce_ordered},
                        lambda: with_ops(bag, {"embedding_bag_cuda": bag.embedding_bag_ordered},
                                         fn))

    launches = collections.Counter()
    cases = []
    sample = torch.sort(sid[torch.randperm(m, device=dev, generator=gen)[:2 * n]]).values
    for d, ids in ((1, sid), (MINMAX_D, sample)):
        shape = (ids.numel(),) if d == 1 else (ids.numel(), d)
        vals = torch.randint(0, 8, shape, device=dev, generator=gen).float()
        cot = torch.randn((n,) + shape[1:], device=dev, generator=gen)
        for comb in ("min", "max"):
            cases.append((f"segment_reduce {comb} E={ids.numel()} D={d} num={n}", comb, vals,
                          ids, cot))
    for what, comb, vals, ids, cot in cases:
        def grad():
            v = vals.detach().requires_grad_()
            out = ops.segment_reduce(v, ids, n, comb)
            return torch.autograd.grad(out, v, cot)[0]
        grad()                                      # warm: the allocator's first growth
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        g = grad()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches.update({k: v for k, v in ops.launch_counts().items() if v})
        back = sr.segment_reduce_plain(g.double(), ids, n, "sum")
        hit = sr.segment_reduce_plain(torch.ones_like(ids, dtype=torch.float64), ids, n) > 0
        hit = hit.reshape((n,) + (1,) * (cot.dim() - 1))
        off = float(torch.where(hit, (back - cot.double()).abs() / cot.double().abs().clamp_min(
            1e-30), 0.0).max())
        same = bit_equal(g, plain_route(grad)) and bit_equal(g, grad())
        log(f"[15 distributed] (e) backward of {what}: {ms:.2f} ms, bit-equal to the "
            f"fold-order plain route and on a repeat: {same}; shares sum back to the "
            f"cotangent within {off:.3g} (relative)")
        if not same or off > 1e-6:
            raise AssertionError(f"the backward of {what} fails its checks")
    fields, per_field, dim = 39, 100_000, 10
    table = torch.randint(0, 4, (fields * per_field, dim), device=dev, generator=gen).float()
    idx = (torch.arange(fields, device=dev, dtype=torch.int32) * per_field
           + torch.randint(0, per_field, (MINMAX_BAG_B, fields), device=dev, generator=gen,
                           dtype=torch.int32))
    cot = torch.randn(MINMAX_BAG_B, dim, device=dev, generator=gen)

    def bag_grad():
        t = table.detach().requires_grad_()
        return torch.autograd.grad(ops.embedding_bag(t, idx, "max"), t, cot)[0]

    torch.cuda.synchronize()
    ops.reset_launches()
    g = bag_grad()
    torch.cuda.synchronize()
    launches.update({k: v for k, v in ops.launch_counts().items() if v})
    same = bit_equal(g, plain_route(bag_grad)) and bit_equal(g, bag_grad())
    shares = g[idx.long()]                                  # (B, K, D): rows named once a bag
    total = float(g.double().sum()) - float(cot.double().sum())
    log(f"[15 distributed] (e) backward of embedding_bag max, table {tuple(table.shape)}, "
        f"B={MINMAX_BAG_B} K={fields}: bit-equal to the fold-order plain route and on a "
        f"repeat: {same}; the gradient's total minus the cotangent's {total:.3g}; shares "
        f"nonzero {int((shares != 0).sum())} of {shares.numel()}")
    if not same or abs(total) > 1e-6 * float(cot.abs().sum()):
        raise AssertionError("the backward of embedding_bag max fails its checks")
    return launches


def distributed_phase(dev, ops, sr, bag, fa, push_ids) -> dict:
    """Phase 15: the distributed stack on meshes of cuda:0: (b) split-KV
    decode (the largest blocks: two 10 GiB caches), (e) the min/max
    backwards, (c) the edge-sharded GatedGCN, (a) the pipelines, (d) the
    compressed all-reduce over (a)'s gradients. Returns the counted launches
    of the kernels of DIST_KERNELS. It runs right after phase 4, on its
    graph: run after phase 14, the caching allocator held 35-60 GiB reserved
    but free in segments it could not release, and (d), then (b), failed to
    allocate. The allocator takes expandable segments for the phase, and
    the cuBLAS workspaces are freed first."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:        # a stream's cuBLAS workspace pins its segment
            clear()
        reset_peak()
        stats = torch.cuda.memory_stats()
        log(f"[15 distributed] at the start: {stats.get('allocated_bytes.all.current', 0) / 2**30:.2f} "
            f"GiB allocated, {stats.get('reserved_bytes.all.current', 0) / 2**30:.2f} GiB "
            f"reserved, {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free on the card")
        t = [time.perf_counter()]
        decode_run(dev, ops)
        t.append(time.perf_counter())
        launches = minmax_runs(dev, ops, sr, bag, push_ids)
        t.append(time.perf_counter())
        launches.update(gnn_runs(dev, ops))
        t.append(time.perf_counter())
        got, grads = pipeline_runs(dev, ops, sr, bag, fa)
        launches.update(got)
        t.append(time.perf_counter())
        launches.update(allreduce_runs(dev, ops, grads))
        reset_peak()
        t.append(time.perf_counter())
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    for name in DIST_KERNELS:
        if not launches[name]:
            raise AssertionError(f"phase 15 launched no {name}: {dict(launches)}")
    log(f"[15 distributed] launches {dict(launches)}; (b) {t[1] - t[0]:.1f} s, (e) "
        f"{t[2] - t[1]:.1f} s, (c) {t[3] - t[2]:.1f} s, (a) {t[4] - t[3]:.1f} s, (d) "
        f"{t[5] - t[4]:.1f} s")
    return {k: launches[k] for k in DIST_KERNELS}

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22, help="RMAT scale of the main path")
    ap.add_argument("--grid", type=int, default=1024, help="grid2d side of phase 5")
    ap.add_argument("--quick", action="store_true", help="stop after phase 3")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one kernel-pull run of each main-path program, "
                         "one warm pump round of the serving phase and one decode step "
                         "of each LM of the models phase")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import algorithms as A
    from repro_torch.core import engine as E
    from repro_torch.graph import generators as G
    from repro_torch.graph import pack_ell
    from repro_torch.graph.csr import from_edges
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ell_spmv as ell
    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import frontier_pack as fp
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch import obs
    from repro_torch import serving as S
    from repro_torch.core import baselines as Bl
    from repro_torch.nn import layers as L
    from repro_torch.serving import batch_engine as BE

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1 card] {card}")
    log(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        rep = _build.ptxas_report(name)
        regs = [int(x.split("registers")[0].split()[-1]) for x in rep.splitlines()
                if "registers" in x and "Used" in x]
        spills = [x.strip() for x in rep.splitlines()
                  if "spill" in x and not x.strip().startswith("0 bytes spill")
                  and " 0 bytes spill stores, 0 bytes spill loads" not in x]
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", rep)]
        log(f"[2 build] {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, max {max(smem, default=0)} bytes of static shared memory, "
            f"spill lines {len(spills)}")
    log(f"[2 build] nvcc build {time.perf_counter() - t0:.1f} s")
    def sass_of(source: str) -> str:
        return subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(_build._lib_path(source))],
            capture_output=True, text=True, check=True, timeout=120).stdout

    sass = sass_of(_build.KERNELS[fa.TENSOR_CORES])
    found = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[2 build] {_build.KERNELS[fa.TENSOR_CORES]} SASS: {found}")
    if not all(found.values()):
        raise AssertionError(f"the tensor-core flash kernel lacks wgmma or TMA loads: {found}")
    for source in ("ell_combine", "ell_spmm"):
        sass = sass_of(source)
        wide = sass.count("LDG.E.128")
        narrow = len(re.findall(r"LDG\.E(?:\.CONSTANT)?\s", sass))
        log(f"[2 build] {source} SASS: LDG.E.128 {wide}, 32-bit LDG.E {narrow}")
        if not wide:
            raise AssertionError(f"{source} has no 128-bit global loads (LDG.E.128)")
    sass = sass_of(_build.KERNELS[fa.TF32])
    tf32 = collections.Counter(re.findall(r"HMMA\.\S*TF32\S*", sass))
    log(f"[2 build] {_build.KERNELS[fa.TF32]} SASS: {dict(tf32)}")
    if not tf32:
        raise AssertionError("the TF32 flash kernel has no TF32 tensor-core instructions")
    bwd_src = _build.KERNELS[fa.BACKWARD_WGMMA]
    sass = sass_of(bwd_src)
    found = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "USETMAXREG")}
    log(f"[2 build] {bwd_src} SASS: {found}")
    if not (found["HGMMA"] and found["UTMALDG"]):
        raise AssertionError(f"the wgmma flash backward lacks wgmma or TMA loads: {found}")
    # every instance: dkdv_kernel<DP, causal>, dq_kernel<DP, causal>, delta_kernel
    # (dkdv's count is at entry: setmaxnreg then gives its consumers 240)
    per = []
    for name, spill, regs in ptxas_instances(_build.ptxas_report(bwd_src)):
        m = re.search(r"(dkdv_kernel|dq_kernel|delta_kernel)(?:ILi(\d+)ELb(\d)E)?", name)
        what = m.group(1) + (f"<{m.group(2)}, {'causal' if m.group(3) == '1' else 'full'}>"
                             if m.group(2) else "")
        per.append(f"{what} {regs} registers, {spill} spill bytes")
    log(f"[2 build] {bwd_src}: {'; '.join(per)}")
    # the TF32 backward: mma.sync in TF32, and no spill in the instances the
    # main path runs (float32, Dh 64, causal: (d)'s 100m layer, granite-moe's)
    tf32_bwd = _build.KERNELS[fa.BACKWARD]
    sass = sass_of(tf32_bwd)
    hmma = collections.Counter(re.findall(r"HMMA\.\S*TF32\S*", sass))
    atomics = re.findall(r"\b(?:RED|ATOM)\S*\.F32", sass)
    log(f"[2 build] {tf32_bwd} SASS: {dict(hmma)}, float atomics {len(atomics)}")
    if not hmma or atomics:
        raise AssertionError("the TF32 flash backward needs TF32 tensor-core instructions "
                             "and no float atomics")
    per, on_path, spilled = [], [], []
    for name, spill, regs in ptxas_instances(_build.ptxas_report(tf32_bwd)):
        m = re.search(r"(dkdv_kernel|dq_kernel|prep_kernel)I(f|13__nv_bfloat16)"
                      r"(?:Li(\d+)ELb(\d)E)?", name)
        what = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}"
                + (f", {m.group(3)}, {'causal' if m.group(4) == '1' else 'full'}"
                   if m.group(3) else "") + ">")
        per.append(f"{what} {regs} registers, {spill} spill bytes")
        if m.group(2) == "f" and m.group(3) == "64" and m.group(4) == "1":
            on_path.append(what)
            if spill:
                spilled.append(what)
    log(f"[2 build] {tf32_bwd}: {'; '.join(per)}")
    if len(on_path) != 2 or spilled:
        raise AssertionError(f"the TF32 backward's main-path instances {on_path}: "
                             f"spilled {spilled}")
    # registers and spills of every instance; the main path's by name:
    # flash_kernel<float, DP = 128, causal, cp.async>; spmm_kernel<float, V, L, C>
    # at D = 64 (V = 4, L = 16, C = 1) and D = 70 (V = 2, L = 16, C = 3)
    # ell_combine_batched at Q = 64: column_lanes<C, K, V = 4, MAX_UP> with
    # MAX_UP = 4 on the 256-wide slices and 2 on the others; at Q = 8:
    # slot_lanes<C, K, V = 4, NS> with NS = 8 on the 256-wide slices and 1 on
    # the others; for copy/sum (ppr), add_w/min (sssp), hop/min (bfs) and
    # mul_w/sum
    batched = [("ell_combine_batched", f"{kind}ILi{c}ELi{k}ELi4ELi{t}E")
               for c, k in ((2, 2), (1, 0), (0, 0), (3, 2))
               for kind, t in (("column_lanes", 4), ("column_lanes", 2), ("slot_lanes", 8),
                               ("slot_lanes", 1))]
    for source, main in [(_build.KERNELS[fa.TF32], "flash_kernelIfLi128ELb1ELb1E"),
                         ("ell_spmm", "spmm_kernelIfLi4ELi16ELi1E"),
                         ("ell_spmm", "spmm_kernelIfLi2ELi16ELi3E")] + batched:
        per = ptxas_instances(_build.ptxas_report(source))
        regs = sorted({x[2] for x in per})
        spill = sum(x[1] for x in per)
        on_path = [f"{x[2]} registers, {x[1]} spill bytes" for x in per if main in x[0]]
        log(f"[2 build] {source}: {len(per)} instances, registers {regs[:1] + regs[-1:]} "
            f"(least, most), spill bytes {spill}; main path's {main}: {on_path}")

    rng = np.random.default_rng(0)
    rounded = {}
    err = {"ell_combine": sweep_ell(dev, rng, ell),
           "ell_combine_batched": sweep_batched(dev, rng, ell),
           "ell_combine_overlay": sweep_overlay(dev, rng, ell),
           "frontier_pack": sweep_pack(dev, rng, fp),
           "segment_reduce": sweep_segment(dev, rng, sr),
           "ell_spmm": sweep_spmm(dev, rng, ell),
           "embedding_bag": sweep_bag(dev, rng, bag),
           **sweep_flash(dev, rng, fa, ops, rounded)}
    log(f"[3 kernels] sweeps passed; max abs err vs plain (float32) {err}")
    if args.quick:
        return 0

    # -- phase 4: the main path ------------------------------------------------
    t0 = time.perf_counter()
    src, dst, w = G.rmat_edges(args.scale, 16, 0.57, 0.19, 0.19, seed=1)
    t_draw = time.perf_counter() - t0
    g = from_edges(src, dst, 1 << args.scale, w, directed=False, device=dev)
    del src, dst, w
    pack = pack_ell(g.inc)
    torch.cuda.synchronize()
    n, m = g.n_nodes, g.n_edges
    log(f"[4 main] RMAT scale {args.scale}: n={n} m={m} slices="
        f"{[tuple(s.nbr.shape) for s in pack.slices]}; host draws {t_draw:.1f} s, "
        f"total build {time.perf_counter() - t0:.1f} s")

    # kernel times at the main path's shapes (these launches are not counted)
    report = {}
    vals = torch.rand(n + 1, device=dev) * 64
    slots = sum(s.nbr.numel() for s in pack.slices)
    rows = sum(s.rows for s in pack.slices)
    real = sum(int((s.nbr != n).sum()) for s in pack.slices)
    e_err, per_slice = 0.0, []
    for s in pack.slices:
        r_, w_ = s.nbr.shape
        if not ell.vector_layout(w_, s.nbr.data_ptr(), s.wgt.data_ptr()):
            raise AssertionError(f"the ({r_}, {w_}) slice does not take the 16-byte variant")
        for op in ell.COMPUTE_OPS:
            for comb in ell.COMBINE_OPS:
                a = ell.ell_combine_cuda(s.nbr, s.wgt, vals, op, comb)
                if not bit_equal(a, ell.ell_combine_plain(s.nbr, s.wgt, vals, op, comb)):
                    raise AssertionError(f"ell_combine {op}/{comb} differs on the ({r_}, {w_}) slice")
        b = ell.ell_combine_plain(s.nbr, s.wgt, vals, "add_w", "min")
        e_err = max(e_err, abs_err(ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min"), b))
        rl = int((s.nbr != n).sum())
        b_all = bound_ms(s.nbr.numel() * 8 + (n + 1) * 4 + r_ * 4, 2 * s.nbr.numel())
        b_real = bound_ms(s.nbr.numel() * 4 + rl * 4 + (n + 1) * 4 + r_ * 4, 2 * rl)
        per_slice.append(dict(
            shape=[r_, w_], real_slots=rl,
            ms=cuda_ms(lambda s=s: ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min"), 10),
            bound_ms=b_real[0], bound_all_slots_ms=b_all[0]))
        log(f"[4 main] ell_combine slice ({r_}, {w_}), {rl} real slots: "
            f"{per_slice[-1]['ms']:.4f} ms (bound {b_real[0]:.4f} without padding weights, "
            f"{b_all[0]:.4f} for all slots); 12 op pairs bit-equal to the plain version")
    ell_k = lambda: [ell.ell_combine_cuda(s.nbr, s.wgt, vals, "add_w", "min") for s in pack.slices]
    ell_p = lambda: [ell.ell_combine_plain(s.nbr, s.wgt, vals, "add_w", "min") for s in pack.slices]
    bnd = bound_ms(slots * 4 + real * 4 + (n + 1) * 4 + rows * 4, real * 2)
    report["ell_combine"] = dict(
        replaces="src/repro/kernels/ell_spmv.py:62",
        shape=f"{len(pack.slices)} RMAT ELL slices, {slots} slots ({real} real), add_w/min",
        max_abs_err=max(e_err, err["ell_combine"]), ms=cuda_ms(ell_k, 10),
        plain_ms=cuda_ms(ell_p, 3, 1), bound_ms=bnd[0], bound_by=bnd[1],
        bound_all_slots_ms=bound_ms(slots * 8 + (n + 1) * 4 + rows * 4, slots * 2)[0],
        slices=per_slice)
    csrs = slice_csrs(pack.slices, n, dev)
    report["ell_combine"].update(library_copy_sum(ell, pack.slices, vals, csrs))
    del csrs
    r = report["ell_combine"]
    log(f"[4 main] ell_combine copy/sum {r['copy_sum_ms']:.4f} ms (bound "
        f"{r['copy_sum_bound_ms']:.4f}) against torch.sparse.mm {r['library_copy_sum_ms']:.4f} ms (max "
        f"|kernel - sparse.mm| {r['library_max_abs_diff']:.3g})")

    mask = torch.rand(n, device=dev) < 0.5
    pk = lambda: fp.frontier_pack_cuda(mask, n)
    pp = lambda: fp.frontier_pack_plain(mask, n)
    if not all(bit_equal(x, y) for x, y in zip(pk(), pp())):
        raise AssertionError("frontier_pack differs at the main path's shape")
    bnd = bound_ms(n + n * 4 + 5, n * 2)
    lib = lambda: torch.nonzero_static(mask, size=n, fill_value=n)   # int64 ids, no count
    lib_loop = lambda: torch.nonzero(mask)                           # waits for its count
    if not torch.equal(pk()[0].long(), lib()[:, 0]):
        raise AssertionError("frontier_pack and torch.nonzero_static disagree")
    report["frontier_pack"] = dict(
        replaces="src/repro/kernels/frontier_pack.py:25",
        max_abs_err=err["frontier_pack"], ms=graph_ms(pk), plain_ms=cuda_ms(pp, 5),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=graph_ms(lib),
        wrapper_loop_ms=cuda_ms(pk, 50, 5, 7), library_loop_ms=cuda_ms(lib_loop, 50, 5, 7),
        host_us=host_us(pk), library_host_us=host_us(lib_loop))
    r = report["frontier_pack"]
    log(f"[4 main] frontier_pack n={n} density 0.5: card {r['ms']:.4f} ms against "
        f"torch.nonzero_static's {r['library_ms']:.4f} ms (both CUDA graphs); through the "
        f"Python function {r['wrapper_loop_ms']:.4f} ms a call with {r['host_us']:.1f} us of "
        f"host enqueue, torch.nonzero {r['library_loop_ms']:.4f} ms a call with "
        f"{r['library_host_us']:.1f} us")

    # segment_reduce: the push Combine's shape (E = m, num = n) ...
    sid = torch.sort(g.out.col_idx).values
    sv = torch.rand(m, device=dev)
    s_err = check_segment(sr, sv, sid, n, "at the push shape")
    sid64 = sid.long()
    lib_out = torch.zeros(n, device=dev)
    bnd = bound_ms(m * 8 + n * 4, m)
    report["segment_reduce"] = dict(
        replaces="src/repro/kernels/segment_reduce.py:20",
        shape=f"push Combine: E={m} sorted ids, num={n}, sum",
        max_abs_err=max(err["segment_reduce"], s_err),
        ms=cuda_ms(lambda: sr.segment_reduce_cuda(sv, sid, n, "sum")),
        plain_ms=cuda_ms(lambda: sr.segment_reduce_plain(sv, sid, n, "sum"), 5),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(lambda: lib_out.index_add_(0, sid64, sv), 5),
        library_min_ms=cuda_ms(lambda: lib_out.scatter_reduce_(0, sid64, sv, "amin"), 5))
    del sid, sv, sid64, lib_out
    # ... and each pull merge's (E = the slice's rows, num = n + 1)
    merges = []
    lib_out = torch.zeros(n + 1, device=dev)
    for s in pack.slices:
        part = torch.rand(s.rows, device=dev)
        what = f"at the merge shape E={s.rows}"
        s_err = max(s_err, check_segment(sr, part, s.row_id, n + 1, what))
        rid64 = s.row_id.long()
        bnd = bound_ms(s.rows * 8 + (n + 1) * 4, s.rows)
        merges.append(dict(
            rows=s.rows, ms=graph_ms(lambda: sr.segment_reduce_cuda(part, s.row_id, n + 1, "sum")),
            plain_ms=cuda_ms(lambda: sr.segment_reduce_plain(part, s.row_id, n + 1, "sum"), 5),
            bound_ms=bnd[0],
            library_ms=graph_ms(lambda: lib_out.index_add_(0, rid64, part)),
            library_min_ms=graph_ms(lambda: lib_out.scatter_reduce_(0, rid64, part, "amin")),
            loop_ms=cuda_ms(lambda: sr.segment_reduce_cuda(part, s.row_id, n + 1, "sum"), 50, 5, 7)))
        r = merges[-1]
        log(f"[4 main] segment_reduce merge E={s.rows} num={n + 1}: card {r['ms']:.4f} ms "
            f"(CUDA graph; {r['loop_ms']:.4f} through Python), bound {r['bound_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, index_add_ {r['library_ms']:.4f}, scatter_reduce_ amin "
            f"{r['library_min_ms']:.4f}; bit-equal to segment_reduce_ordered")
    report["segment_reduce"].update(merges=merges, max_abs_err=max(
        report["segment_reduce"]["max_abs_err"], s_err))
    del lib_out, part, rid64, vals, mask
    for k, r in report.items():
        log(f"[4 main] {k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")

    progs = [("bfs", A.bfs(0)), ("sssp", A.sssp(0)), ("wcc", A.wcc()),
             ("pagerank", A.pagerank()), ("kcore", A.kcore(16))]
    cfg_k = E.EngineConfig(frontier_cap=n, edge_cap=m, pull_impl="kernel", fusion="all")
    cfg_t = dataclasses.replace(cfg_k, pull_impl="torch")
    for _, p in progs:                       # warm-up (allocator, first launches)
        E.run(p, g, pack, cfg_k)
    torch.cuda.synchronize()

    ops.reset_launches()
    results = {}
    for name, p in progs:
        results[name] = timed_run(E, p, g, pack, cfg_k)
    launches = ops.launch_counts()
    log(f"[4 main] launches on the main path: {launches}")
    pushes = sum(int(results[k][1]["push_iters"]) for k in results)
    pulls = sum(int(results[k][1]["pull_iters"]) for k in results)
    if launches["segment_reduce"] != pushes + len(pack.slices) * pulls:
        raise AssertionError(f"segment_reduce launched {launches['segment_reduce']} times for "
                             f"{pushes} pushes and {pulls} pulls")
    report["segment_reduce"].update(launches_push=pushes,
                                    launches_merge=len(pack.slices) * pulls)

    for name, p in progs:
        mk, sk_, tk = results[name]
        mt, st_, tt = timed_run(E, p, g, pack, cfg_t)
        same_run(name, mk, sk_, mt, st_)
        log(f"[4 main] {name}: kernel pull {tk:.3f} s, torch pull {tt:.3f} s, "
            f"iterations {int(sk_['iterations'])} (push {int(sk_['push_iters'])}, "
            f"pull {int(sk_['pull_iters'])}, switches {int(sk_['switches'])}); "
            "bit-equal to the torch pull")
    t0 = time.perf_counter()
    check_dist("bfs", results["bfs"][0]["dist"], scipy_dist(g, True), ell.BIG)
    check_dist("sssp", results["sssp"][0]["dist"], scipy_dist(g, False), ell.BIG)
    log(f"[4 main] bfs and sssp equal scipy's distances ({time.perf_counter() - t0:.1f} s)")
    del results
    if args.profile:
        profile_runs(E, progs, g, pack, cfg_k)
    torch.cuda.empty_cache()

    # -- phase 15: the distributed stack, run here on phase 4's graph -------------
    # (after phases 5-14 the caching allocator held 35-60 GiB it could not
    # hand out again, and phase 15 needs 60 GiB: two 10 GiB caches)
    t0 = time.perf_counter()
    for name, k in distributed_phase(dev, ops, sr, bag, fa,
                                     torch.sort(g.out.col_idx).values).items():
        launches[name] += k
    log(f"[15 distributed] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 5: high diameter ------------------------------------------------
    g2 = G.grid2d(args.grid, seed=5, device=dev)
    pack2 = pack_ell(g2.inc)
    if args.profile:     # the first 256 iterations bound the trace's size
        profile_runs(E, [("grid bfs, 256 iterations", A.bfs(0))], g2, pack2,
                     E.EngineConfig(frontier_cap=g2.n_nodes, edge_cap=g2.n_edges,
                                    max_iters=256))
    for name, p in (("bfs", A.bfs(0)), ("sssp", A.sssp(0))):
        ref = None
        for fusion in ("none", "all", "pushpull"):
            cfg = E.EngineConfig(frontier_cap=g2.n_nodes, edge_cap=g2.n_edges,
                                 fusion=fusion, max_iters=16384)
            mm, ss, tt = timed_run(E, p, g2, pack2, cfg)
            if int(ss["final_count"]) != 0:
                raise AssertionError(f"grid {name} {fusion}: did not converge")
            if ref is None:
                ref = (mm, ss)
                check_dist(f"grid {name}", mm["dist"], scipy_dist(g2, name == "bfs"), ell.BIG)
            else:
                same_run(f"grid {name} {fusion}", ref[0], ref[1], mm, ss)
            log(f"[5 diameter] grid2d({args.grid}) {name} fusion={fusion}: {tt:.3f} s, "
                f"iterations {int(ss['iterations'])} (push {int(ss['push_iters'])}, "
                f"pull {int(ss['pull_iters'])})")

    # -- phase 6: the second slice at full width ----------------------------
    for name, k in slice_phase(dev, pack, ops, ell, bag, fa, L, report, err, rounded).items():
        launches[name] += k
    torch.cuda.empty_cache()

    # -- phase 7: the paper's baseline engines ---------------------------------
    t0 = time.perf_counter()
    baselines_phase(A, E, Bl, f"RMAT-{args.scale}", g, pack, [(64, m, True)], False)
    side = args.grid
    # the online filter alone on the grid: a bfs front from a corner holds up
    # to `side` vertices, so a cap of 256 overflows at depth 256 and `side`
    # (with 4 edges a vertex) carries the whole run
    baselines_phase(A, E, Bl, f"grid2d({side})", g2, pack2,
                    [(256, 2048, side > 256), (side, 4 * side, False)], True)
    log(f"[7 baselines] phase {time.perf_counter() - t0:.1f} s")
    del g2, pack2
    torch.cuda.empty_cache()

    # -- phase 8: the batched engine at RMAT-22 -------------------------------
    t0 = time.perf_counter()
    time_batched_kernel(dev, ell, sr, g, pack, report, err)
    launches["ell_combine_batched"] = batched_phase(dev, A, E, S, BE, obs, ops, ell, g, pack,
                                                    report)
    log(f"[8 batched] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # -- phase 9: serving on the RMAT-22 graph ----------------------------------
    t0 = time.perf_counter()
    served = serving_phase(dev, A, E, S, BE, obs, ops, ell, g, pack, args.profile)
    for name, k in served.items():
        launches[name] += k
    log(f"[9 serving] phase {time.perf_counter() - t0:.1f} s")
    del pack
    torch.cuda.empty_cache()

    # -- phase 10: streaming updates on the RMAT-22 graph -------------------------
    t0 = time.perf_counter()
    nz = np.flatnonzero(g.out.degrees().cpu().numpy() > 0)
    streamed = streaming_phase(dev, A, E, S, ops, ell, sr, fp, g, nz)
    for name, k in streamed.items():
        launches[name] += k
    log(f"[10 streaming] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # -- phase 11: SLO replay and sharded serving on the RMAT-22 graph -----------
    t0 = time.perf_counter()
    sharded = sharded_phase(dev, A, S, ops, ell, sr, fp, g, nz, report,
                            MEASURED["served_qps"])
    for name, k in sharded.items():
        launches[name] += k
    log(f"[11 sharded] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # -- phase 12: the model stacks' serving path ---------------------------------
    t0 = time.perf_counter()
    for name, k in models_phase(dev, ops, sr, bag, fa, report, args.profile).items():
        launches[name] += k
    log(f"[12 models] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 13: acclint on the card --------------------------------------------
    t0 = time.perf_counter()
    for name, k in acclint_phase(dev, ops, g).items():
        launches[name] += k
    del g
    torch.cuda.empty_cache()
    log(f"[13 acclint] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 14: training ---------------------------------------------------------
    t0 = time.perf_counter()
    for name, k in training_phase(dev, ops, sr, bag, fa, report,
                                  Path(__file__).resolve().parent).items():
        launches[name] += k
    log(f"[14 training] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 16: report ------------------------------------------------------
    kernels = []
    for name in _build.KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append(dict(name=name, route="cuda",
                            source=f"src/repro_torch/csrc/{_build.KERNELS[name]}.cu",
                            launches=launches[name], passed=True, **report[name]))
    log(f"[16 report] total {time.perf_counter() - t_start:.1f} s, against the 1200 s "
        "limit of the chip call")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""LM serving launcher: a continuous-batching prefill + decode loop.

Port of `repro.launch.serve`, with the same flags and printed lines plus
`--device`: a queue of requests is admitted into fixed slots, prefill fills
a slot's kv cache (one cache of batch 1 a slot, so slots prefill on their
own), each step decodes one token for every active slot under greedy
argmax, and a finished slot takes the next request.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --slots 4

It runs on the card unless `--device cpu` asks for the CPU. `main` serves
`tiny_config` of the chosen arch, as the reference does; `serve` is the
loop alone, for any config and parameters. Prompts are numpy's
`default_rng(--seed)` draws, as in the reference; the weights are drawn
from a `torch.Generator` seeded with `--seed`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.launch.train import tiny_config
from repro_torch.models import transformer as tfm


def _greedy(logits: torch.Tensor) -> int:
    """The first index of the largest logit of the last position (argmax's
    tie order in JAX and PyTorch alike)."""
    return int(torch.argmax(logits[:, -1], dim=-1)[0])


def serve(cfg: tfm.TransformerConfig, params: dict, prompts, slots: int,
          gen_len: int, max_len: int, device="cuda"):
    """Serve `prompts` ((1, P) int arrays, in order) through `slots` slots.
    Returns (done, steps): done lists (request id, generated tokens) in the
    order requests finish, `gen_len` tokens each; steps counts the batch
    steps (one decode of every active slot)."""
    dev = resolve_device(device)
    pending = list(prompts)
    table = [None] * slots          # (cache, generated, remaining, rid)
    done = []
    next_rid = 0
    steps = 0
    while pending or any(s is not None for s in table):
        # admission: fill empty slots (continuous batching)
        for i in range(slots):
            if table[i] is None and pending:
                prompt = torch.as_tensor(np.asarray(pending.pop(0)), dtype=torch.int32,
                                         device=dev)
                cache = tfm.init_cache(cfg, 1, max_len, device=dev)
                logits, cache = tfm.decode_step(params, cache, prompt, cfg)
                table[i] = (cache, [_greedy(logits)], gen_len - 1, next_rid)
                next_rid += 1
        # one decode step for all active slots
        for i in range(slots):
            if table[i] is None:
                continue
            cache, gen, rem, rid = table[i]
            tok = torch.tensor([[gen[-1]]], dtype=torch.int32, device=dev)
            logits, cache = tfm.decode_step(params, cache, tok, cfg)
            gen.append(_greedy(logits))
            rem -= 1
            if rem <= 0:
                done.append((rid, gen))
                table[i] = None
            else:
                table[i] = (cache, gen, rem, rid)
        steps += 1
    return done, steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = tiny_config(configs.get(args.arch).make_config())
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=(1, args.prompt_len)).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.time()
    done, steps = serve(cfg, params, prompts, args.slots, args.gen_len, args.max_len, dev)
    dt = time.time() - t0
    total_toks = sum(len(g) for _, g in done)
    print(f"[serve] {len(done)} requests, {total_toks} tokens, "
          f"{dt:.1f}s ({total_toks/dt:.1f} tok/s), {steps} batch steps")
    for rid, gen in sorted(done)[:3]:
        print(f"  req {rid}: {gen[:12]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

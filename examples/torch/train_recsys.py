"""DeepFM CTR training on the synthetic click stream + retrieval scoring, on
the PyTorch port (the bags on the `embedding_bag` kernel, the table's
gradient by the deterministic scatter).

  PYTHONPATH=src python examples/torch/train_recsys.py --steps 100 [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch import tree as T
from repro_torch.data import ClickStream
from repro_torch.models import deepfm as dfm
from repro_torch.optim import AdamWConfig, init as opt_init, update as opt_update


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = configs.get("deepfm").make_reduced()
    stream = ClickStream(cfg.n_fields, cfg.vocab_per_field, cfg.embed_dim,
                         batch=args.batch, seed=0)
    params = dfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ocfg = AdamWConfig(lr=3e-3, weight_decay=1e-6, total_steps=args.steps)
    opt = opt_init(params, ocfg)
    leaves = T.leaves(params)
    for p in leaves:
        p.requires_grad_()

    for i in range(args.steps):
        ids, y = next(stream)
        lv = dfm.loss_fn(params, torch.from_numpy(ids).to(dev), torch.from_numpy(y).to(dev), cfg)
        grads = T.unflatten(params, torch.autograd.grad(lv, leaves))
        opt_update(grads, opt, params, ocfg)
        if (i + 1) % 20 == 0:
            print(f"step {i+1}: bce {float(lv.detach()):.4f}")

    # AUC on a held-out batch
    ids, y = next(stream)
    with torch.no_grad():
        scores = dfm.forward(params, torch.from_numpy(ids).to(dev), cfg).cpu().numpy()
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=float)
    ranks[order] = np.arange(len(scores))
    pos = y > 0.5
    auc = (ranks[pos].mean() - (pos.sum() - 1) / 2) / max((~pos).sum(), 1)
    print(f"held-out AUC: {auc:.3f}")

    # retrieval: score one user against 100k candidates (one matmul)
    with torch.no_grad():
        cand = params["table"][: 100_000 % params["table"].shape[0] + 1000]
        uv = dfm.user_vector(params, torch.from_numpy(ids[:1]).to(dev), cfg)
        top = torch.topk(dfm.score_candidates(uv, cand), 5)
    print("top-5 candidate ids:", top.indices[0].tolist())


if __name__ == "__main__":
    main()

"""The port's edge-sharded GatedGCN (`models.gnn.make_edgesharded_gatedgcn`)
on CPU meshes of 1, 2 and 4 shards against the reference's on a (1, 1) jax
mesh (`jax.grad`): loss and every gradient leaf within 1e-5 of its largest
entry. The edge count (101) needs padding to 104 with edges to the
sentinel n (weight 0), as the reference's callers pad. The reference's
edge-sharded body computes per edge; its single-device GatedGCN gathers
`msg[src]` (a fault of the reference, ROADMAP), so the single-device
`gnn.loss_fn` is not the oracle here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import AxisType, make_mesh
from repro.models import gnn as jgnn
from repro_torch import interop
from repro_torch import mesh as M
from repro_torch import tree as T
from repro_torch.models import gnn as tgnn

ERR = 1e-5
N, E, E_PAD = 30, 101, 104


@pytest.fixture(scope="module")
def case():
    cfg = jgnn.GNNConfig("g", "gatedgcn", n_layers=2, d_hidden=16, d_in=12, n_classes=5)
    params = jgnn.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    pad = lambda a, val: np.concatenate([a, np.full(E_PAD - E, val, a.dtype)])
    src = pad(rng.integers(0, N, E).astype(np.int32), N)
    dst = pad(rng.integers(0, N, E).astype(np.int32), N)
    wgt = pad(rng.random(E).astype(np.float32), 0.0)
    feats = rng.standard_normal((N, 12)).astype(np.float32)
    labels = rng.integers(0, 5, N).astype(np.int32)
    mask = (rng.random(N) < 0.7).astype(np.float32)
    inputs = (feats, src, dst, wgt, labels, mask)
    mesh = make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    loss, grads = jax.jit(jax.value_and_grad(jgnn.make_edgesharded_gatedgcn(cfg, mesh, N)))(
        params, *map(jnp.asarray, inputs))
    tcfg = tgnn.GNNConfig("g", "gatedgcn", n_layers=2, d_hidden=16, d_in=12, n_classes=5)
    return (tcfg, jax.tree.map(np.asarray, params), inputs, float(loss),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def port_loss_and_grads(case, shape, axes=("data", "model")):
    tcfg, params, inputs = case[:3]
    mesh = M.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    tp = interop.params_from_numpy(params, "cpu")
    leaves = T.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_()
    loss = tgnn.make_edgesharded_gatedgcn(tcfg, mesh, N, axes)(
        tp, *(torch.from_numpy(x) for x in inputs))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # the last layer's edge norm does not reach the loss (JAX gives zeros)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_edgesharded_gatedgcn_matches_the_reference(case, shape):
    loss, grads = port_loss_and_grads(case, shape)
    assert abs(float(loss) - case[3]) <= ERR * abs(case[3])
    assert len(grads) == len(case[4])
    for g, want in zip(grads, case[4]):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g.numpy() - want).max()) <= ERR * scale


def test_edgesharded_gatedgcn_over_one_axis(case):
    """Edges cut over 'model' only: the 'data' rows hold the same edges."""
    loss, grads = port_loss_and_grads(case, (2, 2), axes=("model",))
    assert abs(float(loss) - case[3]) <= ERR * abs(case[3])


def test_edgesharded_gatedgcn_repeats_bit_equal(case):
    a = port_loss_and_grads(case, (2, 2))
    b = port_loss_and_grads(case, (2, 2))
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def test_edge_shards_cut_row_major_and_need_padding():
    mesh = M.make_mesh(2, 2, devices=["cpu"] * 4)
    cut = tgnn.edge_shards(mesh, 8)
    assert [(sl.start, sl.stop) for _, sl in cut] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="pad"):
        tgnn.edge_shards(mesh, 7)

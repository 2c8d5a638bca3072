"""The port's LM stack (`repro_torch.models.transformer`, `nn.moe`,
`launch.serve`) against the JAX reference on the CPU: the reference's own
initial weights carried over by `interop.params_from_numpy`, the same
numpy-seeded tokens through both packages.

Tolerances (float32): rtol 1e-4, atol 1e-5 on logits, caches and MoE
outputs (rotary angles through another pow/sin, matmuls and the MoE combine
in another order); the MoE routing (sorted experts, tokens, kept mask) and
the served tokens are equal exactly.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch.train import tiny_config as jtiny
from repro.models import transformer as jtf
from repro.nn import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import tiny_config as ttiny
from repro_torch.models import transformer as ttf
from repro_torch.nn import moe as tmoe

RTOL, ATOL = 1e-4, 1e-5
LM_ARCHS = ["minitron-4b", "granite-3-8b", "llama3-405b", "moonshot-v1-16b-a3b",
            "granite-moe-1b-a400m"]


def _carry(tree):
    return interop.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=RTOL, atol=ATOL)


def _reduced(arch):
    """The reference's reduced config, its params, and the port's config."""
    cfg = jconfigs.get(arch).make_reduced()
    return cfg, jtf.init_params(jax.random.key(0), cfg), tconfigs.get(arch).make_reduced()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch):
    cfg, p, tcfg = _reduced(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    logits, aux = jtf.forward(p, jnp.asarray(toks), cfg)
    tl, taux = ttf.forward(_carry(p), torch.from_numpy(toks), tcfg)
    assert tl.shape == (2, 16, tcfg.padded_vocab)
    _close(logits, tl)
    _close(aux, taux)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 8 tokens into a 24-long cache, then decode one: logits of
    both steps and the caches equal the reference's."""
    cfg, p, tcfg = _reduced(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    tp = _carry(p)
    cache = jtf.init_cache(cfg, 2, 24)
    tcache = ttf.init_cache(tcfg, 2, 24, device="cpu")
    for sl in (slice(0, 8), slice(8, 9)):
        logits, cache = jtf.decode_step(p, cache, jnp.asarray(toks[:, sl]), cfg)
        tl, tcache = ttf.decode_step(tp, tcache, torch.from_numpy(toks[:, sl]), tcfg)
        _close(logits, tl)
        _close(cache["k"], tcache["k"])
        _close(cache["v"], tcache["v"])
        assert tcache["len"] == int(cache["len"])
    # a reference cache carried over continues as the port's own
    tl, _ = ttf.decode_step(tp, interop.cache_from_numpy(jax.tree.map(np.asarray, cache), "cpu"),
                            torch.from_numpy(toks[:, 8:9]), tcfg)
    logits, _ = jtf.decode_step(p, cache, jnp.asarray(toks[:, 8:9]), cfg)
    _close(logits, tl)


def test_config_numbers_match_reference():
    for arch in LM_ARCHS:
        a, b = jconfigs.get(arch).make_config(), tconfigs.get(arch).make_config()
        assert (a.dh, a.padded_vocab, a.param_count(), a.active_param_count()) == \
            (b.dh, b.padded_vocab, b.param_count(), b.active_param_count()), arch
    assert tconfigs.get("granite-3-8b").make_config().param_count() == 8_372_187_136


def _jax_routing(gates, k, c):
    """The reference's dispatch (`repro/nn/moe.py:44-56`) on the same gates:
    sorted experts, their tokens, and the kept mask."""
    t = gates.shape[0]
    _, topi = jax.lax.top_k(gates, k)
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    st_ = jnp.repeat(jnp.arange(t, dtype=jnp.int32), k)[order]
    grp = jnp.searchsorted(se, jnp.arange(gates.shape[1], dtype=se.dtype), side="left")
    keep = jnp.arange(t * k) - grp[se] < c
    return np.asarray(se), np.asarray(st_), np.asarray(keep)


def test_moe_ffn_over_capacity_matches_reference(monkeypatch):
    """64 tokens, 8 experts, top 2, capacity factor 0.5: capacity 8 against
    16 pairs an expert on average, so pairs drop. The kept pairs equal the
    reference's exactly; output and aux within tolerance."""
    cfg = jmoe.MoEConfig(8, 2, capacity_factor=0.5)
    tcfg = tmoe.MoEConfig(8, 2, capacity_factor=0.5)
    t, d, f = 64, 32, 48
    rng = np.random.default_rng(3)
    p = {"router": rng.standard_normal((d, 8)).astype(np.float32),
         "we1": rng.standard_normal((8, d, f)).astype(np.float32) * d ** -0.5,
         "we3": rng.standard_normal((8, d, f)).astype(np.float32) * d ** -0.5,
         "we2": rng.standard_normal((8, f, d)).astype(np.float32) * f ** -0.5}
    x = rng.standard_normal((t, d)).astype(np.float32)
    out, aux = jmoe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, cfg)

    seen = []
    real = ops.segment_reduce

    def spy(vals, ids, num, combine="sum", fill=None):
        seen.append(ids.clone())
        return real(vals, ids, num, combine, fill)

    monkeypatch.setattr(ops, "segment_reduce", spy)
    tout, taux = tmoe.moe_ffn(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                              tcfg)
    _close(out, tout)
    _close(aux, taux)
    # the combine gets the pairs sorted by token (they come sorted by expert)
    assert len(seen) == 1 and torch.equal(seen[0], torch.arange(t, dtype=torch.int32)
                                          .repeat_interleave(2))

    c = tmoe.capacity(t, tcfg)
    assert c == jmoe.capacity(t, cfg) == 8
    gates = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(p["router"]), dim=-1)
    se, st_, keep = _jax_routing(jnp.asarray(gates.numpy()), 2, c)
    assert not keep.all()
    tse, tst, _, rank_c, tkeep = tmoe.dispatch(tmoe.top_k(gates, 2)[1], 8, c)
    np.testing.assert_array_equal(se, tse.numpy())
    np.testing.assert_array_equal(st_, tst.numpy())
    np.testing.assert_array_equal(keep, tkeep.numpy())
    assert torch.equal(rank_c[~tkeep], torch.full_like(rank_c[~tkeep], c))


def test_top_k_puts_the_lower_index_first_on_ties():
    gates = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.5, 0.0, 0.5, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(gates), 3)
    tv, ti = tmoe.top_k(torch.from_numpy(gates), 3)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def _ref_tokens(p, cfg, prompt, gen_len, max_len):
    """One request through the reference's `decode_step` under greedy
    argmax, as `repro.launch.serve` runs a slot: its tokens and the logits of
    every step."""
    step = jax.jit(lambda p, c, t: jtf.decode_step(p, c, t, cfg))
    logits, cache = step(p, jtf.init_cache(cfg, 1, max_len), jnp.asarray(prompt))
    gen, seen = [int(jnp.argmax(logits[:, -1], axis=-1)[0])], [logits]
    for _ in range(gen_len - 1):
        logits, cache = step(p, cache, jnp.asarray([[gen[-1]]], jnp.int32))
        gen.append(int(jnp.argmax(logits[:, -1], axis=-1)[0]))
        seen.append(logits)
    return gen, seen


def test_serve_loop_generates_the_reference_tokens(capsys):
    """`serve` at tiny_config of granite-3-8b with the reference launcher's
    weights (its `init_params(key(seed))`): the tokens `repro.launch.serve`
    prints, and every request's tokens and per-step logits (teacher-forced
    on the reference's tokens) equal the reference's decode_step."""
    argv = ["--requests", "3", "--slots", "2", "--prompt-len", "16", "--gen-len", "8",
            "--max-len", "32", "--seed", "0"]
    assert jserve.main(argv) == 0
    out = capsys.readouterr().out
    printed = {int(m.group(1)): [int(x) for x in m.group(2).split(",")]
               for m in re.finditer(r"req (\d+): \[([^\]]*)\]", out)}
    assert len(printed) == 3

    cfg = jtiny(jconfigs.get("granite-3-8b").make_config())
    tcfg = ttiny(tconfigs.get("granite-3-8b").make_config())
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(cfg).items()
                                        if k in dataclasses.asdict(tcfg)}
    p = jtf.init_params(jax.random.key(0), cfg)
    tp = _carry(p)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(1, 16)).astype(np.int32) for _ in range(3)]
    done, steps = tserve.serve(tcfg, tp, prompts, 2, 8, 32, "cpu")
    assert sorted(r for r, _ in done) == [0, 1, 2]
    assert f"{steps} batch steps" in out
    for rid, gen in done:
        assert gen[:12] == printed[rid]
        ref, ref_logits = _ref_tokens(p, cfg, prompts[rid], 8, 32)
        assert gen == ref
        cache = ttf.init_cache(tcfg, 1, 32, device="cpu")
        for tokens, want in zip([prompts[rid]] + [[[t]] for t in ref[:-1]], ref_logits):
            tl, cache = ttf.decode_step(tp, cache, torch.tensor(np.asarray(tokens),
                                                                dtype=torch.int32), tcfg)
            _close(want, tl)


def test_serve_main_prints_the_reference_lines(capsys):
    assert tserve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                        "--gen-len", "4", "--arch", "granite-moe-1b-a400m"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"\[serve\] 3 requests, 12 tokens, [\d.]+s \([\d.]+ tok/s\), "
                        r"\d+ batch steps", out[0])
    assert [line.split(":")[0] for line in out[1:]] == ["  req 0", "  req 1", "  req 2"]


@pytest.mark.parametrize("arch", ["granite-3-8b", "granite-moe-1b-a400m"])
def test_lm_takes_the_plain_versions_on_the_cpu(monkeypatch, arch):
    """On CPU tensors `forward` reaches the plain attention (and, with MoE,
    the plain segment reduction); no CUDA wrapper is called."""
    called = {"attention": 0, "segment": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            called[name] += 1
            return fn(*a, **k)
        return wrapped

    def refuse(*a, **k):
        raise AssertionError("a CUDA wrapper was called on CPU tensors")

    monkeypatch.setattr(tfa, "attention_plain", count("attention", tfa.attention_plain))
    monkeypatch.setattr(tsr, "segment_reduce_plain", count("segment", tsr.segment_reduce_plain))
    for mod, name in ((tfa, "flash_attention_cuda"), (tsr, "segment_reduce_cuda"),
                      (tbag, "embedding_bag_cuda")):
        monkeypatch.setattr(mod, name, refuse)
    _, p, tcfg = _reduced(arch)
    ttf.forward(_carry(p), torch.zeros((1, 8), dtype=torch.int32), tcfg)
    assert called["attention"] == tcfg.n_layers
    assert called["segment"] == (tcfg.n_layers if tcfg.moe else 0)

"""A run with the timed path broken underneath comes out not correct: every
cell under each fault it can have, driven through the whole harness on the
CPU at test size (only the card's check is skipped). One card, so no cell
has an exchange between chips to leave out."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import run_tiny


def unchanged_state(mp):
    """Every step, solo or batched, returns the metadata it was given."""
    from repro_torch.core.acc import ACCProgram

    mp.setattr(ACCProgram, "run_apply", lambda self, m, seg, it: m)


def half_the_batch(mp):
    """The batched step leaves the second half of the lanes as they were."""
    from repro_torch.serving import batch_engine as B

    make = B.make_batched_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(st, gmode=None):
            new = step(st, gmode)
            q = st.done.shape[0]
            m = {k: torch.cat([v[:, : (q + 1) // 2], st.m[k][:, (q + 1) // 2:]], 1)
                 for k, v in new.m.items()}
            return new._replace(m=m)

        return half

    mp.setattr(B, "make_batched_step", broken)


def altered_answer(mp):
    """Each answer has one entry changed where it is produced: the solo
    engine's result, each lane of a batch, each harvested lane of a pool."""
    from repro_torch.core import engine as E
    from repro_torch.serving import batch_engine as B
    from repro_torch.serving.scheduler import AlgoPool

    run, run_batch, harvest = E.run, B.run_batch, AlgoPool.harvest

    def solo(prog, g, pack, cfg, **kw):
        m, stats = run(prog, g, pack, cfg, **kw)
        m[prog.primary][kw["source"]] += 1.0
        return m, stats

    def batch(prog, g, pack, cfg, sources, **kw):
        m, stats = run_batch(prog, g, pack, cfg, sources, **kw)
        field = prog.param("result", prog.primary)
        m[field][torch.as_tensor(sources), torch.arange(len(sources))] += 0.01
        return m, stats

    def pool(self):
        out = []
        for lane, rid, result, its, extras in harvest(self):
            result = np.array(result)
            result[int(np.argmin(result) if self.program.name != "ppr" else
                       np.argmax(result))] += 1.0
            out.append((lane, rid, result, its, extras))
        return out

    mp.setattr(E, "run", solo)
    mp.setattr(B, "run_batch", batch)
    mp.setattr(AlgoPool, "harvest", pool)


FAULTS = {"unchanged_state": unchanged_state, "half_the_batch": half_the_batch,
          "altered_answer": altered_answer}
CASES = [("kron23-graph500", "unchanged_state"), ("kron23-graph500", "altered_answer"),
         ("urand24-graph500", "unchanged_state"), ("urand24-graph500", "altered_answer"),
         ("kron23-ppr64", "unchanged_state"), ("kron23-ppr64", "half_the_batch"),
         ("kron23-ppr64", "altered_answer"),
         ("kron23-serve", "unchanged_state"), ("kron23-serve", "half_the_batch"),
         ("kron23-serve", "altered_answer")]


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_the_unbroken_run_is_correct(tiny, cell):
    r = run_tiny(tiny, cell)
    assert r["correct"] and r["failed"] == 0, r["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_run_is_not_correct(tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    r = run_tiny(tiny, cell)
    assert not r["correct"], r["checks"]

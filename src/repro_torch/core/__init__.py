"""The ACC model + SIMD-X solo engine in PyTorch.

  acc.py        -- Active/Compute/Combine programming model (paper Sec. 3)
  frontier.py   -- JIT task management: online/ballot filters (paper Sec. 4)
  engine.py     -- push-pull engine (paper Sec. 5)
  algorithms.py -- the program catalog (paper Sec. 6)
"""

from repro_torch.core.acc import ACCProgram, Combiner, MIN_AGG, MIN_VOTE, SUM_AGG, MAX_VOTE
from repro_torch.core.engine import EngineConfig, EngineState, run, init_state
from repro_torch.core import algorithms, frontier

__all__ = [
    "ACCProgram",
    "Combiner",
    "MIN_AGG",
    "MIN_VOTE",
    "SUM_AGG",
    "MAX_VOTE",
    "EngineConfig",
    "EngineState",
    "run",
    "init_state",
    "algorithms",
    "frontier",
]

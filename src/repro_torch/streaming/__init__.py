"""Streaming graph updates, port of `repro.streaming` — so far only the
program classification and the residual reseed that the serving scheduler
needs (`incremental.py`).

`StreamingGraph` (`delta.py`), `residual_correct` and `incremental_batch`
come with ROADMAP queue 1 item 6.
"""

from repro_torch.streaming.incremental import (
    incremental_contract,
    is_monotone,
    is_residual,
    reseed_from_residuals,
    resume_fields,
)

__all__ = [
    "incremental_contract",
    "is_monotone",
    "is_residual",
    "reseed_from_residuals",
    "resume_fields",
]

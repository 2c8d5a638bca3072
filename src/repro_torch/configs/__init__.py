"""Assigned-architecture configs of the port (`repro.configs` counterpart).
Importing it registers the ten archs."""

from repro_torch.configs.registry import ArchSpec, cells, get, names
from repro_torch.configs import lm_archs, gnn_archs  # noqa: F401  (register archs)

__all__ = ["ArchSpec", "cells", "get", "names"]

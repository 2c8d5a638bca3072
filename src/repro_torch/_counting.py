"""The active cost counters: where the kernels' meta routes and the mesh's
collectives report the work that no dispatched aten op shows.

`launch.cost.counting` pushes a counter here for the length of one run.
A kernel's meta route adds its operations and bytes (`kernel`); a
collective of the single-controller mesh adds its kind and the bytes of
its logical operand (`collective`). With no counter active both are a
no-op, so the card's and the CPU's routes pay nothing for them.
"""

from __future__ import annotations

_ACTIVE: list = []


def push(counter) -> None:
    _ACTIVE.append(counter)


def pop(counter) -> None:
    _ACTIVE.remove(counter)


def kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's work: `flops` operations, `nbytes` moved."""
    for c in _ACTIVE:
        c.add_kernel(name, flops, nbytes)


def collective(kind: str, nbytes: float) -> None:
    """One collective of `kind` (a key of `launch.cost.WIRE_FACTOR`) whose
    operand is `nbytes` a device."""
    for c in _ACTIVE:
        c.add_collective(kind, nbytes)

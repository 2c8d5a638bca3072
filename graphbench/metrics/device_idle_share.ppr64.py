"""% of the traced window in which no operation ran on the device."""

from graphbench.readers import idle_share as read  # noqa: F401

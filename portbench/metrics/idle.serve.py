"""Percent of the profiled slice of the served window in which the device ran nothing."""

from portbench.readings import idle_pct as read  # noqa: F401

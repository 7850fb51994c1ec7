"""Tools that set the benchmark's numbers once: ``limits`` (the readings of
sound runs and of the control that the comparison's limits come from) and
``sweep`` (a served cell's knee, from which its rate is set)."""

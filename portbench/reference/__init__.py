"""Plain references of the benchmark's configurations, one module per
architecture (the ``arch`` of a configuration file): the float network the
benchmark draws from a seed and calibrates, and its int8 forward. They
import ``torch`` and ``numpy`` alone."""

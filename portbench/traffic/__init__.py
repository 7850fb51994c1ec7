"""Traffic: each mix is a JSON file of parameters, ``<mix>.json``, whose
``generator`` names the module here that drives it (``closed_loop``,
``open_bursts``); ``images`` makes the seeded images both read."""

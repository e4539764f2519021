"""The port's benchmark: a harness driven by the cells of ``BENCHMARK.json``.

``run.py`` is the command.  A configuration (``configs/<name>.json``), a
traffic mix (``traffic/<name>.json``), a driver of a traffic kind
(``drivers/<kind>.py``), a per-layer metric's reader (``metrics/<name>.py``)
and a cell's limits of correctness (``limits/<workload>.json``) are each a
file of their own, found by name.
"""

"""The port's benchmark: cells of ``BENCHMARK.json`` driven through
``repro_torch``'s serving engine, measured on the host clock and the
device trace, and held against a plain fp32 reference (``reference.py``).

Everything a cell is made of is data found by name: a configuration in
``configs/<name>.json``, a traffic mix in ``traffic/<name>.json``, a
per-layer metric in ``metrics/<name>.py``.
"""

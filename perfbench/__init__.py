"""The port's benchmark: cells of ``BENCHMARK.json`` driven through
``repro_torch``'s serving engine, measured on the host clock and the
device trace, and held against a plain fp32 reference (``reference.py``).

Everything a cell is made of is found by name: a configuration in
``configs/<name>.json``, its plain reference in ``refs/<name>.py`` (the
configuration's ``model.reference``, ``dense`` when absent), a traffic mix
in ``traffic/<name>.json``, a per-layer metric in ``metrics/<name>.py``.
"""

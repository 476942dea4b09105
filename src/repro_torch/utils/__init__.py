# Small tree utilities, the port's copy of repro/utils/tree.py.

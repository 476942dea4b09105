"""The model FLOPs that the window's traffic needs (``work.py``: prefill,
decode, descriptor and attention from the benchmark's own record of
lengths and tokens) over the window's seconds at 989 TFLOP/s."""
from perfbench.readers import mfu


def read(w):
    return mfu(w)

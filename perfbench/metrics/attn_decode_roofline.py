"""The least time of the window's decode attention (the visible K and V of
each decoded token, ``work.py``) over the device time of the kernels that
run it: K7 (``decode_*``) wherever it runs, and K5 (``paged_*``) when it
began inside the engine's ``decode`` span."""
from perfbench.readers import kernel_seconds, window_work

K7 = ("decode_fma_kernel", "decode_mma_kernel", "decode_merge_kernel")
K5 = ("paged_split_kernel", "paged_mma_kernel", "paged_merge_kernel")


def read(w):
    if w.device_events is None:
        return None
    t = kernel_seconds(w, K7, in_spans=("decode",), names_in_spans=K5)
    if t <= 0:
        return None
    return window_work(w).least_decode_attn_s() / t * 100.0

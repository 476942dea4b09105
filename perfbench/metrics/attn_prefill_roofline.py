"""The least time of the window's prefill and descriptor attention
(``work.py``) over the device time of the kernels that run it: K8
(``flash_*``) wherever it runs, and K5 (``paged_*``) when it began inside
the engine's ``admit`` span (the paged path's chunked prefill; its decode
launches are the decode metric's)."""
from perfbench.readers import kernel_seconds, window_work

K8 = ("flash_kernel", "flash_mma_kernel")
K5 = ("paged_split_kernel", "paged_mma_kernel", "paged_merge_kernel")


def read(w):
    if w.device_events is None:
        return None
    t = kernel_seconds(w, K8, in_spans=("admit",), names_in_spans=K5)
    if t <= 0:
        return None
    return window_work(w).least_prefill_attn_s() / t * 100.0

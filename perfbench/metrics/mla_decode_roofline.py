"""The least time of the window's decode attention (``work.py``: for an MLA
model a visible key's bytes are its latent's, (r + dr) x 2 a layer) over
the device time of the absorbed MLA decode kernel that runs it
(``paged_latent``: its split and merge functions, wherever they run).  A
program without that kernel, or a model without MLA, runs none: None."""
from perfbench.readers import kernel_seconds, window_work

PAGED_LATENT = ("latent_split_kernel", "latent_merge_kernel")


def read(w):
    if w.device_events is None:
        return None
    t = kernel_seconds(w, PAGED_LATENT)
    if t <= 0:
        return None
    return window_work(w).least_decode_attn_s() / t * 100.0

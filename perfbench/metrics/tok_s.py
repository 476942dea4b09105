"""Every token the model generated in the window's steps (a prefill's first
token and each decoded one, finished requests or not), over the window."""
from perfbench.readers import window_work


def read(w):
    return window_work(w).tokens_generated / w.seconds

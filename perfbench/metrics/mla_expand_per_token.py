"""Latent rows that MLA expands to per-head K and V for each latent row it
writes (``engine/mla/expanded`` over ``engine/mla/written``, both summed
over the window's launches and MLA layers): how many times a cached token
is re-expanded.  A program without the counters reads None."""


def read(w):
    n, expanded = w.hist("engine/mla/expanded")
    _, written = w.hist("engine/mla/written")
    return expanded / written if n > 0 and written > 0 else None

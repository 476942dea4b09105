"""Share of the backlog window with no device activity (the union of
the trace's kernel, copy and fill intervals)."""
from perfbench.readers import idle_share


def read(w):
    return idle_share(w)

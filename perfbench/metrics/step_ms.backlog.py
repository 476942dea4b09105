"""Mean wall time of an engine step in the backlog window."""
from perfbench.readers import step_ms


def read(w):
    return step_ms(w)

"""The one-card part of ``repro/parallel``: the cache ladder's pooled probes."""

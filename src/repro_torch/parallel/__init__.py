"""The port of ``repro/parallel``: sharding rules, the cache ladder's
probes and the collectives of a mesh."""

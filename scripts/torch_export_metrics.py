#!/usr/bin/env python
"""Export a metrics registry snapshot as Prometheus text exposition (the
port of ``scripts/export_metrics.py``, over ``repro_torch.obs.metrics``).

Input is the flat JSON written by ``MetricsRegistry.export``; output is
the Prometheus text format, suitable for a node_exporter textfile
collector or a pushgateway.  Scalars render as gauges; histogram
snapshots render as summaries (``quantile`` labels + ``_sum``/``_count``)
— the snapshot has already collapsed the log-spaced buckets into
percentiles.  For full-fidelity ``le``-bucket histograms, call
``repro_torch.obs.metrics.export_prometheus`` on the LIVE registry
instead (same sanitization, same deterministic rendering).

Usage:
    PYTHONPATH=src python scripts/torch_export_metrics.py metrics.json
    PYTHONPATH=src python scripts/torch_export_metrics.py metrics.json -o out.prom
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("snapshot", help="MetricsRegistry snapshot JSON")
    ap.add_argument("-o", "--out", default="",
                    help="write Prometheus text here (default: stdout)")
    args = ap.parse_args(argv)

    from repro_torch.obs.metrics import snapshot_to_prometheus

    with open(args.snapshot) as f:
        snap = json.load(f)
    text = snapshot_to_prometheus(snap, path=args.out or None)
    if not args.out:
        sys.stdout.write(text)
    else:
        print(f"wrote {args.out}: {len(text.splitlines())} lines, "
              f"{len(snap)} metrics")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

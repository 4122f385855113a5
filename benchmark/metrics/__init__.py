"""Per-layer metric readers, one file each, named as the metric.

A reader is a module with `read(obs) -> float | None`, where `obs` is the
traced run's `harness.Observations`: the summed `Tracker.perf` sections,
the host spans, the device trace, the frames resolved in the window and
the cell's configuration.  It returns None when it finds nothing to read,
and the harness then leaves the metric out.  A reader that needs a span
around another method of the System names it in `SPANS`
({label: "attribute.path"}); the harness wraps it in traced runs.
"""

"""One reader per metric, named as the metric: ``read(rec)`` returns the
metric's number, or None where the run holds nothing to read (the
harness then leaves the metric out of the line).  ``rec`` holds the
window (``calls``, ``work``, ``window_s``, ``latencies_s``, ``setup_s``),
the cell's ``workload`` and ``config``, the driver's counts and, in a
traced run, the trace's ``events`` and ``trace_window_us`` and the
untraced window before it (``untraced``: ``calls``, ``window_s``)."""

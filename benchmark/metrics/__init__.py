"""One reader a metric, ``<metric name>.py``, found by the name in
``BENCHMARK.json``: ``read(rec)`` returns the metric's value from the run's
record, or None where the record holds nothing for it (the harness then
leaves the metric out of the line). ``rec`` holds the run's ``kind``,
``setup_s``, ``window_s``, ``calls``, ``images``, ``latencies_s`` (every
call's host-clock seconds), ``peak_allocated`` (bytes), and with
``--trace 1`` the ``trace`` summary of ``benchmark/trace.py`` with the
slice's ``calls``, ``images``, ``flops_per_image`` and ``peak_flops``."""

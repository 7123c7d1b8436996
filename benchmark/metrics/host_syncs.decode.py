"""`host_syncs.decode`: see `benchmark/lib/program_spans.py`."""

from benchmark.lib.program_spans import host_syncs_decode as read  # noqa: F401

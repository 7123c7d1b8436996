"""`host_syncs.encode`: see `benchmark/lib/program_spans.py`."""

from benchmark.lib.program_spans import host_syncs_encode as read  # noqa: F401

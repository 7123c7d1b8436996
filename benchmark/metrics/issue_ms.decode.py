"""`issue_ms.decode`: see `benchmark/lib/program_spans.py`."""

from benchmark.lib.program_spans import issue_ms_decode as read  # noqa: F401

"""`issue_ms.encode`: see `benchmark/lib/program_spans.py`."""

from benchmark.lib.program_spans import issue_ms_encode as read  # noqa: F401

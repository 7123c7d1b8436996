"""`offcpu_ms.encode`: see `benchmark/lib/program_spans.py`."""

from benchmark.lib.program_spans import offcpu_ms_encode as read  # noqa: F401

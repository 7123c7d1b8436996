"""`rans_span_ms.decode`: see `benchmark/lib/program_spans.py`."""

from benchmark.lib.program_spans import (  # noqa: F401
    rans_span_ms_decode as read)

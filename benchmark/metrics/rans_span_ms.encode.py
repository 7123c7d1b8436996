"""`rans_span_ms.encode`: see `benchmark/lib/program_spans.py`."""

from benchmark.lib.program_spans import (  # noqa: F401
    rans_span_ms_encode as read)

"""`device_wait_ms.decode`: see `benchmark/lib/program_spans.py`."""

from benchmark.lib.program_spans import (  # noqa: F401
    device_wait_ms_decode as read)

"""`pframe_device_ms.encode`: see `benchmark/lib/readers.py`
`pframe_device_ms`."""

from benchmark.lib.readers import pframe_device_ms as read  # noqa: F401

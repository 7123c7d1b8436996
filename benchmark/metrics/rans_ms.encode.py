"""`rans_ms.encode`: host ms a P-frame inside the rANS encoder's calls
(on the worker thread), over the window; see `benchmark/lib/readers.py`
`rans_ms`."""

from benchmark.lib.readers import rans_ms as read  # noqa: F401

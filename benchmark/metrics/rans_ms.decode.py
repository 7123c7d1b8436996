"""`rans_ms.decode`: host ms a P-frame inside the rANS decoder's calls,
over the window; see `benchmark/lib/readers.py` `rans_ms`."""

from benchmark.lib.readers import rans_ms as read  # noqa: F401

"""`mfu.decode`: see `benchmark/lib/readers.py` `mfu`."""

from benchmark.lib.readers import mfu as read  # noqa: F401

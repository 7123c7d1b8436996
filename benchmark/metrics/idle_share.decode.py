"""`idle_share.decode`: see `benchmark/lib/readers.py` `idle_share`."""

from benchmark.lib.readers import idle_share as read  # noqa: F401

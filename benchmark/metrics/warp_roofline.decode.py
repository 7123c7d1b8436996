"""`warp_roofline.decode`: see `benchmark/lib/readers.py` `warp_roofline`."""

from benchmark.lib.readers import warp_roofline as read  # noqa: F401

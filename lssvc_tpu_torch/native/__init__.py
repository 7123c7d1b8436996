"""The port's host-side rANS coder (`csrc/lssvc_rans.cpp` through ctypes)."""

from .rans import (
    BufferedRansEncoder,
    RansDecoder,
    RansEncoder,
    pmf_to_quantized_cdf,
)

__all__ = ["BufferedRansEncoder", "RansDecoder", "RansEncoder",
           "pmf_to_quantized_cdf"]

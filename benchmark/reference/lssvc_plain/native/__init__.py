"""The reference's rANS coder: plain Python (`rans.py`)."""

from .rans import (
    BufferedRansEncoder,
    RansDecoder,
    RansEncoder,
    pmf_to_quantized_cdf,
)

__all__ = ["BufferedRansEncoder", "RansDecoder", "RansEncoder",
           "pmf_to_quantized_cdf"]

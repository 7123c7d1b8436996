"""Bjøntegaard-delta metrics (BD-rate / BD-PSNR): the port's own copy of
the JAX package's `harness/bd_rate.py` (numpy only).

Standard cubic-polynomial BD computation (Bjøntegaard, VCEG-M33): fit
PSNR-vs-log(rate) cubics for anchor and test, integrate over the
overlapping interval, report the average horizontal (rate) or vertical
(quality) gap.  This replaces the reference's external `bd_metric`
dependency (`compare_rd_video.py:9`)."""

from __future__ import annotations

import numpy as np


def _prepare(rate, psnr):
    rate = np.asarray(rate, dtype=np.float64)
    psnr = np.asarray(psnr, dtype=np.float64)
    order = np.argsort(rate)
    return np.log(rate[order]), psnr[order]


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """Average bitrate delta (%) of test vs anchor at equal quality.

    Negative = test needs fewer bits than the anchor."""
    lr1, p1 = _prepare(rate_anchor, psnr_anchor)
    lr2, p2 = _prepare(rate_test, psnr_test)
    # fit log-rate as a cubic in psnr
    f1 = np.polyfit(p1, lr1, 3)
    f2 = np.polyfit(p2, lr2, 3)
    lo = max(p1.min(), p2.min())
    hi = min(p1.max(), p2.max())
    if hi <= lo:
        raise ValueError("no PSNR overlap between curves")
    int1 = np.polyint(f1)
    int2 = np.polyint(f2)
    avg1 = (np.polyval(int1, hi) - np.polyval(int1, lo)) / (hi - lo)
    avg2 = (np.polyval(int2, hi) - np.polyval(int2, lo)) / (hi - lo)
    return float((np.exp(avg2 - avg1) - 1) * 100)


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """Average quality delta (dB) of test vs anchor at equal rate."""
    lr1, p1 = _prepare(rate_anchor, psnr_anchor)
    lr2, p2 = _prepare(rate_test, psnr_test)
    f1 = np.polyfit(lr1, p1, 3)
    f2 = np.polyfit(lr2, p2, 3)
    lo = max(lr1.min(), lr2.min())
    hi = min(lr1.max(), lr2.max())
    if hi <= lo:
        raise ValueError("no rate overlap between curves")
    int1 = np.polyint(f1)
    int2 = np.polyint(f2)
    avg1 = (np.polyval(int1, hi) - np.polyval(int1, lo)) / (hi - lo)
    avg2 = (np.polyval(int2, hi) - np.polyval(int2, lo)) / (hi - lo)
    return float(avg2 - avg1)

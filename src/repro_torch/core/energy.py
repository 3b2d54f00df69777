"""PDP/EDP energy model (paper Eq. 1): PDP = execution time x power,
EDP = PDP x time. The power is always the caller's figure for the card it
measured on; the port carries no default chip power."""
from __future__ import annotations


def pdp(time_s: float, power_w: float) -> float:
    """Eq. 1: PDP = execution time x power consumption [J]."""
    return time_s * power_w


def edp(time_s: float, power_w: float) -> float:
    """EDP = PDP x time [J*s]."""
    return pdp(time_s, power_w) * time_s

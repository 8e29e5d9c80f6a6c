"""Reductions of a traced run's records that several per-layer metrics
share. Each returns None where the records hold nothing to read."""

from __future__ import annotations

from typing import Dict, Optional


def unit_seconds(u: Dict) -> float:
    return u["end"] - u["start"]


def between_units_ms(rec: Dict) -> Optional[float]:
    """The window's time outside the units (microbatches), over their number."""
    units = rec["units"]
    if not units:
        return None
    return (rec["window_s"] - sum(unit_seconds(u) for u in units)) / len(units) * 1e3


def _traced(rec: Dict):
    """The units whose stages were timed, but for the profiled one: the
    profiler's own cost would be read as the program's."""
    return [u for u in rec["units"] if u["stages"] and not u.get("profiled")]


def non_unet_s(rec: Dict) -> Optional[float]:
    """Per unit: its time outside the UNet loops' stages."""
    units = _traced(rec)
    if not units:
        return None
    loops = rec["unet_stages"]
    return sum(unit_seconds(u) - sum(u["stages"].get(s, 0.0) for s in loops)
               for u in units) / len(units)


def unet_step_ms(rec: Dict) -> Optional[float]:
    """The UNet loops' stage seconds over the steps they take."""
    units = _traced(rec)
    loops = rec["unet_stages"]
    steps = sum(loops.values()) * len(units)
    if not units or not steps:
        return None
    return sum(u["stages"].get(s, 0.0) for u in units for s in loops) / steps * 1e3


def mfu(rec: Dict) -> Optional[float]:
    """Model FLOPs of every unit completed in the window, over the window's
    seconds at the chip's dense bf16 peak, in %; the profiled unit's work
    and time are left out of both."""
    units = rec["units"]
    work = sum(f for u, f in zip(units, rec["unit_flops"]) if not u.get("profiled"))
    seconds = rec["window_s"] - sum(unit_seconds(u) for u in units if u.get("profiled"))
    if not work or seconds <= 0:
        return None
    return work / (seconds * rec["peak_flops"]) * 100.0


def roofline(rec: Dict, kind: str) -> Optional[float]:
    """The profiled unit's least time for a kernel's calls over its device
    time, in %."""
    prof = rec["profile"]
    bound = rec["kernel_bounds_s"].get(kind)
    if prof is None or not bound or not prof["kernel_s"].get(kind):
        return None
    return bound / prof["kernel_s"][kind] * 100.0


def idle_share(rec: Dict) -> Optional[float]:
    """The share of the profiled unit in which no kernel ran, in %."""
    prof = rec["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0

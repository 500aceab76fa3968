"""Profiling and benchmark helpers."""

from .benchmarks import compare_timings, time_device_fn, welch_t_test
from .profiling import (
    Phase,
    phase_report,
    profile_decode,
    profile_device_encode,
    trace,
)

__all__ = [
    "compare_timings", "time_device_fn", "welch_t_test",
    "trace", "Phase", "phase_report", "profile_decode",
    "profile_device_encode",
]

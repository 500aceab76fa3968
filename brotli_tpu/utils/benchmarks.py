"""Benchmark harness: significance testing and device timing.

The reference's decode bench builds Welch's t-test comparison into the
benchmark itself (bench/decode.bench.ts:148-177) so speedups are only
reported when statistically significant; `welch_t_test`/`compare_timings`
mirror that machinery.  `time_device_fn` times a call with the host clock
around `block_until_ready`, warm-up outside the window.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass


def welch_t_test(a: list[float], b: list[float]) -> tuple[float, float]:
    """Welch's unequal-variance t-test; returns (t, dof)."""
    na, nb = len(a), len(b)
    if na < 2 or nb < 2:
        raise ValueError(
            f"welch_t_test needs >=2 samples per side (got {na}, {nb})"
        )
    ma = sum(a) / na
    mb = sum(b) / nb
    va = sum((x - ma) ** 2 for x in a) / (na - 1)
    vb = sum((x - mb) ** 2 for x in b) / (nb - 1)
    sa, sb = va / na, vb / nb
    denom = math.sqrt(sa + sb) or 1e-12
    t = (ma - mb) / denom
    dof_num = (sa + sb) ** 2
    dof_den = (sa * sa) / (na - 1) + (sb * sb) / (nb - 1)
    dof = dof_num / dof_den if dof_den else float(na + nb - 2)
    return t, dof


@dataclass
class Comparison:
    mean_a: float
    mean_b: float
    speedup: float
    t_stat: float
    dof: float
    significant: bool


def compare_timings(a: list[float], b: list[float],
                    t_critical: float = 2.0) -> Comparison:
    """Compare two timing samples; significant when |t| > t_critical
    (~alpha 0.05 for reasonable sample sizes, as the reference uses).

    Samples too small for a t-test (n < 2) report means only, never
    significance."""
    if not a or not b:
        raise ValueError("compare_timings needs non-empty samples")
    ma = sum(a) / len(a)
    mb = sum(b) / len(b)
    if len(a) < 2 or len(b) < 2:
        return Comparison(
            mean_a=ma, mean_b=mb,
            speedup=ma / mb if mb else float("inf"),
            t_stat=float("nan"), dof=0.0, significant=False,
        )
    t, dof = welch_t_test(a, b)
    return Comparison(
        mean_a=ma, mean_b=mb,
        speedup=ma / mb if mb else float("inf"),
        t_stat=t, dof=dof, significant=abs(t) > t_critical,
    )


def time_device_fn(fn, *args, samples: int = 3, warmup: int = 1) -> float:
    """Best-of-`samples` wall seconds of `fn(*args)` up to the end of its
    device work (`jax.block_until_ready` on the result).  `warmup` calls
    before the window absorb compilation."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(samples):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best

"""Benchmark/profiling helpers."""

from brotli_tpu.utils import compare_timings, welch_t_test, time_device_fn


def test_welch_t_test_detects_difference():
    a = [1.00, 1.02, 0.99, 1.01, 1.00]
    b = [0.50, 0.51, 0.49, 0.50, 0.52]
    t, dof = welch_t_test(a, b)
    assert abs(t) > 10
    c = compare_timings(a, b)
    assert c.significant and c.speedup > 1.9


def test_welch_t_test_no_difference():
    a = [1.00, 1.02, 0.99, 1.01, 1.03]
    b = [1.01, 1.00, 1.02, 0.98, 1.02]
    c = compare_timings(a, b)
    assert not c.significant


def test_time_device_fn_runs():
    import jax
    import jax.numpy as jnp

    calls = []

    @jax.jit
    def f(a):
        return a * 2 + 1

    def fn(a):
        calls.append(1)
        return f(a)

    x = jnp.arange(1024, dtype=jnp.int32).reshape(8, 128)
    dt = time_device_fn(fn, x, samples=2, warmup=1)
    assert dt > 0
    assert len(calls) == 3      # warm-up outside the timed samples

"""Smoke coverage for the CLI commands and the profiling utilities."""

import subprocess
import sys

import jax
import jax.numpy as jnp


def _run_cli(*args: str) -> str:
    out = subprocess.run(
        [sys.executable, "-m", "anemoi_models_tpu", *args],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": "", "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/opt/venv/bin"},
        cwd=__file__.rsplit("/tests/", 1)[0],
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_cli_hello():
    assert "hello" in _run_cli("hello").lower()


def test_cli_info():
    out = _run_cli("info")
    assert "jax" in out.lower()


def test_step_timer_and_annotate():
    from anemoi_models_tpu.utils.profiling import StepTimer, annotate

    with annotate("unit-test-region"):
        y = jnp.sum(jnp.ones((8, 8)))
    t = StepTimer(items_per_step=64, warmup=0)
    with t:
        float(jax.jit(lambda v: v * 2)(y))
    assert t.mean_step_s() > 0
    assert t.items_per_s() > 0
    assert "items/s" in t.summary()


def test_trace_writes_xplane(tmp_path):
    from anemoi_models_tpu.utils.profiling import trace

    with trace(str(tmp_path), enabled=True):
        float(jnp.sum(jnp.arange(16.0)))
    # a plugins/profile directory with at least one artifact appears
    produced = list(tmp_path.rglob("*"))
    assert produced, "profiler trace produced no files"

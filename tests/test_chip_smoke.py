"""The GPU entry points off the card: ``chip_smoke.py``'s phase selection,
device check and result line, the ``nvidia-smi`` parser, the H100 peak
table, the compile-cache location and remat "auto" without a memory
budget."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize(
    "argv,expected",
    [
        ([], ["device", "train", "forecast", "flavors", "references"]),
        (["--multichip"], ["device", "multichip"]),
        (["--rehearse"], ["device", "train", "forecast", "flavors", "references"]),
        (["--multichip", "--rehearse"], ["device", "multichip"]),
    ],
)
def test_phase_selection(smoke, argv, expected):
    assert smoke.phases(smoke.parse_args(argv)) == expected


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_exact_form(smoke, count):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count, "extra": 1}
    line = smoke.result_line(dev)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", '
        f'"count": {count}}}}}'
    )
    assert "\n" not in line and json.loads(line)["device"]["count"] == count


def test_device_phase_refuses_cpu(smoke):
    with pytest.raises(SystemExit, match="not the GPU"):
        smoke.phase_device(smoke.parse_args([]))


def _run_script(cwd, env_extra=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_script_exits_nonzero_without_gpu():
    out = _run_script(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_script_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_script(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "text,expected",
    [
        ("NVIDIA H100 80GB HBM3, 400.00 W\n", [("NVIDIA H100 80GB HBM3", "400.00 W")]),
        ("NVIDIA H100 PCIe, 350.00 W", [("NVIDIA H100 PCIe", "350.00 W")]),
        ("NVIDIA H100 80GB HBM3, 700.00 W\n" * 4, [("NVIDIA H100 80GB HBM3", "700.00 W")] * 4),
    ],
)
def test_parse_nvidia_smi(text, expected):
    from anemoi_models_tpu.utils.device import parse_nvidia_smi

    assert parse_nvidia_smi(text) == expected


@pytest.mark.parametrize("text", ["", "NVIDIA H100 80GB HBM3", ", 400.00 W"])
def test_parse_nvidia_smi_rejects_malformed(text):
    from anemoi_models_tpu.utils.device import parse_nvidia_smi

    with pytest.raises(ValueError):
        parse_nvidia_smi(text)


@pytest.mark.parametrize(
    "kind,peaks",
    [("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)), ("NVIDIA H100 PCIe", (756e12, 2.0e12))],
)
def test_h100_peaks(kind, peaks):
    import bench

    assert bench.device_peaks(kind) == peaks


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_peaks_raise(kind):
    import bench

    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks(kind)


@pytest.fixture
def restore_cache_config():
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, restore_cache_config):
    import jax

    from anemoi_models_tpu.utils.compile_cache import configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert configure_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the variable itself


def test_compile_cache_fixed_path_in_checkout(monkeypatch, restore_cache_config):
    import jax

    from anemoi_models_tpu.utils.compile_cache import configure_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = configure_compile_cache()
    assert first == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_same_path_every_call(monkeypatch, restore_cache_config):
    from anemoi_models_tpu.utils.compile_cache import configure_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert configure_compile_cache() == configure_compile_cache()


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 123}])
def test_remat_auto_without_budget_is_full(monkeypatch, stats):
    """No reported budget means the safe "full": no size is assumed."""
    import jax
    import optax

    from anemoi_models_tpu.training.step import resolve_remat_policy

    monkeypatch.setattr(jax, "local_devices", lambda: [_Device(stats)])
    msgs = []
    got = resolve_remat_policy(None, optax.adam(1e-3), (1, 2, 1, 8, 3), (1, 1, 8, 2), log=msgs.append)
    assert got == "full"
    assert any("unknown device memory budget" in m for m in msgs)

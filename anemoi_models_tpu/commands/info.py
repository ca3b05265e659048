"""Environment/device info command."""

from __future__ import annotations

from anemoi_models_tpu.commands import register_command


@register_command("info")
class Info:
    """Print versions and visible accelerator devices."""

    def add_arguments(self, parser) -> None:
        pass

    def run(self, args) -> int:
        import os

        import jax

        import anemoi_models_tpu
        from anemoi_models_tpu import native

        print(f"anemoi-models-tpu {anemoi_models_tpu.__version__}")
        print(f"jax {jax.__version__}")
        print(f"backend: {jax.default_backend()}")
        for d in jax.devices():
            print(f"  {d}")
        print(f"native graph kernels: {'available' if native.available() else 'numpy fallbacks'}")
        knobs = (
            "ANEMOI_INFERENCE_NUM_CHUNKS", "ANEMOI_ADJOINT_CHUNK_BYTES",
            "JAX_COMPILATION_CACHE_DIR",
        )
        active = {k: os.environ[k] for k in knobs if k in os.environ}
        if active:
            print("env knobs:", ", ".join(f"{k}={v}" for k, v in active.items()))
        return 0

"""anemoi-models-tpu: a JAX weather-emulator model framework for the GPU.

A from-scratch JAX/XLA re-design of the capabilities of
``ecmwf/anemoi-models`` (encoder-processor-decoder graph architectures for
data-driven weather forecasting): modules (``anemoi_models_tpu.nn``) over
batched static graphs, ``jax.sharding`` device meshes instead of NCCL
process groups, degree-bucketed gathers and blockwise attention instead of
torch_geometric scatter / flash-attn, and ``jax.checkpoint``
rematerialization instead of torch activation checkpointing.
"""

__version__ = "0.5.1"

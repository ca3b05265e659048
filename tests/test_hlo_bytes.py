"""utils/hlo_bytes: post-fusion HBM traffic accounting (the bench roofline
denominator — replaces cost_analysis()'s pre-fusion overcount)."""

import jax
import jax.numpy as jnp
import pytest

from anemoi_models_tpu.utils.hlo_bytes import hbm_bytes


def test_elementwise_chain_counts_once():
    # four fused tanh(+1) links must cost ONE read + ONE write, not eight
    x = jnp.ones((1024, 1024), jnp.float32)  # 4 MiB

    @jax.jit
    def g(x):
        for _ in range(4):
            x = jnp.tanh(x) + 1
        return x

    nb = hbm_bytes(jax.jit(g).lower(x).compile().as_text())
    assert nb == 2 * x.nbytes


def test_operand_reads_are_charged():
    x = jnp.ones((512, 512), jnp.float32)

    @jax.jit
    def f(a, b):
        return a @ b

    nb = hbm_bytes(jax.jit(f).lower(x, x).compile().as_text())
    # two operand reads + one result write, all 1 MiB
    assert nb == 3 * x.nbytes


def test_malformed_text_rejected():
    with pytest.raises(ValueError, match="ENTRY"):
        hbm_bytes("HloModule nothing_here")


def test_layout_annotations_parse():
    # scheduled modules can carry tiling/memory-space suffixes inside the
    # layout braces (``{1,0:T(8,128)(2,1)S(1)}``); the round-4 regex parser
    # silently returned 0 on them and the bench lost its roofline
    text = """HloModule m, is_scheduled=true

ENTRY %main.2 (a.1: bf16[1024,1024]) -> bf16[1024,1024] {
  %a.1 = bf16[1024,1024]{1,0:T(8,128)(2,1)} parameter(0)
  ROOT %t = bf16[1024,1024]{1,0:T(8,128)(2,1)S(1)} tanh(%a.1)
}
"""
    assert hbm_bytes(text) == 2 * 1024 * 1024 * 2  # one read + one write


def test_windowed_ops_charge_window_not_operand():
    # dynamic-slice reads only its result-sized window; dynamic-update-slice
    # executes in place (one read + one write of the update). Charging full
    # operands put the O96 train step at a meaningless 116% of roofline.
    mb = 1024 * 1024  # f32[512,512] = 1 MiB
    text = """HloModule m

ENTRY %main (p0: f32[512,512]) -> f32[16,512] {
  %p0 = f32[512,512]{1,0} parameter(0)
  %c0 = s32[]{:T(256)} constant(0)
  ROOT %ds = f32[16,512]{1,0} dynamic-slice(%p0, %c0, %c0), dynamic_slice_sizes={16,512}
}
"""
    # window read + result write (+ the two s32[] index operands)
    assert hbm_bytes(text) == 2 * 16 * 512 * 4 + 8

    text2 = """HloModule m

ENTRY %main (p0: f32[512,512], u: f32[16,512]) -> f32[512,512] {
  %p0 = f32[512,512]{1,0} parameter(0)
  %u = f32[16,512]{1,0} parameter(1)
  %c0 = s32[]{:T(256)} constant(0)
  ROOT %dus = f32[512,512]{1,0} dynamic-update-slice(%p0, %u, %c0, %c0)
}
"""
    assert hbm_bytes(text2) == 2 * 16 * 512 * 4  # update read + update write
    del mb

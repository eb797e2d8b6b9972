"""The numerics of the tensor-core attention (K4/K8, ``csrc/attention_tile.cuh``)
on the CPU: the TF32 roundings, and why the kernel runs each fp32 product as
three TF32 passes.

A TF32 operand keeps 10 mantissa bits. The kernel splits every fp32 operand
x into big and small and accumulates ``a_small·b_big + a_big·b_small +
a_big·b_big``. The tensor core reads the top 19 bits of an operand, so the
kernel hands it x itself (read as ``tf32_trunc(x)``) and ``x -
tf32_trunc(x)`` (read truncated again). The scheme first designed for it
rounds instead: ``big = tf32_rna(x)``, ``small = tf32_rna(x - big)``
(``cvt.rna.tf32.f32``). Here both products of the attention are emulated in
each scheme (exact accumulation in float64, the softmax in float32 as the
kernel runs it) and held to the card check's tolerance, 1e-4 × max(1, max
|ref|), against a float64 reference and against the JAX package's
``_einsum_attention_from_qkv`` at full fp32 precision. One TF32 pass misses
that tolerance at the same inputs; each assertion message gives the margin.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models.clip import pallas_attention as jattn


def _as_int32(bits: torch.Tensor) -> torch.Tensor:
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round the fp32 magnitude to 10 mantissa bits, to
    nearest, ties away from zero (add half a TF32 ulp, clear the low 13
    bits). The sign bit is kept as it is."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000
    return _as_int32((bits & 0x80000000) | mag).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 operand: its low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFE000
    return _as_int32(bits).view(torch.float32)


def _from_bits(bits: list[int]) -> torch.Tensor:
    return _as_int32(torch.tensor(bits, dtype=torch.int64)).view(torch.float32)


@pytest.mark.parametrize("x,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 number
    (0x3F800FFF, 0x3F800000),  # below half an ulp: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero (to nearest even would go down)
    (0xBF801000, 0xBF802000),  # the negative tie: away from zero too
    (0x3F803000, 0x3F804000),  # a tie whose lower neighbour is odd
    (0x3F801001, 0x3F802000),  # just above half an ulp: up
    (0x3FFFF000, 0x40000000),  # the carry runs into the exponent: 2.0
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x7F7FFFFF, 0x7F800000),  # the largest float rounds to infinity
])
def test_tf32_rna_on_bit_patterns(x, want):
    got = tf32_rna(_from_bits([x])).view(torch.int32).to(torch.int64).item() & 0xFFFFFFFF
    assert got == want, f"tf32_rna(0x{x:08x}) = 0x{got:08x}, want 0x{want:08x}"


@pytest.mark.parametrize("x,want", [
    (0x3F801FFF, 0x3F800000),  # just under 1 + 2^-10: down to 1.0
    (0xBF801800, 0xBF800000),  # toward zero for a negative number too
    (0x3F802000, 0x3F802000),  # a TF32 number stays
])
def test_tf32_trunc_on_bit_patterns(x, want):
    got = tf32_trunc(_from_bits([x])).view(torch.int32).to(torch.int64).item() & 0xFFFFFFFF
    assert got == want, f"tf32_trunc(0x{x:08x}) = 0x{got:08x}, want 0x{want:08x}"


def test_tf32_rna_is_nearest_with_ten_mantissa_bits():
    x = torch.as_tensor(np.random.RandomState(0).randn(100_000).astype(np.float32) * 1e3)
    r = tf32_rna(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 11)  # 2^(e - 10) for |x| in [2^(e-1), 2^e)
    err = (r.double() - x.double()).abs()
    assert (err <= ulp.double() / 2).all()
    assert (x - r).abs().max() > 0  # it rounds: not the identity


ROUNDINGS = {"trunc": tf32_trunc, "rna": tf32_rna}


def _mm3(rnd):
    """fp32 a @ b in three TF32 passes, the small terms summed first."""
    def mm(a, b):
        ab, bb = rnd(a), rnd(b)
        as_, bs = rnd(a - ab), rnd(b - bb)
        return (as_.double() @ bb.double() + ab.double() @ bs.double()) + ab.double() @ bb.double()
    return mm


def _mm1(rnd):
    """One TF32 pass."""
    return lambda a, b: rnd(a).double() @ rnd(b).double()


def _heads(qkv: torch.Tensor, heads: int):
    b, t, d3 = qkv.shape
    return (z.reshape(b, t, heads, 64).transpose(1, 2) for z in qkv.split(d3 // 3, dim=-1))


def _emulated(qkv: torch.Tensor, heads: int, mm) -> torch.Tensor:
    """The kernel's arithmetic: s = (q / 8) k^T through ``mm`` into fp32
    accumulators, an fp32 softmax with the row max subtracted, the unscaled
    weights times v through ``mm``, divided by the row sum."""
    q, k, v = _heads(qkv, heads)
    s = mm(q * 0.125, k.transpose(-1, -2)).float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm(p, v).float() / p.sum(-1, keepdim=True)
    b, _, t, _ = o.shape
    return o.transpose(1, 2).reshape(b, t, -1)


def _reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    q, k, v = (z.double() for z in _heads(qkv, heads))
    o = torch.softmax((q / 8) @ k.transpose(-1, -2), dim=-1) @ v
    b, _, t, _ = o.shape
    return o.transpose(1, 2).reshape(b, t, -1)


@pytest.mark.parametrize("rounding", ["trunc", "rna"])  # the kernel's, the first design's
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_three_tf32_passes_hold_the_fp32_tolerance_where_one_does_not(scale, rounding):
    b, t, heads = 2, 257, 16  # ViT-L/14's length and heads
    qkv_np = (scale * np.random.RandomState(7).randn(b, t, 3 * heads * 64)).astype(np.float32)
    qkv = torch.as_tensor(qkv_np)
    ref = _reference(qkv, heads)
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    with jax.default_matmul_precision("highest"):
        jax_out = torch.as_tensor(np.array(
            jattn._einsum_attention_from_qkv(jnp.asarray(qkv_np), heads))).double()
    three = _emulated(qkv, heads, _mm3(ROUNDINGS[rounding])).double()
    one = _emulated(qkv, heads, _mm1(ROUNDINGS[rounding])).double()
    err3 = (three - ref).abs().max().item()
    err3_jax = (three - jax_out).abs().max().item()
    err1 = (one - ref).abs().max().item()
    assert err3 <= tol, f"3xTF32 ({rounding}) misses float64 by {err3:.3e} > {tol:.3e} (x{scale})"
    assert err3_jax <= tol, f"3xTF32 misses JAX's fp32 einsum by {err3_jax:.3e} > {tol:.3e}"
    assert err1 > tol, (f"one TF32 pass was expected to miss the tolerance, but erred by "
                        f"{err1:.3e} <= {tol:.3e} (x{scale}); 3xTF32 erred by {err3:.3e}")
    assert err3 <= tol / 10, f"3xTF32 keeps less than a 10x margin: {err3:.3e} vs {tol:.3e}"

"""The numerics of the tensor-core GEMM shared by K2 and K5
(``csrc/gemm_tf32x3.cuh``) on the CPU: both halves of a resblock computed
with the kernels' arithmetic, held against the JAX package's references.

The GEMM splits every fp32 operand x into big = trunc(x) (TF32) and small =
x - big, which the tensor core reads truncated again, and runs each k-step
of 8 (one ``wgmma.m64n128k8``) as three passes: ``a_small·b_big``, then
``a_big·b_small``, then ``a_big·b_big``. A slice of 32 columns (4 k-steps,
12 passes) accumulates in a sum of its own that starts at zero; the threads
then add it to the running fp32 sum, rounded to nearest. Here each pass's 8
products are summed exactly and the slice's sum is rounded to fp32 after
every pass, to nearest or toward zero: the tensor core's adder truncates,
and the worse of the two is what the card can do. Without the slice sums,
one truncating accumulator over K = 4,096 drifts by ~1.5e-4 of the result,
about what an H100 shows for a GEMM that keeps the whole sum in its
accumulator. The LayerNorm is
applied as the kernel applies it to A in shared memory, ``fma(fma(x, rstd,
-mean·rstd), γ, β)``; the epilogue adds the bias in fp32, then QuickGELU or
the residual; the attention runs the three-pass emulation of
``test_torch_tf32_split.py``.

The MLP half runs at D = 1024, 4D = 4096 (ViT-L/14's vision tower: its
second product sums 4,096 terms), the attention half at D = 768 (ViT-B/32's
vision tower and ViT-L/14's text tower, causal), on a few rows drawn with
numpy from a seed. Each is held to the card check's tolerance, 1e-4 ×
max(1, max |ref|), against a float64 reference and against the JAX
package's ``_mlp_block_ref`` / ``_attn_block_ref`` at full fp32 precision;
one TF32 pass misses it at the same inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models.clip.pallas_block import _attn_block_ref, _mlp_block_ref, _row
from test_torch_tf32_split import _heads, _mm1, _mm3, tf32_trunc

EPS = 1e-5


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the fp32 value next to it on the side of zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


ROUND = {"nearest": lambda x: x.float(), "toward_zero": _toward_zero}


def test_toward_zero_rounds_to_the_fp32_neighbour_nearer_zero():
    x = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 1.0 - 2.0 ** -30, 3.0],
                     dtype=torch.float64)
    got = _toward_zero(x)
    want = torch.tensor([1.0, -1.0, 1.0 - 2.0 ** -24, 3.0], dtype=torch.float32)
    assert torch.equal(got, want), got


SLICE = 32  # columns a slice; 4 k-steps of 8


def gemm(a: torch.Tensor, w: torch.Tensor, passes: int, accumulate: str,
         slice_sums: bool = True) -> torch.Tensor:
    """fp32 a [M, K] @ w [N, K]^T as the kernel runs it (module docstring);
    ``passes`` 3, or 1 for a single TF32 pass; without ``slice_sums`` one
    accumulator takes every pass, as a plain tensor-core loop would."""
    m, k = a.shape
    n = w.shape[0]
    a_big, w_big = tf32_trunc(a), tf32_trunc(w)
    a_small, w_small = tf32_trunc(a - a_big), tf32_trunc(w - w_big)
    terms = [(a_small, w_big), (a_big, w_small), (a_big, w_big)] if passes == 3 else [(a_big, w_big)]
    steps = [torch.einsum("mgk,ngk->gmn", x.double().view(m, -1, 8), y.double().view(n, -1, 8))
             for x, y in terms]
    rnd = ROUND[accumulate]
    acc = torch.zeros((m, n), dtype=torch.float32)
    part = torch.zeros((m, n), dtype=torch.float32)
    for g in range(k // 8):
        if slice_sums and g % (SLICE // 8) == 0:
            acc, part = (acc.double() + part.double()).float(), torch.zeros_like(part)
        for step in steps:
            part = rnd(part.double() + step[g])
    return (acc.double() + part.double()).float() if slice_sums else part


def test_slice_sums_hold_back_the_truncating_adder():
    """Why the kernel sums each slice apart: with an adder that truncates,
    one accumulator over 4,096 terms drifts several times further than the
    slice sums added with rounding."""
    rng = np.random.RandomState(3)
    a = torch.as_tensor(rng.randn(16, 4096).astype(np.float32))
    w = torch.as_tensor((rng.randn(256, 4096) / 64).astype(np.float32))
    ref = a.double() @ w.double().T
    one = (gemm(a, w, 3, "toward_zero", slice_sums=False).double() - ref).abs().max().item()
    sliced = (gemm(a, w, 3, "toward_zero").double() - ref).abs().max().item()
    assert sliced * 4 < one, f"slice sums err {sliced:.3e}, one accumulator {one:.3e}"


def _fma(x, y, z):
    return (x.double() * y.double() + z.double()).float()


def _ln_on_load(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ln_stats.cuh's (mean, rstd) in fp32, applied as the GEMM loads A."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + EPS)
    return _fma(_fma(x, rstd, -mean * rstd), g, b)


def _ln64(x, g, b):
    x = x.double()
    y = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, keepdim=True, correction=0) + EPS)
    return y * g.double() + b.double()


def _weights(rng, *shape, fan_in):
    return torch.as_tensor((rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32))


def _affine(rng, n):
    return (torch.as_tensor((1 + 0.1 * rng.randn(n)).astype(np.float32)),
            torch.as_tensor((0.1 * rng.randn(n)).astype(np.float32)))


def _jax(x):
    return jnp.asarray(x.numpy())


def _tolerance(ref: torch.Tensor) -> float:
    return 1e-4 * max(1.0, ref.abs().max().item())


def _hold(three, one, ref64, ref_jax, what):
    tol = _tolerance(ref64)
    err3 = (three.double() - ref64).abs().max().item()
    err3_jax = (three.double() - ref_jax).abs().max().item()
    err1 = (one.double() - ref64).abs().max().item()
    assert err3 <= tol, f"{what}: 3xTF32 misses float64 by {err3:.3e} > {tol:.3e}"
    assert err3_jax <= tol, f"{what}: 3xTF32 misses JAX's fp32 reference by {err3_jax:.3e} > {tol:.3e}"
    assert err1 > tol, (f"{what}: one TF32 pass was expected to miss the tolerance, but erred by "
                        f"{err1:.3e} <= {tol:.3e}; 3xTF32 erred by {err3:.3e}")


@pytest.mark.parametrize("accumulate", ["nearest", "toward_zero"])
def test_mlp_half_in_3xtf32_holds_the_fp32_tolerance_where_one_pass_does_not(accumulate):
    d, d4, rows = 1024, 4096, 6  # ViT-L/14's vision tower
    rng = np.random.RandomState(21)
    x = torch.as_tensor(rng.randn(1, rows, d).astype(np.float32))
    g, b = _affine(rng, d)
    fc_w, proj_w = _weights(rng, d4, d, fan_in=d), _weights(rng, d, d4, fan_in=d4)
    fc_b = torch.as_tensor((0.1 * rng.randn(d4)).astype(np.float32))
    proj_b = torch.as_tensor((0.1 * rng.randn(d)).astype(np.float32))

    def kernel(passes):
        x2 = x.view(rows, d)
        h = gemm(_ln_on_load(x2, g, b), fc_w, passes, accumulate) + fc_b
        h = h / (1 + torch.exp(-1.702 * h))
        return (x2 + (gemm(h, proj_w, passes, accumulate) + proj_b)).view(1, rows, d)

    h64 = _ln64(x, g, b) @ fc_w.double().T + fc_b.double()
    h64 = h64 * torch.sigmoid(1.702 * h64)
    ref64 = x.double() + h64 @ proj_w.double().T + proj_b.double()
    with jax.default_matmul_precision("highest"):
        ref_jax = _mlp_block_ref(_jax(x), _jax(fc_w.T), _row(_jax(fc_b), jnp.float32),
                                 _jax(proj_w.T), _row(_jax(proj_b), jnp.float32),
                                 _row(_jax(g), jnp.float32), _row(_jax(b), jnp.float32), EPS)
    _hold(kernel(3), kernel(1), ref64, torch.as_tensor(np.array(ref_jax)).double(),
          f"MLP half, D={d}, {accumulate}")


def _attention(qkv: torch.Tensor, heads: int, causal: bool, mm) -> torch.Tensor:
    """K4's body as test_torch_tf32_split.py emulates it, with the causal
    mask: scores through ``mm`` into fp32, an fp32 softmax, weights times v
    through ``mm``, divided by the row sum."""
    q, k, v = _heads(qkv, heads)
    s = mm(q * 0.125, k.transpose(-1, -2)).float()
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm(p, v).float() / p.sum(-1, keepdim=True)
    bsz, _, t, _ = o.shape
    return o.transpose(1, 2).reshape(bsz, t, -1)


@pytest.mark.parametrize("causal", [False, True])  # ViT-B/32 vision, ViT-L/14 text
@pytest.mark.parametrize("accumulate", ["nearest", "toward_zero"])
def test_attention_half_in_3xtf32_holds_the_fp32_tolerance_where_one_pass_does_not(
        causal, accumulate):
    d, heads, bsz, t = 768, 12, 2, 9
    rng = np.random.RandomState(22)
    x = torch.as_tensor(rng.randn(bsz, t, d).astype(np.float32))
    g, b = _affine(rng, d)
    w_qkv, w_out = _weights(rng, 3 * d, d, fan_in=d), _weights(rng, d, d, fan_in=d)
    b_qkv = torch.as_tensor((0.1 * rng.randn(3 * d)).astype(np.float32))
    b_out = torch.as_tensor((0.1 * rng.randn(d)).astype(np.float32))

    def kernel(passes):
        x2 = x.view(bsz * t, d)
        qkv = gemm(_ln_on_load(x2, g, b), w_qkv, passes, accumulate) + b_qkv
        mm = _mm3(tf32_trunc) if passes == 3 else _mm1(tf32_trunc)
        attn = _attention(qkv.view(bsz, t, 3 * d), heads, causal, mm).view(bsz * t, d)
        return (x2 + (gemm(attn, w_out, passes, accumulate) + b_out)).view(bsz, t, d)

    qkv64 = _ln64(x, g, b) @ w_qkv.double().T + b_qkv.double()
    q, k, v = _heads(qkv64, heads)
    s = (q / 8) @ k.transpose(-1, -2)
    if causal:
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(bsz, t, d)
    ref64 = x.double() + o @ w_out.double().T + b_out.double()
    with jax.default_matmul_precision("highest"):
        ref_jax = _attn_block_ref(_jax(x), _jax(w_qkv.T), _row(_jax(b_qkv), jnp.float32),
                                  _jax(w_out.T), _row(_jax(b_out), jnp.float32),
                                  _row(_jax(g), jnp.float32), _row(_jax(b), jnp.float32),
                                  heads, causal, EPS)
    _hold(kernel(3), kernel(1), ref64, torch.as_tensor(np.array(ref_jax)).double(),
          f"attention half, D={d}, causal={causal}, {accumulate}")

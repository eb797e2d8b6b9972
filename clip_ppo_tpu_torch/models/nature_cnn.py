"""Nature-CNN trunk as functions over a params dict.

Port of ``clip_ppo_tpu/models/nature_cnn.py``: the conv(8/4)-conv(4/2)-
conv(3/1)-dense(512) trunk of the reference's ``Agent``
(`ppo_minigrid.py:128-162`) with orthogonal initialization (std sqrt(2);
actor 0.01, critic 1.0) and ReLU. Observations stay NHWC at this
interface; conv weights are stored in PyTorch's OIHW layout and dense
weights as ``[in, out]`` (applied as ``x @ w + b``). The conv output is
flattened in (h, w, c) order, as the JAX package's NHWC flatten does, so
the fc weights carry across unchanged.

``nature_cnn_view`` is the raw-view fast path: the same trunk over the
7×7 MiniGrid view, with conv1 reformulated on the view's tiles. Both
compute in float32 (the JAX docstring's bf16 note is a TPU concern).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

Params = dict


def _orthogonal(gen: torch.Generator, fan_in: int, fan_out: int, scale: float,
                device) -> torch.Tensor:
    """[fan_in, fan_out] with orthonormal columns times ``scale``
    (torch.nn.init.orthogonal_ as the reference's `layer_init` uses it)."""
    w = torch.empty(fan_out, fan_in)
    torch.nn.init.orthogonal_(w, gain=scale, generator=gen)
    return w.T.contiguous().to(device)


def init_conv(gen, kh: int, kw: int, cin: int, cout: int, device,
              scale: float = float(np.sqrt(2))) -> Params:
    hwio = _orthogonal(gen, kh * kw * cin, cout, scale, device).reshape(kh, kw, cin, cout)
    return {"w": hwio.permute(3, 2, 0, 1).contiguous(),  # OIHW
            "b": torch.zeros(cout, device=device)}


def init_dense(gen, din: int, dout: int, device, scale: float = float(np.sqrt(2))) -> Params:
    return {"w": _orthogonal(gen, din, dout, scale, device),
            "b": torch.zeros(dout, device=device)}


def conv(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW VALID convolution."""
    return F.conv2d(x, p["w"], p["b"], stride=stride)


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def init_nature_cnn(gen, in_channels: int, device, hidden: int = 512) -> Params:
    return {
        "conv1": init_conv(gen, 8, 8, in_channels, 32, device),
        "conv2": init_conv(gen, 4, 4, 32, 64, device),
        "conv3": init_conv(gen, 3, 3, 64, 64, device),
        "fc": init_dense(gen, 64 * 7 * 7, hidden, device),
    }


def _trunk_after_conv1(p: Params, x: torch.Tensor) -> torch.Tensor:
    """NCHW conv1 activations → [B, hidden] features (post-ReLU)."""
    x = F.relu(conv(p["conv2"], x, 2))
    x = F.relu(conv(p["conv3"], x, 1))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) flatten
    return F.relu(dense(p["fc"], x))


def nature_cnn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, 84, 84, C] float in [0,1] → [B, hidden] features (post-ReLU)."""
    x = F.relu(conv(p["conv1"], x.permute(0, 3, 1, 2), 4))
    return _trunk_after_conv1(p, x)


def _phase_masks(upscale: int, kernel: int = 8, stride: int = 4) -> np.ndarray:
    """Tile-offset selection masks for conv1 over a ×``upscale``
    nearest-neighbor image.

    Output column i of the strided conv reads pixels ``stride·i + u``; on a
    nearest-upscaled image pixel p carries tile ``p // upscale``, so
    relative to tile ``(stride·i) // upscale`` the window touches offsets
    ``off[r][u] = ((stride·i) % upscale + u) // upscale``, which depend on
    i only through the phase ``r = i mod (upscale/gcd(upscale, stride))``.
    Returns one-hot masks [P, 2, K] with m[r, off[r][u], u] = 1.
    """
    period = upscale // math.gcd(upscale, stride)
    off = np.array([[((stride * r) % upscale + u) // upscale for u in range(kernel)]
                    for r in range(period)])
    if off.max() > 1:
        raise ValueError(f"a {kernel}-wide window at stride {stride} spans more than 2 "
                         f"tiles of {upscale}")
    m = np.zeros((period, 2, kernel), np.float32)
    for r in range(period):
        for u in range(kernel):
            m[r, off[r, u], u] = 1.0
    return m


def view_conv1_weights(p: Params, upscale: int, v_scale: float = 1.0) -> torch.Tensor:
    """conv1's weights summed per (phase, tile offset) and scaled by
    ``v_scale``: W2[r, s, d, e, c, o] = Σ_{u,v} m[r,d,u] m[s,e,v] w[o,c,u,v]
    · v_scale. Linear in the weights, so autograd through it gives the
    dense conv's gradients. It depends on the params alone: a rollout,
    whose params are fixed, computes it once and passes it to every step
    (:func:`nature_cnn_view`'s ``w2``)."""
    w1 = p["conv1"]["w"]  # OIHW
    m = torch.as_tensor(_phase_masks(upscale), dtype=w1.dtype, device=w1.device)
    return torch.einsum("rdu,sev,ocuv->rsdeco", m, m, w1 * v_scale)


def nature_cnn_view(p: Params, v: torch.Tensor, upscale: int, v_scale: float = 1.0,
                    w2: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 7, 7, C] float view → [B, hidden]; equal to
    ``nature_cnn(p, nearest_upscale(v, upscale) * v_scale)`` with conv1
    reformulated.

    MiniGrid observations are a ×12 nearest upscale of the 7×7 symbolic
    view (ImgObsWrapper + ResizeObservation, `ppo_minigrid.py:110-114`), so
    every conv1 weight multiplies its pixel's TILE value: the 84×84 conv
    collapses to a per-phase contraction of tile-summed weights
    (:func:`view_conv1_weights`, or ``w2`` when the caller computed it)
    with the raw view — ~14× fewer FLOPs and no 84×84 buffers. Pass the raw
    integer-coded view and ``v_scale = 1/255`` (the observation scale folded
    into the pre-sum). Everything is float32.
    """
    if w2 is None:
        w2 = view_conv1_weights(p, upscale, v_scale)
    bsz, vs = v.shape[0], v.shape[1]
    # Each tile with its right, lower and lower-right neighbours (zero past
    # the view): [B, V, V, C, 2, 2], a strided view of the padded input.
    v4 = F.pad(v, (0, 0, 0, 1, 0, 1)).unfold(1, 2, 1).unfold(2, 2, 1)
    out = torch.einsum("bxycde,rsdeco->bxryso", v4, w2)       # [B, V, P, V, P, O]
    osz = (vs * upscale - 8) // 4 + 1
    per = w2.shape[0]
    out = out.reshape(bsz, vs * per, vs * per, w2.shape[-1])[:, :osz, :osz]
    x = F.relu(out + p["conv1"]["b"]).permute(0, 3, 1, 2)
    return _trunk_after_conv1(p, x)

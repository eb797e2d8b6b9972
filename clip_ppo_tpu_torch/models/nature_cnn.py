"""Nature-CNN trunk as functions over a params dict.

Port of ``clip_ppo_tpu/models/nature_cnn.py``: the conv(8/4)-conv(4/2)-
conv(3/1)-dense(512) trunk of the reference's ``Agent``
(`ppo_minigrid.py:128-162`) with orthogonal initialization (std sqrt(2);
actor 0.01, critic 1.0) and ReLU. Observations stay NHWC at this
interface; conv weights are stored in PyTorch's OIHW layout and dense
weights as ``[in, out]`` (applied as ``x @ w + b``). The conv output is
flattened in (h, w, c) order, as the JAX package's NHWC flatten does, so
the fc weights carry across unchanged.

The raw-view fast path (``nature_cnn_view``) is off whenever disturbances
are on, which this slice always has; it comes with the vanilla-PPO slice.
"""

from __future__ import annotations

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


def nature_cnn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, 84, 84, C] float in [0,1] → [B, hidden] features (post-ReLU)."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(conv(p["conv1"], x, 4))
    x = F.relu(conv(p["conv2"], x, 2))
    x = F.relu(conv(p["conv3"], x, 1))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) flatten
    return F.relu(dense(p["fc"], x))

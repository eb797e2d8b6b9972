"""Synthesize OpenAI-format CLIP checkpoints (the pretrained-readiness drill).

Port of ``clip_ppo_tpu/models/clip/synth_checkpoint.py``. OpenAI ships CLIP
as a TorchScript archive of the full model with fp16 weights (the
reference's `shared/clip_ppo_utils.py:79-97` loads it via ``clip.load``).
Where no checkpoint can be fetched, this module builds a module tree whose
``state_dict`` layout matches OpenAI's exactly — ``visual.conv1.weight``,
``visual.transformer.resblocks.N.attn.in_proj_weight``,
``mlp.c_fc``/``c_proj``, ``token_embedding.weight``, ``text_projection``,
``logit_scale`` — and saves it with ``torch.jit.save``, so that the real
loader path (:func:`loader.load_openai_checkpoint`: ``torch.jit.load`` →
``state_dict`` → ``convert_openai_state_dict``) runs at full ViT-B/32
scale. With real weights nothing changes but the file's contents.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn

from clip_ppo_tpu_torch.models.clip.config import CLIP_CONFIGS, CLIPConfig


class _Block(nn.Module):
    def __init__(self, w: int, h: int):
        super().__init__()
        self.attn = nn.MultiheadAttention(w, h)
        self.ln_1 = nn.LayerNorm(w)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(w, 4 * w)),
            ("gelu", nn.GELU()),
            ("c_proj", nn.Linear(4 * w, w)),
        ]))
        self.ln_2 = nn.LayerNorm(w)

    def forward(self, x):
        return x


class _Transformer(nn.Module):
    def __init__(self, w: int, layers: int, h: int):
        super().__init__()
        self.resblocks = nn.Sequential(*[_Block(w, h) for _ in range(layers)])

    def forward(self, x):
        return x


class _Visual(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w = cfg.vision_width
        scale = w ** -0.5
        self.conv1 = nn.Conv2d(3, w, cfg.patch_size, cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(w))
        n_tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.positional_embedding = nn.Parameter(scale * torch.randn(n_tokens, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = _Transformer(w, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(scale * torch.randn(w, cfg.embed_dim))

    def forward(self, x):
        return x


class _CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        tw = cfg.text_width
        self.visual = _Visual(cfg)
        self.transformer = _Transformer(tw, cfg.text_layers, cfg.text_heads)
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(cfg.context_length, tw))
        self.ln_final = nn.LayerNorm(tw)
        self.text_projection = nn.Parameter(tw ** -0.5 * torch.randn(tw, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(4.6052))

    def forward(self, x):
        return x


def build_openai_module(cfg: CLIPConfig, seed: int = 0) -> nn.Module:
    """A ``torch.nn.Module`` with OpenAI CLIP's exact state-dict layout and
    init scales (the weights are random: layout, shapes and dtype are what
    matter). The same ``seed`` gives the JAX package's module, weight for
    weight."""
    torch.manual_seed(seed)
    return _CLIP(cfg)


def write_fake_openai_checkpoint(path: str, name: str = "ViT-B/32", seed: int = 0) -> str:
    """Write a TorchScript archive at ``path`` with OpenAI's layout and fp16
    weights (the released files' dtype), loadable by
    :func:`loader.load_openai_checkpoint` and ``clip.load``-style consumers."""
    module = build_openai_module(CLIP_CONFIGS[name], seed=seed).half()
    # trace rather than script: the trivial forward carries no logic and
    # trace keeps the full parameter tree in the archive.
    traced = torch.jit.trace(module, torch.zeros(1, dtype=torch.float16))
    torch.jit.save(traced, path)
    return path

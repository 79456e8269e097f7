"""Compact Convolutional Transformer (counterpart of devit_tpu/models/cct.py).

A conv tokenizer (conv -> ReLU -> max-pool stages) in place of the patch
embedding, pre-norm encoder layers whose qkv has no bias, LayerNorm eps
1e-5, a learnable positional embedding drawn with std 0.2 (or the
sinusoidal one), and seq-pool (a softmax-weighted token average) in place of
the CLS token. `backbone=True` (the `decct_*` names) is the headless
CCTTransformer whose pooled feature is the MultiCCT ensemble's token.

The JAX package computes CCT attention as plain einsums with attention
dropout (no Pallas kernel), so this module does too: f32 logits, the f32
softmax, the probabilities rounded to the compute dtype, dropout on them,
then probs . v. Head and neuron gates and the captures (qkv, the per-layer
outputs, the rank statistics) are the port's VisionTransformer's; a gate may
carry one row per batch row (candidate gates folded into the batch,
core/shrink.py).

Parameter names are the flax ones, with the scanned layers split:
`blocks.<i>.qkv.kernel` is layer i of the flax leaf `blocks/qkv/kernel`, and
`tokenizer.conv<i>.kernel` keeps flax's (kh, kw, in, out) layout, so
io/bridge.py converts between the two. Randomness (dropout, drop-path)
comes from an explicit `torch.Generator`, as in models/vit.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from devit_tpu_torch.configs import CCTConfig, get_cct_config
from devit_tpu_torch.device import DeviceLike, resolve_device, to_device
from devit_tpu_torch.models.vit import (
    Dense, Gates, LayerNorm, Rows, _dropout, _rows, _seeded, _trunc_normal_, drop_path,
    drop_path_masks, fast_gelu, full_gates,
)


class CCTOutput(NamedTuple):
    logits: Optional[torch.Tensor]  # None for a backbone
    pooled: torch.Tensor  # seq-pool feature (B, D): the MultiCCT ensemble token
    attn: Optional[torch.Tensor] = None  # (L, B, N, D or resize_dim) per-layer attention outputs
    hidden: Optional[torch.Tensor] = None  # (L+1, B, N, D or resize_dim) hidden states
    qkv: Optional[torch.Tensor] = None  # (L,3,B,H,N,dh) 'all', (3,B,H,N,dh) 'middle'
    neuron_act: Optional[torch.Tensor] = None  # (L, B, N, hidden) post-GELU, pre-gate
    head_out: Optional[torch.Tensor] = None  # (L, B, N, H, dh) pre-gate head outputs

    # the ViTOutput fields the stage-2 and DEKD steps read: CCT has one head
    # and no dist logits; the pooled feature is the distillation token
    @property
    def cls_logits(self):
        return self.logits

    @property
    def dist_logits(self):
        return None

    @property
    def last_tokens(self):
        return self.pooled


def sinusoidal_embedding(n: int, dim: int) -> np.ndarray:
    """The reference's formula (transformers.py:380-385), (1, n, dim) f32."""
    pe = np.array([[p / (10000 ** (2 * (i // 2) / dim)) for i in range(dim)] for p in range(n)],
                  dtype=np.float32)
    pe[:, 0::2] = np.sin(pe[:, 0::2])
    pe[:, 1::2] = np.cos(pe[:, 1::2])
    return pe[None]


class Conv(nn.Module):
    """flax `nn.Conv(features, (k, k), strides, padding, use_bias=False)` on
    NHWC input: kernel in flax's (kh, kw, in, out) layout."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int, padding: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.kernel = nn.Parameter(torch.zeros(k, k, in_ch, out_ch))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = self.kernel.to(dtype).permute(3, 2, 0, 1)  # (out, in, kh, kw)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), w, stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


class Tokenizer(nn.Module):
    """Conv tokenizer (tokenizer.py:6-49): n stages of conv(k, s, p, no
    bias) -> ReLU -> max-pool(3, 2, 1), flattened to a token sequence."""

    def __init__(self, cfg: CCTConfig):
        super().__init__()
        self.cfg = cfg
        widths = [64] * (cfg.n_conv_layers - 1) + [cfg.embed_dim]
        ins = [cfg.in_chans] + widths[:-1]
        for i, (c_in, c_out) in enumerate(zip(ins, widths)):
            self.add_module(f"conv{i}", Conv(c_in, c_out, cfg.kernel_size, cfg.conv_stride,
                                             cfg.conv_padding))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        x = x.to(dtype)
        for i in range(cfg.n_conv_layers):
            x = F.relu(getattr(self, f"conv{i}")(x, dtype))
            x = F.max_pool2d(x.permute(0, 3, 1, 2), cfg.pooling_kernel_size,
                             cfg.pooling_stride, cfg.pooling_padding).permute(0, 2, 3, 1)
        B, H, W, D = x.shape
        return x.reshape(B, H * W, D)


class CCTLayer(nn.Module):
    """Pre-norm encoder layer (transformers.py:73-113) with head and neuron
    gates."""

    def __init__(self, cfg: CCTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.pre_norm = LayerNorm(D, 1e-5)
        self.qkv = Dense(D, 3 * D, use_bias=False)
        self.proj = Dense(D, D)
        self.norm1 = LayerNorm(D, 1e-5)
        self.linear1 = Dense(D, cfg.hidden_dim)
        self.linear2 = Dense(cfg.hidden_dim, D)

    def forward(self, x: torch.Tensor, head_gate: torch.Tensor, neuron_gate: torch.Tensor,
                dp_rate: float, dp_masks: Optional[torch.Tensor], dropout_seed: Optional[int],
                *, dtype: torch.dtype, train: bool, capture_qkv: bool,
                capture_rank_stats: bool, capture_outputs: bool,
                rows: Optional[Rows] = None) -> Tuple[torch.Tensor, dict]:
        """dp_masks: (2, B, 1, 1) keep masks of the two residual branches, or
        None; dropout_seed seeds the layer's dropout generator on x's device
        (`rows` as in vit._dropout)."""
        cfg = self.cfg
        B, N, D = x.shape
        H = cfg.num_heads
        dh = D // H
        gen = _seeded(dropout_seed, x.device)
        outs = {}

        h = self.pre_norm(x)
        qkv = self.qkv(h, dtype).reshape(B, N, 3, H, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        if train:
            probs = _dropout(probs, cfg.attention_dropout, gen, rows)
        att = torch.matmul(probs, v)  # (B, H, N, dh)
        if capture_rank_stats:
            outs["head_out"] = att.transpose(1, 2)
        att = att * _rows(head_gate.to(dtype))[:, :, None, None]
        att = self.proj(att.transpose(1, 2).reshape(B, N, D), dtype)
        if train:
            att = _dropout(att, cfg.dropout, gen, rows)
        x = x + (att if dp_masks is None else drop_path(att, dp_rate, dp_masks[0]))

        h = self.norm1(x)
        h = fast_gelu(self.linear1(h, dtype))
        if train:
            h = _dropout(h, cfg.dropout, gen, rows)
        if capture_rank_stats:
            outs["neuron_act"] = h
        h = self.linear2(h * _rows(neuron_gate.to(dtype))[:, None, :], dtype)
        if train:
            h = _dropout(h, cfg.dropout, gen, rows)
        x = x + (h if dp_masks is None else drop_path(h, dp_rate, dp_masks[1]))
        if capture_qkv:
            outs["qkv"] = torch.stack([q, k, v])
        if capture_outputs:
            outs["attn"] = att
            outs["hidden"] = x
        return x, outs


class CCT(nn.Module):
    """Tokenizer + encoder layers + seq-pool (+ the classifier unless
    cfg.backbone), with gates and captures; `dtype` is the compute dtype
    (parameters are f32)."""

    def __init__(self, cfg: CCTConfig, *, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.positional_embedding not in ("learnable", "sine", "none"):
            # the reference coerces unknown values to 'sine'
            # (transformers.py:159-160); a typo must not silently build a
            # model without one
            raise ValueError(f"positional_embedding={cfg.positional_embedding!r} "
                             "(expected 'learnable', 'sine', or 'none')")
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.embed_dim
        self.tokenizer = Tokenizer(cfg)
        if not cfg.seq_pool:
            self.class_emb = nn.Parameter(torch.zeros(1, 1, D))
        if cfg.positional_embedding == "learnable":
            self.positional_emb = nn.Parameter(torch.zeros(1, cfg.seq_len, D))
        self.blocks = nn.ModuleList(CCTLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = LayerNorm(D, 1e-5)
        if cfg.seq_pool:
            self.attention_pool = Dense(D, 1)
        if cfg.resize_dim is not None:
            self.resize = Dense(D, cfg.resize_dim)
        if not cfg.backbone:
            self.fc = Dense(D, cfg.num_classes)

    def reset_parameters(self, generator: torch.Generator) -> "CCT":
        """The JAX package's initializers: he-normal (truncated at two
        standard deviations) conv kernels, clip(0.2 normal, -2, 2) for the
        learnable positional embedding, clip(0.02 normal, -2, 2) for the
        dense kernels, zero biases and class token, unit LayerNorm scales;
        drawn in parameter order from a CPU generator."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            with torch.no_grad():
                if leaf == "scale":
                    p.fill_(1.0)
                elif leaf == "bias" or name == "class_emb":
                    p.zero_()
                elif name == "positional_emb":
                    _trunc_normal_(p, generator, std=0.2)
                elif name.startswith("tokenizer."):
                    kh, kw, c_in, _ = p.shape
                    std = math.sqrt(2.0 / (kh * kw * c_in)) / 0.87962566103423978
                    p.copy_(torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std,
                                                        -2 * std, 2 * std, generator=generator))
                else:
                    _trunc_normal_(p, generator)
        return self

    def forward(self, x: torch.Tensor, gates: Optional[Gates] = None, *, train: bool = False,
                capture_qkv: str = "none", capture_layer: Optional[int] = None,
                capture_outputs: bool = False, capture_rank_stats: bool = False,
                distill_token: bool = False,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Rows] = None) -> CCTOutput:
        """x: (B, H, W, C) NHWC. distill_token is accepted for the steps' API
        (the pooled feature is the distillation token). `generator` draws the
        drop-path masks and the dropout seeds when train=True; with `rows`
        at the global batch, cut to those rows (vit.VisionTransformer)."""
        cfg, dtype = self.cfg, self.dtype
        L = cfg.num_layers
        if capture_qkv not in ("none", "middle", "all"):
            raise ValueError(f"capture_qkv must be none|middle|all, got {capture_qkv!r}")
        if capture_layer is None:
            # a 1-layer CCT captures its only layer (the reference indexes a
            # Python list, where //2 - 1 == -1 wraps to the last layer)
            capture_layer = (L // 2 - 1) % L
        needs_rng = train and (cfg.stochastic_depth > 0 or cfg.dropout > 0
                               or cfg.attention_dropout > 0)
        if needs_rng and generator is None:
            raise ValueError("train=True with drop-path or dropout needs a generator")
        t = self.tokenizer(x, dtype)
        B, N, D = t.shape
        if not cfg.seq_pool:
            t = torch.cat([self.class_emb.to(dtype).expand(B, 1, D), t], dim=1)
            N += 1
        if cfg.positional_embedding == "learnable":
            t = t + self.positional_emb.to(dtype)
        elif cfg.positional_embedding == "sine":
            t = t + torch.from_numpy(sinusoidal_embedding(N, D)).to(t.device, dtype)
        seeds = [None] * (L + 1)
        if train and (cfg.dropout > 0 or cfg.attention_dropout > 0):
            seeds = torch.randint(0, 2 ** 62, (L + 1,), generator=generator,
                                  device=generator.device).tolist()
        if train and cfg.dropout > 0:
            t = _dropout(t, cfg.dropout, _seeded(seeds[0], t.device), rows)
        if gates is None:
            gates = full_gates(cfg, device=t.device)

        dp_rates = torch.linspace(0.0, cfg.stochastic_depth, L).tolist()
        masks = None
        if train and cfg.stochastic_depth > 0:
            masks = to_device(drop_path_masks(generator, dp_rates, B, rows), t.device)
        t_emb = t  # post-PE, post-dropout embedding: the reference's hidden[0]
        layer_outs, qkv_slot = [], None
        for i, blk in enumerate(self.blocks):
            t, outs = blk(t, gates.head[i], gates.neuron[i], dp_rates[i],
                          None if masks is None else masks[i], seeds[i + 1], dtype=dtype,
                          train=train,
                          capture_qkv=capture_qkv == "all" or (capture_qkv == "middle"
                                                               and i == capture_layer),
                          capture_rank_stats=capture_rank_stats,
                          capture_outputs=capture_outputs, rows=rows)
            if capture_qkv == "middle" and i == capture_layer:
                qkv_slot = outs["qkv"].to(dtype)
            layer_outs.append(outs)

        def stacked(key):
            return torch.stack([o[key] for o in layer_outs])

        t = self.norm(t)
        if cfg.seq_pool:
            # softmax(attention_pool(x))^T x (transformers.py:348-353), the
            # softmax in f32
            w = torch.softmax(self.attention_pool(t, dtype).float(), dim=1).to(dtype)
            pooled = torch.matmul(w.transpose(1, 2), t)[:, 0]
        else:
            pooled = t[:, 0]

        attn = hidden = None
        if capture_outputs:
            attn = stacked("attn")
            hidden = torch.cat([t_emb[None], stacked("hidden")])
            if cfg.resize_dim is not None:
                attn, hidden = self.resize(attn, dtype), self.resize(hidden, dtype)
        qkv = None
        if capture_qkv == "all":
            qkv = stacked("qkv")
        elif capture_qkv == "middle":
            qkv = qkv_slot if qkv_slot is not None else torch.zeros(
                (3, B, cfg.num_heads, N, D // cfg.num_heads), dtype=dtype, device=t.device)
        rank = dict(neuron_act=stacked("neuron_act"), head_out=stacked("head_out")) \
            if capture_rank_stats else {}
        logits = None if cfg.backbone else self.fc(pooled, dtype).float()
        return CCTOutput(logits=logits, pooled=pooled, attn=attn, hidden=hidden, qkv=qkv,
                         **rank)


def create_cct(name: str, *, device: DeviceLike = None,
               generator: Optional[torch.Generator] = None, **overrides) -> CCT:
    """A CCT of the registry's geometry `name` ('cct_7_3x1_32',
    'cct_14_7x2_224', ...; 'decct_*' is the headless backbone, get_decct,
    cct.py:461-470), its parameters drawn from `generator` (seed 0 if None),
    on `device`."""
    dtype = overrides.pop("dtype", torch.bfloat16)
    if name.startswith("decct"):
        overrides.setdefault("backbone", True)
        name = name.replace("decct", "cct", 1)
    model = CCT(get_cct_config(name, **overrides), dtype=dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return model.reset_parameters(generator).to(resolve_device(device))

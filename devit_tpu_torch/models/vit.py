"""The (De)ViT/DeiT model (counterpart of devit_tpu/models/vit.py).

The base ops (LayerNorm and GELU numerics, the gate container, the shapes of
the flax parameter tree) serve the compact serving path; `VisionTransformer`
is the gated, multi-output model the training path runs.

Blocks are an nn.ModuleList (the JAX package stacks them with nn.scan); the
parameter names are the flax ones (`blocks.<i>.qkv.kernel` is layer i of the
flax leaf `blocks/qkv/kernel`), so io/bridge.py converts between the two.
Parameters are f32; dense layers cast input and weight to the compute dtype
(flax `nn.Dense(dtype=...)`), LayerNorm statistics and the attention softmax
are f32, GELU is the A&S-erf form; fast_math (tanh GELU, compute-dtype
LayerNorm statistics) applies only when train=False.

Randomness (drop-path, dropout) comes from an explicit `torch.Generator`.
Each layer's drop-path keep masks are drawn before the layer runs and passed
in as tensors, so a rematerialized block recomputes with the same masks, as
nn.remat replays the same key. Its parameters are passed in too, so a model
run through torch.func.functional_call (the stacked ensemble divisions)
recomputes with the tensors it ran with, not the module's own.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from devit_tpu_torch.configs import ViTConfig, get_vit_config
from devit_tpu_torch.device import DeviceLike, resolve_device, to_device
from devit_tpu_torch.kernels.attention import make_trainable_attention, trainable_attention_op
from devit_tpu_torch.kernels.gelu import (  # fast_erf: the JAX module's name, re-exported
    fast_erf, fused_gelu, reference_gelu)
from devit_tpu_torch.models.moe import Experts, RouteLog, moe_mlp


class Gates(NamedTuple):
    """Structural-shrink masks. 1.0 = keep, 0.0 = pruned.

    `head`:   (depth, num_heads)
    `neuron`: (depth, hidden_dim)
    or, one gate row per batch row (candidate gates folded into the batch,
    core/shrink.py), (depth, B, num_heads) and (depth, B, hidden_dim).
    """

    head: Any
    neuron: Any

    def numpy(self) -> "Gates":
        """Both masks as host numpy arrays (tensors are copied off their
        device)."""
        return Gates(*(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                       for a in self))


def full_gates(cfg: ViTConfig, dtype: torch.dtype = torch.float32,
               device: DeviceLike = "cpu") -> Gates:
    return Gates(head=torch.ones((cfg.depth, cfg.num_heads), dtype=dtype, device=device),
                 neuron=torch.ones((cfg.depth, cfg.hidden_dim), dtype=dtype, device=device))


class ViTOutput(NamedTuple):
    """Everything a forward can emit; unused fields are None."""

    logits: torch.Tensor  # (cls+dist)/2 for distilled models
    cls_logits: Optional[torch.Tensor] = None
    dist_logits: Optional[torch.Tensor] = None
    cls_feat: Optional[torch.Tensor] = None  # post-norm CLS token (B, C)
    dist_feat: Optional[torch.Tensor] = None  # post-norm dist token (B, C)
    last_tokens: Optional[Any] = None  # resize_mlp-projected features for token distill
    qkv: Optional[torch.Tensor] = None  # (L,3,B,H,N,dh) 'all', (3,B,H,N,dh) 'middle'
    attn: Optional[torch.Tensor] = None  # (L,B,N,C or resize_dim) per-block attention outputs
    encoders: Optional[torch.Tensor] = None  # (L,B,N,C or resize_dim) per-block outputs
    embedding: Optional[torch.Tensor] = None  # (B,N,C or resize_dim) post-pos-embed tokens
    neuron_act: Optional[torch.Tensor] = None  # (L,B,N,hidden) post-GELU pre-gate
    head_out: Optional[torch.Tensor] = None  # (L,B,N,H,dh) pre-gate head outputs
    aux_loss: Optional[torch.Tensor] = None  # MoE layers' auxiliary loss (training)


Rows = Tuple[int, int, int]  # (start, stop, global batch): a rank's rows of a batch


def drop_path_masks(generator: torch.Generator, rates, batch: int,
                    rows: Optional[Rows] = None) -> torch.Tensor:
    """Keep masks of every layer's two residual branches, (L, 2, B, 1, 1) f32
    0/1, Bernoulli(1 - rates[l]), drawn on the generator's device. With
    `rows` the masks are drawn at the global batch and cut to the rows, so a
    data-parallel rank draws what one process draws for those rows."""
    if rows is not None:
        batch = rows[2]
    keep = torch.tensor([1.0 - r for r in rates], device=generator.device)
    keep = keep.view(-1, 1, 1, 1, 1).expand(len(rates), 2, batch, 1, 1).contiguous()
    masks = torch.bernoulli(keep, generator=generator)
    return masks if rows is None else masks[:, :, rows[0]:rows[1]]


def drop_path(x: torch.Tensor, rate: float, mask: torch.Tensor) -> torch.Tensor:
    """Stochastic depth on a residual branch (timm DropPath semantics): `mask`
    is the (B, 1, 1) keep mask of drop_path_masks."""
    # the divisor rounded to x's dtype first, as the JAX package casts it
    scale = torch.tensor(max(1.0 - rate, 1e-8), dtype=torch.float32).to(x.dtype).item()
    return x * mask.to(x.dtype) / scale


def _seeded(seed: Optional[int], device: torch.device) -> Optional[torch.Generator]:
    """A generator on `device` from a seed drawn on the host, so a recompute
    under remat draws the same bits."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             rows: Optional[Rows] = None) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, scaled by 1/(1 - rate);
    `generator` lies on x's device. With `rows` x holds those rows of the
    batch (dim 0) and the mask is drawn at the global batch, then cut."""
    if rate <= 0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = x.shape if rows is None else (rows[2],) + tuple(x.shape[1:])
    mask = torch.bernoulli(torch.full(shape, keep, device=x.device), generator=generator)
    if rows is not None:
        mask = mask[rows[0]:rows[1]]
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, stat_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm with statistics in `stat_dtype` (f32 by default; the serving
    fast_math mode takes them in the compute dtype). Written out rather than
    F.layer_norm, which always takes f32 statistics."""
    dtype = x.dtype
    xs = x.to(stat_dtype)
    mean = xs.mean(dim=-1, keepdim=True)
    var = (xs - mean).square().mean(dim=-1, keepdim=True)
    y = (xs - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(stat_dtype) + bias.to(stat_dtype)
    return y.to(dtype)


def fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU with the A&S erf (kernels/gelu.py fast_erf). A CUDA
    tensor runs `fused_gelu` (one kernel each way, the forward bit for bit
    the chain; a dtype the kernels do not take raises TypeError); a CPU
    tensor runs the plain chain, `reference_gelu`, and autograd through it."""
    if x.device.type == "cuda":
        return fused_gelu(x)
    return reference_gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU the fast_math serving mode uses (jax.nn.gelu with
    approximate=True)."""
    return F.gelu(x, approximate="tanh")


def vit_param_shapes(cfg: ViTConfig) -> dict:
    """Shapes of the flax `VisionTransformer(cfg).init(...)["params"]` tree,
    as a nested dict whose keys iterate in sorted order — the order in which
    jax.tree_util walks it. Blocks carry the leading depth axis of nn.scan."""
    L, C, A, K = cfg.depth, cfg.embed_dim, cfg.attn_dim, cfg.num_classes
    hidden = cfg.hidden_dim
    p = cfg.patch_size

    def dense(i, o):
        return {"bias": (o,), "kernel": (i, o)}

    def dense_l(i, o):
        return {"bias": (L, o), "kernel": (L, i, o)}

    norm_l = {"bias": (L, C), "scale": (L, C)}
    blocks = {"fc1": dense_l(C, hidden), "fc2": dense_l(hidden, C),
              "norm1": dict(norm_l), "norm2": dict(norm_l),
              "proj": dense_l(A, C), "qkv": dense_l(C, 3 * A)}
    if not cfg.qkv_bias:
        del blocks["qkv"]["bias"]
    tree = {
        "blocks": blocks,
        "cls_token": (1, 1, C),
        "head": dense(C, K),
        "norm": {"bias": (C,), "scale": (C,)},
        "patch_embed": dense(p * p * cfg.in_chans, C),
        "pos_embed": (1, cfg.seq_len, C),
    }
    if cfg.distilled:
        tree["dist_token"] = (1, 1, C)
        tree["head_dist"] = dense(C, K)
    if cfg.representation_size is not None and not cfg.distilled:
        tree["pre_logits"] = dense(C, cfg.representation_size)
        tree["head"] = dense(cfg.representation_size, K)
    if cfg.resize_dim is not None:
        for name in ("resize_att_mlp", "resize_encoder_mlp", "resize_mlp"):
            tree[name] = dense(C, cfg.resize_dim)
    return map_leaves(lambda shape: shape, tree)


def map_leaves(fn, tree):
    """Apply fn to every leaf of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> None:
    """torch trunc_normal_(std) semantics as the JAX package draws it:
    clip(std * normal, -2, 2) (the bounds are absolute)."""
    with torch.no_grad():
        t.copy_(torch.clamp(std * torch.randn(t.shape, generator=generator), -2.0, 2.0))


class Dense(nn.Module):
    """flax `nn.Dense(features, dtype=...)`: input, f32 kernel and bias are
    cast to the compute dtype before the product. Kernel in (in, out) layout."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = torch.matmul(x.to(dtype), self.kernel.to(dtype))
        return y if self.bias is None else y + self.bias.to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, stat_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps, stat_dtype)


class PatchEmbed(nn.Module):
    """Patchify as reshape + one matmul (the stride-p conv of timm's
    PatchEmbed, written as the JAX package writes it). Input NHWC."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.kernel = nn.Parameter(torch.zeros(p * p * cfg.in_chans, cfg.embed_dim))
        self.bias = nn.Parameter(torch.zeros(cfg.embed_dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        p, g = cfg.patch_size, cfg.grid_size
        B = x.shape[0]
        # (B, H, W, C) -> (B, gh, p, gw, p, C) -> (B, gh, gw, p, p, C) -> (B, N, p*p*C)
        x = x.reshape(B, g, p, g, p, cfg.in_chans)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * cfg.in_chans)
        return torch.matmul(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)


def _rows(gate: torch.Tensor) -> torch.Tensor:
    """A gate as (rows, W): one vector (W,) for the whole batch -> (1, W);
    one gate row per batch row (B, W) stays as it is."""
    return gate[None] if gate.dim() == 1 else gate


class Block(nn.Module):
    """One pre-norm transformer block with head and neuron gates. A gate is
    one vector for the whole batch, or one row per batch row (candidate gates
    folded into the batch, core/shrink.py). Block `index` of a config that
    lists it in moe_layers has the sparse-expert MLP half (models/moe.py:
    `router`, the stacked `experts`) in place of fc1 and fc2."""

    def __init__(self, cfg: ViTConfig, index: int = 0):
        super().__init__()
        self.cfg = cfg
        self.index = index
        self.moe = index in cfg.moe_layers
        C, A = cfg.embed_dim, cfg.attn_dim
        self.norm1 = LayerNorm(C, cfg.layer_norm_eps)
        self.qkv = Dense(C, 3 * A, use_bias=cfg.qkv_bias)
        self.proj = Dense(A, C)
        self.norm2 = LayerNorm(C, cfg.layer_norm_eps)
        if self.moe:
            self.router = Dense(C, cfg.num_experts, use_bias=False)
            self.experts = Experts(cfg.num_experts, C, cfg.hidden_dim)
            self.route_log = RouteLog()
        else:
            self.fc1 = Dense(C, cfg.hidden_dim)
            self.fc2 = Dense(cfg.hidden_dim, C)

    def forward(self, x: torch.Tensor, head_gate: torch.Tensor, neuron_gate: torch.Tensor,
                dp_rate: float, dp_masks: Optional[torch.Tensor], dropout_seed: Optional[int],
                *, dtype: torch.dtype, stat_dtype: torch.dtype, fast_math: bool,
                use_kernel: bool, train: bool, capture_qkv: bool,
                capture_rank_stats: bool, capture_attn: bool,
                rows: Optional[Rows] = None,
                moe_seed: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """dp_masks: (2, B, 1, 1) keep masks of the attention and MLP branches,
        or None (no drop-path). dropout_seed seeds a generator on x's device
        for dropout, so a recompute draws the same bits; `rows` as in
        _dropout. moe_seed seeds a MoE block's router noise the same way
        (training); such a block puts its auxiliary loss in outs["aux"]."""
        cfg = self.cfg
        B, N, _ = x.shape
        H, dh, A = cfg.num_heads, cfg.head_dim, cfg.attn_dim
        gen = _seeded(dropout_seed, x.device)
        outs = {}

        h = self.norm1(x, stat_dtype)
        qkv_raw = self.qkv(h, dtype)
        needs_capture = capture_qkv or capture_rank_stats
        if use_kernel and not needs_capture and (not train or cfg.attn_drop_rate == 0):
            attn_out = make_trainable_attention(H)(qkv_raw)
            gate = head_gate.to(dtype).repeat_interleave(dh, dim=-1)
            attn_out = attn_out * _rows(gate)[:, None, :]
        else:
            qkv = qkv_raw.reshape(B, N, 3, H, dh).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
            probs = torch.softmax(logits, dim=-1).to(dtype)
            if train:
                probs = _dropout(probs, cfg.attn_drop_rate, gen, rows)
            attn_out = torch.matmul(probs, v)  # (B, H, N, dh)
            if capture_rank_stats:
                outs["head_out"] = attn_out.transpose(1, 2)
            if capture_qkv:
                outs["qkv"] = torch.stack([q, k, v])
            attn_out = attn_out * _rows(head_gate.to(dtype))[:, :, None, None]
            attn_out = attn_out.transpose(1, 2).reshape(B, N, A)
        attn_out = self.proj(attn_out, dtype)
        if train:
            attn_out = _dropout(attn_out, cfg.drop_rate, gen, rows)
        x = x + (attn_out if dp_masks is None else drop_path(attn_out, dp_rate, dp_masks[0]))

        h = self.norm2(x, stat_dtype)
        if self.moe:
            h, outs["aux"] = moe_mlp(
                h, self.router.kernel, self.experts, self.route_log, layer=self.index,
                num_experts=cfg.num_experts, k=cfg.top_k, ratio=cfg.capacity_ratio,
                neuron_gate=neuron_gate, seed=moe_seed, train=train, dtype=dtype,
                gelu=gelu_tanh if fast_math else fast_gelu)
        else:
            h = self.fc1(h, dtype)
            h = gelu_tanh(h) if fast_math else fast_gelu(h)
            if train:
                h = _dropout(h, cfg.drop_rate, gen, rows)
            if capture_rank_stats:
                outs["neuron_act"] = h
            h = h * _rows(neuron_gate.to(dtype))[:, None, :]
            h = self.fc2(h, dtype)
            if train:
                h = _dropout(h, cfg.drop_rate, gen, rows)
        x = x + (h if dp_masks is None else drop_path(h, dp_rate, dp_masks[1]))
        if capture_attn:
            outs["attn"] = attn_out
        return x, outs


# The aten ops a block's matrix products reach, read under a TorchDispatchMode
# on the CPU and on the card (torch 2.11 and 2.13, f32 and bf16 alike): a
# Dense layer's (B, N, C) @ (C, O) folds its leading axes into one `mm`; the
# plain attention's q . k^T and p . v are `bmm`.
_DOTS_NO_BATCH = [torch.ops.aten.mm.default]
_DOTS = _DOTS_NO_BATCH + [torch.ops.aten.bmm.default]
# remat_policy name -> the ops whose outputs a block under remat saves; the
# rest it recomputes in the backward pass. [] is full remat (only the
# block's inputs are saved); None saves everything, which is no remat at all.
# The names are JAX's jax.checkpoint_policies entries that take no argument,
# and 'dots_and_attn': dots_saveable plus the fused attention's output.
REMAT_POLICIES = {
    "nothing_saveable": [],
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_and_attn": _DOTS + [trainable_attention_op],
    "everything_saveable": None,
}


def remat_saved_ops(remat_policy: Optional[str]) -> Optional[list]:
    """The ops whose outputs `remat_policy` saves under remat (REMAT_POLICIES:
    [] for None, full remat; None for everything_saveable). Any other name
    raises, as the JAX package rejects the policy factories
    (save_only_these_names, ...), which passed bare would save everything
    and silently turn remat off."""
    if remat_policy is None:
        return []
    if remat_policy not in REMAT_POLICIES:
        plain = sorted(k for k in REMAT_POLICIES if k != "dots_and_attn")
        raise ValueError(f"remat_policy={remat_policy!r} is not a supported checkpoint "
                         f"policy; choose from {plain} or 'dots_and_attn'")
    return REMAT_POLICIES[remat_policy]


def _block_call(blk: Block, params: dict, *args, **kw):
    """blk(*args, **kw) with `params` bound: what a checkpointed block runs,
    and recomputes in the backward pass, when the caller's functional_call
    has long restored the module's own parameters."""
    return functional_call(blk, params, args, kw)


class VisionTransformer(nn.Module):
    """Functional (De)ViT/DeiT with multi-output forward.

    use_kernel: attention through the trainable fused attention (the CUDA
    kernels on a CUDA tensor) wherever the JAX package takes its Pallas
    kernel; False takes the plain attention everywhere.
    use_remat: in training, each block runs under torch.utils.checkpoint
    (non-reentrant) and is recomputed in the backward pass.
    remat_policy: what a block under remat saves instead of recomputing
    (REMAT_POLICIES, JAX's names; None, the default, saves nothing but the
    block's inputs). A name is checked where the JAX package checks it, at
    a training forward under remat.
    """

    def __init__(self, cfg: ViTConfig, *, dtype: torch.dtype = torch.bfloat16,
                 fast_math: bool = False, use_kernel: bool = True, use_remat: bool = True,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.fast_math = fast_math
        self.use_kernel = use_kernel
        self.use_remat = use_remat
        self.remat_policy = remat_policy
        C = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, C)) if cfg.distilled else None
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, C))
        if cfg.resize_dim is not None:
            self.resize_mlp = Dense(C, cfg.resize_dim)
            self.resize_att_mlp = Dense(C, cfg.resize_dim)
            self.resize_encoder_mlp = Dense(C, cfg.resize_dim)
        if cfg.moe_layers and cfg.drop_rate > 0:
            raise ValueError("MoE layers take no dropout (drop_rate must be 0)")
        self.blocks = nn.ModuleList(Block(cfg, i) for i in range(cfg.depth))
        self.norm = LayerNorm(C, cfg.layer_norm_eps)
        head_in = C
        if cfg.representation_size is not None and not cfg.distilled:
            self.pre_logits = Dense(C, cfg.representation_size)
            head_in = cfg.representation_size
        self.head = Dense(head_in, cfg.num_classes)
        if cfg.distilled:
            self.head_dist = Dense(C, cfg.num_classes)

    def reset_parameters(self, generator: torch.Generator) -> "VisionTransformer":
        """The JAX package's initializers: clip(0.02 normal, -2, 2) for every
        kernel and token, lecun-normal for pre_logits, zero biases, unit
        LayerNorm scales; drawn in parameter order from a CPU generator."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            with torch.no_grad():
                if leaf == "scale":
                    p.fill_(1.0)
                elif leaf == "bias":
                    p.zero_()
                elif name == "pre_logits.kernel":
                    p.copy_(torch.randn(p.shape, generator=generator) / p.shape[0] ** 0.5)
                else:
                    _trunc_normal_(p, generator)
        return self

    def forward(self, x: torch.Tensor, gates: Optional[Gates] = None, *, train: bool = False,
                capture_qkv: str = "none", capture_layer: Optional[int] = None,
                capture_block_outputs: bool = False, capture_embedding: bool = False,
                capture_rank_stats: bool = False, distill_token: bool = False,
                features_only: bool = False,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Rows] = None) -> ViTOutput:
        """x: (B, H, W, C) NHWC. `generator` draws drop-path masks and
        dropout seeds when train=True (required then if the config has any).
        `rows` (start, stop, global batch): x holds those rows of a global
        batch, and every per-sample draw is made at the global batch and cut
        to them (a data-parallel rank's share of one process's step)."""
        cfg = self.cfg
        dtype = self.dtype
        B = x.shape[0]
        if capture_qkv not in ("none", "middle", "all"):
            raise ValueError(f"capture_qkv must be none|middle|all, got {capture_qkv!r}")
        if gates is None:
            gates = full_gates(cfg, device=x.device)
        if capture_layer is None:
            # the reference indexes a Python list, so depth 1 wraps to the last layer
            capture_layer = (cfg.depth // 2 - 1) % cfg.depth
        needs_rng = train and (cfg.drop_path_rate > 0 or cfg.drop_rate > 0
                               or cfg.attn_drop_rate > 0)
        if needs_rng and generator is None:
            raise ValueError("train=True with drop-path or dropout needs a generator")
        fast_math = self.fast_math and not train
        stat_dtype = dtype if fast_math else torch.float32

        t = self.patch_embed(x, dtype)
        C = t.shape[-1]
        toks = [self.cls_token.to(dtype).expand(B, 1, C)]
        if cfg.distilled:
            toks.append(self.dist_token.to(dtype).expand(B, 1, C))
        t = torch.cat(toks + [t], dim=1) + self.pos_embed.to(dtype)
        seeds, masks, moe_seeds = [None] * (cfg.depth + 1), None, {}
        if train:
            if cfg.moe_layers and rows is not None:
                raise ValueError("MoE layers route the batch on one device; a data-parallel "
                                 "`rows` split is not supported")
            seeds, masks, moe_seeds = train_draws(cfg, generator, B, rows)
        if train and cfg.drop_rate > 0:
            t = _dropout(t, cfg.drop_rate, _seeded(seeds[0], t.device), rows)
        resize = cfg.resize_dim is not None
        embedding = None
        if capture_embedding:
            embedding = self.resize_encoder_mlp(t, dtype) if resize else t

        dp_rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.depth).tolist()
        if masks is not None:
            masks = to_device(masks, t.device)
        # everything_saveable (saved_ops None) recomputes nothing: no remat;
        # full remat ([]) takes checkpoint's own context, the other policies
        # its selective form over the ops they save
        saved_ops = remat_saved_ops(self.remat_policy) if self.use_remat and train else None
        remat = saved_ops is not None and torch.is_grad_enabled()
        ctx = dict(context_fn=partial(create_selective_checkpoint_contexts, saved_ops)) \
            if saved_ops else {}
        layer_outs = []
        qkv_slot = None
        for i, blk in enumerate(self.blocks):
            # "middle" captures one layer: the others keep the kernels (the
            # JAX package's scanned blocks take the plain attention in all)
            kw = dict(dtype=dtype, stat_dtype=stat_dtype, fast_math=fast_math,
                      use_kernel=self.use_kernel, train=train,
                      capture_qkv=capture_qkv == "all" or (capture_qkv == "middle"
                                                           and i == capture_layer),
                      capture_rank_stats=capture_rank_stats,
                      capture_attn=capture_block_outputs, rows=rows)
            if blk.moe:
                kw["moe_seed"] = moe_seeds.get(i)
            args = (t, gates.head[i], gates.neuron[i], dp_rates[i],
                    None if masks is None else masks[i], seeds[i + 1])
            if remat:
                t, outs = checkpoint(_block_call, blk, dict(blk.named_parameters()), *args,
                                     use_reentrant=False, **ctx, **kw)
            else:
                t, outs = blk(*args, **kw)
            if capture_block_outputs:
                outs["encoder"] = t
            if capture_qkv == "middle" and i == capture_layer:
                qkv_slot = outs["qkv"].to(dtype)
            layer_outs.append(outs)

        def stacked(key):
            return torch.stack([o[key] for o in layer_outs])

        t = self.norm(t, stat_dtype)
        cls_feat = t[:, 0]
        dist_feat = t[:, 1] if cfg.distilled else None
        if cfg.representation_size is not None and not cfg.distilled:
            cls_feat = torch.tanh(self.pre_logits(cls_feat, dtype))

        qkv = None
        if capture_qkv == "all":
            qkv = stacked("qkv")
        elif capture_qkv == "middle":
            qkv = qkv_slot if qkv_slot is not None else torch.zeros(
                (3, B, cfg.num_heads, cfg.seq_len, cfg.head_dim), dtype=dtype, device=t.device)
        attn = encoders = None
        if capture_block_outputs:
            attn, encoders = stacked("attn"), stacked("encoder")
            if resize:
                attn = self.resize_att_mlp(attn, dtype)
                encoders = self.resize_encoder_mlp(encoders, dtype)
        last_tokens = None
        if distill_token:
            if cfg.distilled:
                last_tokens = ((self.resize_mlp(cls_feat, dtype), self.resize_mlp(dist_feat, dtype))
                               if resize else (cls_feat, dist_feat))
            else:
                last_tokens = self.resize_mlp(cls_feat, dtype) if resize else cls_feat
        rank = dict(neuron_act=stacked("neuron_act"), head_out=stacked("head_out")) \
            if capture_rank_stats else {}
        aux = [o["aux"] for o in layer_outs if o.get("aux") is not None]
        common = dict(cls_feat=cls_feat, dist_feat=dist_feat, last_tokens=last_tokens, qkv=qkv,
                      attn=attn, encoders=encoders, embedding=embedding,
                      aux_loss=torch.stack(aux).mean() if aux else None, **rank)
        if features_only:
            return ViTOutput(logits=cls_feat, **common)

        cls_logits = self.head(cls_feat, dtype).float()
        dist_logits = None
        logits = cls_logits
        if cfg.distilled:
            dist_logits = self.head_dist(dist_feat, dtype).float()
            logits = (cls_logits + dist_logits) / 2.0
        return ViTOutput(logits=logits, cls_logits=cls_logits, dist_logits=dist_logits, **common)


def train_draws(cfg: ViTConfig, generator: torch.Generator, batch: int,
                rows: Optional[Rows] = None) -> Tuple[list, Optional[torch.Tensor], dict]:
    """What a train=True forward at `batch` rows draws from `generator`:
    the seeds of the embedding's dropout (0) and each block's (1..depth),
    None without dropout, then the drop-path masks (drop_path_masks, on the
    generator's device), None without drop-path, then, only for a config
    with MoE layers, one router-noise seed a MoE layer ({layer index: seed},
    else {}). A division-parallel rank draws and drops another rank's
    divisions' share, so its generator stays in step with one process that
    runs all of them."""
    seeds = [None] * (cfg.depth + 1)
    if cfg.drop_rate > 0 or cfg.attn_drop_rate > 0:
        seeds = torch.randint(0, 2 ** 62, (cfg.depth + 1,), generator=generator,
                              device=generator.device).tolist()
    masks = None
    if cfg.drop_path_rate > 0:
        rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.depth).tolist()
        masks = drop_path_masks(generator, rates, batch, rows)
    moe_seeds = {}
    if cfg.moe_layers:
        drawn = torch.randint(0, 2 ** 62, (len(cfg.moe_layers),), generator=generator,
                              device=generator.device).tolist()
        moe_seeds = dict(zip(cfg.moe_layers, drawn))
    return seeds, masks, moe_seeds


def create_vit(name: str, *, device: DeviceLike = None,
               generator: Optional[torch.Generator] = None, **overrides) -> VisionTransformer:
    """A VisionTransformer of the registry's geometry `name`, with its
    parameters drawn from `generator` (seed 0 if None), built on `device`
    (a 3.4 B-parameter model is never held on the host whole)."""
    model_kw = {k: overrides.pop(k) for k in
                ("dtype", "fast_math", "use_kernel", "use_remat", "remat_policy")
                if k in overrides}
    with torch.device(resolve_device(device)):
        model = VisionTransformer(get_vit_config(name, **overrides), **model_kw)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return model.reset_parameters(generator)

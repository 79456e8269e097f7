"""The masked-attention text CCT (counterpart of devit_tpu/models/text.py).

Embedder (a word-embedding table) -> TextTokenizer (a 1-D conv over the word
embeddings with the mask carried through the same windows) ->
MaskedTextClassifier (pre-norm encoder layers whose attention masks invalid
(query, key) pairs, seq-pool, a linear head). TextCCT composes the three as
the upstream `text_cct` wiring does. Nothing else of either package calls
the stack; its module API is its entry point.

The JAX package keeps two behaviours of the reference, and so does the port:
- a learnable positional embedding is stored at the reference's (1, N+1, D)
  shape, row 0 a padding row, and the forward adds rows 1..N ('sine' adds
  the plain sinusoid of rows 0..N-1, which is the same thing);
- MaskedTextLayer's `norm1` output REPLACES the residual stream before the
  MLP, so the MLP residual adds onto normalized values.

Attention is plain, as in the JAX package (the fused kernel takes no mask):
f32 logits times dh^-0.5, invalid pairs filled with the f32 minimum BEFORE
the softmax (a fully masked query row softmaxes to uniform), the f32
softmax rounded to the compute dtype, attention dropout, then probs . v.

Parameters are f32 and keep the flax names (`classifier.blocks.<i>.qkv.kernel`
is layer i of the scanned flax leaf `classifier/blocks/qkv/kernel`;
`tokenizer.conv.kernel` keeps flax's (k, E, 1, C) layout), so io/bridge.py
converts between the two. Each module draws its parameters with the JAX
package's initializers from a CPU `generator` (seed 0 if None) when it is
built, and lives on `device` (the card if None). Dropout and drop-path draw
from the explicit `generator` of a train=True forward, as in models/cct.py.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from devit_tpu_torch.device import DeviceLike, resolve_device, to_device
from devit_tpu_torch.models.cct import sinusoidal_embedding
from devit_tpu_torch.models.vit import (
    Dense, LayerNorm, _dropout, _seeded, _trunc_normal_, drop_path, drop_path_masks, fast_gelu,
)


def conv_seq_len(n: int, kernel: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - kernel) // stride + 1


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def _dense(i: int, o: int, gen: torch.Generator, use_bias: bool = True) -> Dense:
    """flax nn.Dense with the JAX package's trunc_init kernel, zero bias."""
    d = Dense(i, o, use_bias=use_bias)
    _trunc_normal_(d.kernel, gen)
    return d


class Embedder(nn.Module):
    """Word-embedding lookup (embedder.py:4-28): the f32 (vocab, E) table,
    drawn N(0, 1) with the padding row zeroed, cast to the compute dtype and
    looked up; positions where mask <= 0 are multiplied out."""

    def __init__(self, vocab_size: int, embedding_dim: int, padding_idx: Optional[int] = 1, *,
                 dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        table = torch.randn((vocab_size, embedding_dim), generator=_generator(generator))
        if padding_idx is not None:
            table[padding_idx] = 0.0
        self.embedding = nn.Parameter(table)
        self.to(resolve_device(device))

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None):
        x = F.embedding(ids, self.embedding.to(self.dtype))
        if mask is not None:
            x = x * (mask > 0).to(self.dtype)[..., None]
        return x, mask


class TextTokenizer(nn.Module):
    """1-D conv tokenizer over word embeddings (tokenizer.py:52-109): a conv
    of kernel (k, E), stride (s, 1), padding (p, 0), no bias, he-normal
    init; optional ReLU; optional max-pool (pk, 1)/(ps, 1)/(pp, 0) with -inf
    padding. `embedding_dim` is E, the width of the input (flax reads it off
    the input at init)."""

    def __init__(self, embedding_dim: int, n_output_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 1, pooling_kernel_size: int = 3,
                 pooling_stride: int = 2, pooling_padding: int = 1,
                 use_activation: bool = False, max_pool: bool = True, *,
                 dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.pooling_kernel_size = pooling_kernel_size
        self.pooling_stride, self.pooling_padding = pooling_stride, pooling_padding
        self.use_activation, self.max_pool, self.dtype = use_activation, max_pool, dtype
        # flax he_normal: truncated at two standard deviations, std corrected
        # for the truncation; fan_in k * E * 1
        shape = (kernel_size, embedding_dim, 1, n_output_channels)
        std = math.sqrt(2.0 / (kernel_size * embedding_dim)) / 0.87962566103423978
        kernel = nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                       generator=_generator(generator))
        self.conv = nn.ParameterDict({"kernel": nn.Parameter(kernel)})
        self.to(resolve_device(device))

    def seq_len(self, n: int) -> int:
        """Closed-form output length (the reference probes with a zeros
        forward, tokenizer.py:78-79)."""
        out = conv_seq_len(n, self.kernel_size, self.stride, self.padding)
        if self.max_pool:
            out = conv_seq_len(out, self.pooling_kernel_size, self.pooling_stride,
                               self.pooling_padding)
        return out

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """x: (B, L, E) -> ((B, L'', C), mask): the mask comes back as given;
        forward_mask(mask) is the output's."""
        dtype = self.dtype
        kernel = self.conv["kernel"]
        # the kernel spans the whole embedding width, so the conv is one
        # product of every k-word window (zero-padded ends), flattened to
        # k * E, with the (k * E, C) kernel. cuDNN's input-gradient kernel
        # for the conv2d form (one input channel, a k x E filter) took 388
        # of a 417 ms bf16 training step on an H100.
        windows = F.pad(x.to(dtype), (0, 0, self.padding, self.padding))
        windows = windows.unfold(1, self.kernel_size, self.stride).transpose(2, 3)  # (B, L', k, E)
        h = torch.matmul(windows.flatten(2), kernel.to(dtype).reshape(-1, kernel.shape[-1]))
        if self.use_activation:
            h = F.relu(h)
        if self.max_pool:
            h = F.max_pool1d(h.transpose(1, 2), self.pooling_kernel_size, self.pooling_stride,
                             self.pooling_padding).transpose(1, 2)
        if mask is not None:
            h = h * self.forward_mask(mask).to(dtype)[..., None]
        return h, mask

    def forward_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """tokenizer.py:81-97: a windowed sum with zero padding, then a
        windowed max with -inf padding, then > 0: (B, L) -> (B, L'') bool."""
        m = F.pad((mask > 0).float(), (self.padding, self.padding))
        m = m.unfold(1, self.kernel_size, self.stride).sum(-1)
        if self.max_pool:
            m = F.max_pool1d(m[:, None], self.pooling_kernel_size, self.pooling_stride,
                             self.pooling_padding)[:, 0]
        return m > 0


class MaskedTextLayer(nn.Module):
    """MaskedTransformerEncoderLayer (transformers.py:117-142): pre-norm
    masked attention (qkv without bias), then norm1, whose output replaces
    the residual stream, then linear1 -> GELU -> linear2; LayerNorm eps
    1e-5."""

    def __init__(self, embedding_dim: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.1, attention_dropout: float = 0.1, *,
                 dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = embedding_dim
        gen = _generator(generator)
        self.num_heads, self.dtype = num_heads, dtype
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.pre_norm = LayerNorm(D, 1e-5)
        self.qkv = _dense(D, 3 * D, gen, use_bias=False)
        self.proj = _dense(D, D, gen)
        self.norm1 = LayerNorm(D, 1e-5)
        self.linear1 = _dense(D, dim_feedforward, gen)
        self.linear2 = _dense(dim_feedforward, D, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], dp_rate: float = 0.0,
                dp_masks: Optional[torch.Tensor] = None, dropout_seed: Optional[int] = None,
                *, train: bool = False) -> torch.Tensor:
        """x (B, N, D), mask (B, N) bool or None. dp_masks: (2, B, 1, 1) keep
        masks of the two residual branches (vit.drop_path_masks), or None;
        dropout_seed seeds the layer's dropout generator on x's device."""
        B, N, D = x.shape
        H, dtype = self.num_heads, self.dtype
        dh = D // H
        gen = _seeded(dropout_seed, x.device) if train else None

        h = self.pre_norm(x)
        qkv = self.qkv(h, dtype).reshape(B, N, 3, H, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
        if mask is not None:
            pair = mask[:, None, :, None] & mask[:, None, None, :]  # (B, 1, N, N)
            logits = logits.masked_fill(~pair, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        probs = _dropout(probs, self.attention_dropout, gen)
        att = torch.matmul(probs, v).transpose(1, 2).reshape(B, N, D)
        att = _dropout(self.proj(att, dtype), self.dropout, gen)
        x = x + (att if dp_masks is None else drop_path(att, dp_rate, dp_masks[0]))

        x = self.norm1(x)  # the reference quirk: the residual base is normed
        h = _dropout(fast_gelu(self.linear1(x, dtype)), self.dropout, gen)
        h = _dropout(self.linear2(h, dtype), self.dropout, gen)
        return x + (h if dp_masks is None else drop_path(h, dp_rate, dp_masks[1]))


class MaskedTextClassifier(nn.Module):
    """MaskedTransformerClassifier (transformers.py:509-615): an optional
    class token (seq_pool=False) or softmax seq-pool, the padding-row
    positional embedding (module docstring), the masked layers, the final
    LayerNorm and a linear head giving f32 logits."""

    def __init__(self, seq_len: int, num_classes: int, embedding_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 dropout: float = 0.1, attention_dropout: float = 0.1,
                 stochastic_depth: float = 0.1, positional_embedding: str = "sine",
                 seq_pool: bool = True, *, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        D = embedding_dim
        gen = _generator(generator)
        self.seq_len, self.num_layers = seq_len, num_layers
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.stochastic_depth, self.positional_embedding = stochastic_depth, positional_embedding
        self.seq_pool, self.dtype = seq_pool, dtype
        tokens = seq_len + (0 if seq_pool else 1)
        if not seq_pool:
            self.class_emb = nn.Parameter(torch.zeros(1, 1, D))
        if positional_embedding == "learnable":
            # the reference's shape: (1, N+1, D), row 0 the padding row
            self.positional_emb = nn.Parameter(torch.empty(1, tokens + 1, D))
            _trunc_normal_(self.positional_emb, gen, std=0.2)
        self.blocks = nn.ModuleList(
            MaskedTextLayer(D, num_heads, int(D * mlp_ratio), dropout, attention_dropout,
                            dtype=dtype, device="cpu", generator=gen)
            for _ in range(num_layers))
        self.norm = LayerNorm(D, 1e-5)
        if seq_pool:
            self.attention_pool = _dense(D, 1, gen)
        self.fc = _dense(D, num_classes, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x (B, N, D), mask (B, N) or None -> (B, num_classes) f32 logits.
        With train=True, `generator` draws the dropout seeds and drop-path
        masks (required when any rate is > 0)."""
        B, N, D = x.shape
        dtype, L = self.dtype, self.num_layers
        pe = self.positional_embedding
        # the table is sized from the declared seq_len: a mismatched input
        # fails loudly, as in the JAX package
        if pe != "none" and N != self.seq_len:
            raise ValueError(
                f"input sequence length {N} != declared seq_len {self.seq_len} "
                f"(positional_embedding={pe!r} sizes its table from it)")
        if mask is not None:
            mask = mask > 0
        if not self.seq_pool:
            x = torch.cat([self.class_emb.to(dtype).expand(B, 1, D), x], dim=1)
            N += 1
            if mask is not None:  # the class token is always valid
                mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=mask.device),
                                  mask], dim=1)
        if pe == "learnable":
            x = x + self.positional_emb[:, 1:1 + N].to(dtype)
        elif pe == "sine":
            x = x + torch.from_numpy(sinusoidal_embedding(N, D)).to(x.device, dtype)
        elif pe != "none":
            raise ValueError(f"positional_embedding={pe!r} "
                             "(expected 'learnable', 'sine', or 'none')")

        needs_rng = train and (self.dropout > 0 or self.attention_dropout > 0
                               or self.stochastic_depth > 0)
        if needs_rng and generator is None:
            raise ValueError("train=True with drop-path or dropout needs a generator")
        seeds = [None] * (L + 1)
        if train and (self.dropout > 0 or self.attention_dropout > 0):
            seeds = torch.randint(0, 2 ** 62, (L + 1,), generator=generator,
                                  device=generator.device).tolist()
        dp_rates = torch.linspace(0.0, self.stochastic_depth, L).tolist()
        masks = None
        if train and self.stochastic_depth > 0:
            masks = to_device(drop_path_masks(generator, dp_rates, B), x.device)
        if train:
            x = _dropout(x, self.dropout, _seeded(seeds[0], x.device))
        for i, blk in enumerate(self.blocks):
            x = blk(x, mask, dp_rates[i], None if masks is None else masks[i], seeds[i + 1],
                    train=train)

        x = self.norm(x)
        if self.seq_pool:
            # softmax over the tokens in f32, rounded, then the weighted sum
            w = torch.softmax(self.attention_pool(x, dtype).float(), dim=1).to(dtype)
            pooled = torch.matmul(w.transpose(1, 2), x)[:, 0]
        else:
            pooled = x[:, 0]
        return self.fc(pooled, dtype).float()


class TextCCT(nn.Module):
    """Embedder -> TextTokenizer (stride 2, padding 1, max-pool 3/2/1, no
    activation) -> MaskedTextClassifier at the tokenizer's output length,
    with the tokenizer's output mask."""

    def __init__(self, vocab_size: int, num_classes: int, word_seq_len: int = 64,
                 word_embedding_dim: int = 300, embedding_dim: int = 256, kernel_size: int = 4,
                 num_layers: int = 4, num_heads: int = 4, mlp_ratio: float = 2.0,
                 padding_idx: Optional[int] = 1, positional_embedding: str = "sine",
                 dropout: float = 0.1, attention_dropout: float = 0.1,
                 stochastic_depth: float = 0.1, *, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _generator(generator)
        kw = dict(dtype=dtype, device="cpu", generator=gen)
        self.embedder = Embedder(vocab_size, word_embedding_dim, padding_idx, **kw)
        self.tokenizer = TextTokenizer(
            word_embedding_dim, embedding_dim, kernel_size, stride=2, padding=1,
            pooling_kernel_size=3, pooling_stride=2, pooling_padding=1, max_pool=True, **kw)
        self.classifier = MaskedTextClassifier(
            self.tokenizer.seq_len(word_seq_len), num_classes, embedding_dim, num_layers,
            num_heads, mlp_ratio, dropout, attention_dropout, stochastic_depth,
            positional_embedding, seq_pool=True, **kw)
        self.to(resolve_device(device))

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """ids (B, word_seq_len) int, mask (B, word_seq_len) or None ->
        (B, num_classes) f32 logits."""
        x, mask = self.embedder(ids, mask)
        x, _ = self.tokenizer(x, mask)
        out_mask = self.tokenizer.forward_mask(mask) if mask is not None else None
        return self.classifier(x, out_mask, train=train, generator=generator)

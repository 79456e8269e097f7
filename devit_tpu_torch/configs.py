"""Model geometry registry (counterpart of devit_tpu/configs.py:18-223).

A copy, not an import: the port depends on nothing of the JAX package. The
geometry is the reference registry's (models/de_vit.py:495-513,
models/deit_vit.py:457-525, models/cct.py:226-470).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Geometry + regularisation config for a (De)ViT/DeiT backbone."""

    name: str = "vit"
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    distilled: bool = False
    representation_size: Optional[int] = None
    # width to project captured features to when matching a wider teacher
    resize_dim: Optional[int] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    # set by compaction when the MLP / attention width is no longer the default
    hidden_override: Optional[int] = None
    head_dim_override: Optional[int] = None

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def seq_len(self) -> int:
        return self.num_patches + self.num_prefix_tokens

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        if self.embed_dim % self.num_heads:
            raise ValueError(f"num_heads={self.num_heads} must divide "
                             f"embed_dim={self.embed_dim}")
        return self.embed_dim // self.num_heads

    @property
    def attn_dim(self) -> int:
        """Total attention width H*dh — equals embed_dim unless compacted."""
        return self.num_heads * self.head_dim

    @property
    def hidden_dim(self) -> int:
        if self.hidden_override is not None:
            return self.hidden_override
        return int(self.embed_dim * self.mlp_ratio)

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


def _vit(name: str, **kw) -> ViTConfig:
    return ViTConfig(name=name, **kw)


VIT_CONFIGS = {
    # decomposable students: ViT-S geometry
    "dedeit": _vit("dedeit", embed_dim=384, depth=12, num_heads=6, distilled=True),
    "devit": _vit("devit", embed_dim=384, depth=12, num_heads=6, distilled=False),
    # DeiT teachers
    "deit_base_distilled_patch16_224": _vit(
        "deit_base_distilled_patch16_224", embed_dim=768, depth=12, num_heads=12, distilled=True
    ),
    "deit_base_patch16_224": _vit(
        "deit_base_patch16_224", embed_dim=768, depth=12, num_heads=12, distilled=False
    ),
    "deit_tiny_distilled_patch16_224": _vit(
        "deit_tiny_distilled_patch16_224", embed_dim=192, depth=12, num_heads=3, distilled=True
    ),
    "deit_tiny_patch16_224": _vit(
        "deit_tiny_patch16_224", embed_dim=192, depth=12, num_heads=3, distilled=False
    ),
    # plain ViTs
    "vit_tiny_patch16_224": _vit(
        "vit_tiny_patch16_224", embed_dim=192, depth=12, num_heads=3, distilled=False
    ),
    "vit_base_patch16_224": _vit(
        "vit_base_patch16_224", embed_dim=768, depth=12, num_heads=12, distilled=False
    ),
    "vit_large_patch16_224": _vit(
        "vit_large_patch16_224", embed_dim=1024, depth=24, num_heads=16, distilled=False
    ),
}


def get_vit_config(name: str, **overrides) -> ViTConfig:
    if name not in VIT_CONFIGS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(VIT_CONFIGS)}")
    cfg = VIT_CONFIGS[name]
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


@dataclasses.dataclass(frozen=True)
class CCTConfig:
    """Compact Convolutional Transformer geometry (reference models/cct.py:226-458)."""

    name: str = "cct_7"
    img_size: int = 224
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 256
    num_layers: int = 7
    num_heads: int = 4
    mlp_ratio: float = 2.0
    # Conv tokenizer (reference models/utils/tokenizer.py:6-49).
    kernel_size: int = 7
    stride: Optional[int] = None  # default: max(1, kernel_size // 2 - 1)
    padding: Optional[int] = None  # default: max(1, kernel_size // 2)
    n_conv_layers: int = 2
    pooling_kernel_size: int = 3
    pooling_stride: int = 2
    pooling_padding: int = 1
    positional_embedding: str = "learnable"  # 'learnable' | 'sine' | 'none'
    dropout: float = 0.0
    attention_dropout: float = 0.1
    stochastic_depth: float = 0.1
    seq_pool: bool = True
    backbone: bool = False  # True: headless CCTTransformer returning the pooled feature
    resize_dim: Optional[int] = None

    @property
    def conv_stride(self) -> int:
        return self.stride if self.stride is not None else max(1, (self.kernel_size // 2) - 1)

    @property
    def conv_padding(self) -> int:
        return self.padding if self.padding is not None else max(1, self.kernel_size // 2)

    @property
    def depth(self) -> int:
        """Alias so the generic step factories treat ViT and CCT configs alike."""
        return self.num_layers

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def distilled(self) -> bool:
        return False

    def sequence_length(self) -> int:
        """Token count after the conv tokenizer (the reference probes with a
        zeros forward, tokenizer.py:40-41; here it is closed-form)."""
        size = self.img_size
        for _ in range(self.n_conv_layers):
            size = (size + 2 * self.conv_padding - self.kernel_size) // self.conv_stride + 1
            size = ((size + 2 * self.pooling_padding - self.pooling_kernel_size)
                    // self.pooling_stride + 1)
        return size * size

    @property
    def seq_len(self) -> int:
        """Tokens the transformer sees: the tokenizer's, plus a class token
        without seq-pool."""
        return self.sequence_length() + (0 if self.seq_pool else 1)

    def replace(self, **kw) -> "CCTConfig":
        return dataclasses.replace(self, **kw)


def _cct(name, num_layers, num_heads, mlp_ratio, embed_dim, **kw) -> CCTConfig:
    return CCTConfig(name=name, num_layers=num_layers, num_heads=num_heads,
                     mlp_ratio=mlp_ratio, embed_dim=embed_dim, **kw)


# Mirrors the reference cct_2/4/6/7/14 factories (models/cct.py:226-458).
CCT_CONFIGS = {
    "cct_2": _cct("cct_2", 2, 2, 1.0, 128, kernel_size=3),
    "cct_4": _cct("cct_4", 4, 2, 1.0, 128, kernel_size=3),
    "cct_6": _cct("cct_6", 6, 4, 2.0, 256, kernel_size=3),
    "cct_7": _cct("cct_7", 7, 4, 2.0, 256, kernel_size=3),
    "cct_14": _cct("cct_14", 14, 6, 3.0, 384, kernel_size=7),
}


def get_cct_config(name: str, **overrides) -> CCTConfig:
    """Registry-style names like 'cct_7_3x1_32' or 'cct_7_7x2_224' (the
    reference's cct_{layers}_{kernel}x{conv layers}_{img}, cct.py:252-458)."""
    parts = name.split("_")
    base = "_".join(parts[:2]) if len(parts) >= 2 and parts[0] == "cct" else name
    if base not in CCT_CONFIGS:
        raise KeyError(f"unknown CCT model {name!r}; known bases: {sorted(CCT_CONFIGS)}")
    cfg = CCT_CONFIGS[base]
    kw = {}
    if len(parts) >= 3 and "x" in parts[2]:
        k, c = parts[2].split("x")
        kw["kernel_size"], kw["n_conv_layers"] = int(k), int(c)
    if len(parts) >= 4 and parts[3].isdigit():
        kw["img_size"] = int(parts[3])
    kw.update(overrides)
    return cfg.replace(**kw) if kw else cfg

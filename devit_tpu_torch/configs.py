"""Model geometry registry (counterpart of devit_tpu/configs.py:18-126).

A copy, not an import: the port depends on nothing of the JAX package. The
geometry is the reference registry's (models/de_vit.py:495-513,
models/deit_vit.py:457-525). CCT configs come with the CCT slice.
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

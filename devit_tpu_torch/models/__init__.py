"""Model registry of the PyTorch port (counterpart of
devit_tpu/models/__init__.py): create_model by registered name."""

from devit_tpu_torch.configs import VIT_CONFIGS


def create_model(name: str, **overrides):
    """A registered backbone by name: a ViT/DeiT (models/vit.py create_vit's
    keywords) or a CCT ('cct_*', 'decct_*'; models/cct.py create_cct's)."""
    if name in VIT_CONFIGS:
        from devit_tpu_torch.models.vit import create_vit

        return create_vit(name, **overrides)
    if name.startswith("cct") or name.startswith("decct"):
        from devit_tpu_torch.models.cct import create_cct

        return create_cct(name, **overrides)
    raise KeyError(f"unknown model {name!r}")


__all__ = ["create_model"]

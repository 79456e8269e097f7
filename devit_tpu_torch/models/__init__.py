"""Model registry of the PyTorch port (counterpart of
devit_tpu/models/__init__.py): create_model by registered name."""

from devit_tpu_torch.configs import VIT_CONFIGS


def create_model(name: str, **overrides):
    """A registered ViT/DeiT backbone by name (models/vit.py create_vit's
    keywords). The CCT family raises: it waits for ROADMAP Queue 1 item 7."""
    if name in VIT_CONFIGS:
        from devit_tpu_torch.models.vit import create_vit

        return create_vit(name, **overrides)
    if name.startswith("cct") or name.startswith("decct"):
        raise NotImplementedError(
            f"{name!r}: the CCT family is not ported yet (ROADMAP Queue 1 item 7)")
    raise KeyError(f"unknown model {name!r}")


__all__ = ["create_model"]

from repro_torch.models.api import build_model

__all__ = ["build_model"]

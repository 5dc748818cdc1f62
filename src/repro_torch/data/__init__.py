from repro_torch.data.pipeline import TokenPipeline

__all__ = ["TokenPipeline"]

from repro_torch.profiling.instrument import Profiler

__all__ = ["Profiler"]

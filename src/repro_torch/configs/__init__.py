from repro_torch.configs.base import (ARCH_REGISTRY, ModelConfig,
                                      ShapeConfig, SHAPES, get_arch, reduced,
                                      register_arch)

__all__ = ["ARCH_REGISTRY", "ModelConfig", "ShapeConfig", "SHAPES",
           "get_arch", "reduced", "register_arch"]

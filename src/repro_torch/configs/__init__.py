from .base import LayerSpec, ModelConfig, RunShape, SHAPES, shapes_for
from .archs import REGISTRY, get

__all__ = [
    "LayerSpec", "ModelConfig", "RunShape", "SHAPES", "shapes_for",
    "REGISTRY", "get",
]

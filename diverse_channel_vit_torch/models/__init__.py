"""Model zoo of the port: importing this package fills :data:`MODEL_REGISTRY`."""

from .registry import MODEL_REGISTRY, build_model, register_model
from . import dichavit  # noqa: F401  (registers dichavit)

from .channel_vit import SIZE_PRESETS, ChannelVisionTransformer
from .wrappers import ChannelAdaptiveClassifier

__all__ = [
    "MODEL_REGISTRY",
    "build_model",
    "register_model",
    "ChannelVisionTransformer",
    "ChannelAdaptiveClassifier",
    "SIZE_PRESETS",
]

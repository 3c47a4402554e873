"""Model zoo of the port: importing this package fills :data:`MODEL_REGISTRY`."""

from .registry import MODEL_REGISTRY, build_model, register_model
from . import dichavit  # noqa: F401  (registers dichavit, channelvit_adapt)
from . import vit_adapt  # noqa: F401
from . import depthwise_vit  # noqa: F401  (registers depthwisevit_adapt)
from . import hyper_vit  # noqa: F401  (registers hypervit_adapt)
from . import template_mixing_vit  # noqa: F401  (registers templatemixingvit)
from . import convnext_variants  # noqa: F401  (registers the six ConvNeXt models)

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

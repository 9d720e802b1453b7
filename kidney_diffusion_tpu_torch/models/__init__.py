from .configs import CascadeConfig, EDMConfig, StageConfig, UNetConfig
from .unet import EfficientUNet, NullUNet

__all__ = [
    "CascadeConfig",
    "EDMConfig",
    "EfficientUNet",
    "NullUNet",
    "StageConfig",
    "UNetConfig",
]

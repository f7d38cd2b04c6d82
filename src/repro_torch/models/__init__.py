from .config import ArchConfig
from .lm import DecoderLM, EncDecLM, build_model
from .params import P, count_params, from_jax, init_params, resnet_from_jax
from .resnet import ResNet, ResNetConfig

__all__ = ["ArchConfig", "DecoderLM", "EncDecLM", "P", "ResNet", "ResNetConfig", "build_model",
           "count_params", "from_jax", "init_params", "resnet_from_jax"]

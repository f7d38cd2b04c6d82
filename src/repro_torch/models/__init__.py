from .config import ArchConfig
from .lm import DecoderLM
from .params import P, count_params, from_jax, init_params

__all__ = ["ArchConfig", "DecoderLM", "P", "count_params", "from_jax", "init_params"]

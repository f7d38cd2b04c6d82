from .config import ArchConfig
from .lm import DecoderLM, EncDecLM, build_model
from .params import P, count_params, from_jax, init_params

__all__ = ["ArchConfig", "DecoderLM", "EncDecLM", "P", "build_model", "count_params",
           "from_jax", "init_params"]

"""Checkpoint interop: JAX pytrees, flax msgpack files and upstream `.pth`
files."""
from .weights import (
    MODELS, jax_from_state_dict, load_pth, model_from_state_dict, save_pth,
    state_dict_from_jax)

__all__ = ["MODELS", "jax_from_state_dict", "load_pth",
           "model_from_state_dict", "save_pth", "state_dict_from_jax"]

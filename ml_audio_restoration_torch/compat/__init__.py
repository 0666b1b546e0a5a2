"""Checkpoint interop: JAX pytrees and upstream `.pth` files."""
from .weights import (
    MODELS, load_pth, model_from_state_dict, state_dict_from_jax)

__all__ = ["MODELS", "load_pth", "model_from_state_dict",
           "state_dict_from_jax"]

"""Model plugin registry (reference capability: models/registry.py).

Maps `config.json`'s `model_type` to an engine factory. Engines register at
import time; `MODEL_REGISTRY` resolves lazily so importing the registry never
pulls heavy model code.
"""
from __future__ import annotations

from typing import Callable, Dict

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(model_type: str, factory: Callable) -> None:
    MODEL_REGISTRY[model_type] = factory


def get_model_factory(model_type: str) -> Callable:
    if model_type not in MODEL_REGISTRY:
        # trigger built-in registrations
        from . import xttsv2  # noqa: F401
    if model_type not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model_type '{model_type}'. Registered: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[model_type]

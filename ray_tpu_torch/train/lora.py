"""LoRA parameter partitioning for frozen-base fine-tuning: the port of
ray_tpu/train/lora.py.

The reference splits a flax tree so that ``jax.grad`` differentiates only
the adapter leaves and the optimizer holds state only for them. The port's
parameters are flat dicts keyed by dotted paths (``Llama.state_dict()``,
``named_parameters()``); a key is an adapter if its last part is ``lora_a``
or ``lora_b`` (models/llama.py ``LoRADense``), and base otherwise.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, TypeVar

V = TypeVar("V")


def _is_lora_key(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in ("lora_a", "lora_b")


def split_lora(params: Mapping[str, V]) -> Tuple[Dict[str, V], Dict[str, V]]:
    """Split a flat param dict into (base, lora) dicts."""
    base = {k: v for k, v in params.items() if not _is_lora_key(k)}
    lora = {k: v for k, v in params.items() if _is_lora_key(k)}
    return base, lora


def merge_lora(base: Mapping[str, V], lora: Mapping[str, V]) -> Dict[str, V]:
    """Inverse of :func:`split_lora`: one flat param dict."""
    overlap = set(base) & set(lora)
    if overlap:
        raise KeyError(f"keys in both base and lora: {sorted(overlap)}")
    return {**base, **lora}


def lora_label_fn(params: Mapping[str, object]) -> Dict[str, str]:
    """Per-key ``"lora"``/``"frozen"`` labels, for a caller that prefers
    masking one dict over splitting it."""
    return {k: ("lora" if _is_lora_key(k) else "frozen") for k in params}

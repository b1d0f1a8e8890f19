"""Task argument flattening.

Equivalent of the reference's argument handling in submit (_raylet.pyx
prepare_args): top-level ObjectRef arguments are extracted and passed
by-reference (so the executor resolves them through the ownership layer);
everything else is serialized inline as one (args, kwargs) structure with
placeholders marking where resolved references get substituted back.

Refs nested inside containers are serialized in place; they deserialize on the
executor as borrowed refs carrying their owner's address.

A copy of ``ray_tpu/_internal/args.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class ArgPlaceholder:
    index: int


def flatten(args: tuple, kwargs: dict) -> Tuple[tuple, List[Any]]:
    """Returns ((args, kwargs) with placeholders, extracted top-level refs)."""
    from ..object_ref import ObjectRef

    extracted: List[Any] = []

    def repl(x):
        if isinstance(x, ObjectRef):
            extracted.append(x)
            return ArgPlaceholder(len(extracted) - 1)
        return x

    new_args = tuple(repl(a) for a in args)
    new_kwargs = {k: repl(v) for k, v in kwargs.items()}
    return (new_args, new_kwargs), extracted


def reconstruct(structure: tuple, resolved: List[Any]) -> Tuple[tuple, Dict]:
    args, kwargs = structure

    def sub(x):
        return resolved[x.index] if isinstance(x, ArgPlaceholder) else x

    return tuple(sub(a) for a in args), {k: sub(v) for k, v in kwargs.items()}

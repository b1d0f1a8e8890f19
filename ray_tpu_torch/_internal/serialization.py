"""Control-plane serialization: the port of ray_tpu/_internal/serialization.py's
``dumps`` / ``loads``.

A shipment descriptor (``kvtier.KVShipment``) and a pytree's structure
cross the control plane as bytes. The reference pickles them with
cloudpickle; these are plain data (dataclasses, lists, the treedef of
``torch.utils._pytree``), which the standard library's pickle carries, so
the port needs no cloudpickle (the card's machine has none). The object
plane's out-of-band buffer format waits for the runtime.

Only bytes this program wrote are unpickled: unpickling can run code.
"""

from __future__ import annotations

import pickle
from typing import Any


def dumps(value: Any) -> bytes:
    """Pickle (protocol 5) for control-plane payloads."""
    return pickle.dumps(value, protocol=5)


def loads(raw: bytes) -> Any:
    return pickle.loads(raw)

"""The device calls of ``torch.cuda`` over two fake cards (see the package
docstring)."""

import threading

_DEVICES = 2
_local = threading.local()


def is_available() -> bool:
    return True


def device_count() -> int:
    return _DEVICES


def set_device(index: int) -> None:
    if not 0 <= int(index) < _DEVICES:
        raise RuntimeError(f"invalid device ordinal {index}")
    _local.device = int(index)


def current_device() -> int:
    return getattr(_local, "device", 0)


def init() -> None:
    """Nothing to create: the cards are fake."""

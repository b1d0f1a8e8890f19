"""ctypes binding for the native store (reference role: plasma client.h).

``load()`` builds (if needed) and loads the store library; returns None
when no C++ toolchain is available so callers can fall back to the pure-
Python store (``runtime.object_store.native_store.store_kind`` says which
one a raylet took).

A copy of ``ray_tpu/_native/lib.py`` (host code: the port imports nothing of
``ray_tpu``).
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional

logger = logging.getLogger(__name__)

_lib = None
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    try:
        from .build import build

        path = build()
        lib = ctypes.CDLL(path)
    except Exception as e:  # toolchain missing / build failure
        logger.warning("native store unavailable, using python store: %s", e)
        _load_failed = True
        return None
    lib.rt_store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.rt_store_open.restype = ctypes.c_int
    lib.rt_store_close.argtypes = [ctypes.c_int]
    lib.rt_create.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64]
    lib.rt_create.restype = ctypes.c_int64
    lib.rt_seal.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.rt_seal.restype = ctypes.c_int
    lib.rt_get.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rt_get.restype = ctypes.c_int
    lib.rt_release.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.rt_pin_primary.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.rt_contains.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.rt_contains.restype = ctypes.c_int
    lib.rt_free.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.rt_free.restype = ctypes.c_int
    lib.rt_free_if_unpinned.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.rt_free_if_unpinned.restype = ctypes.c_int
    lib.rt_used.argtypes = [ctypes.c_int]
    lib.rt_used.restype = ctypes.c_uint64
    lib.rt_num_objects.argtypes = [ctypes.c_int]
    lib.rt_num_objects.restype = ctypes.c_uint64
    lib.rt_lru_spillable.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.rt_lru_spillable.restype = ctypes.c_int
    lib.rt_true_size.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.rt_true_size.restype = ctypes.c_uint64
    lib.rt_transfer_serve.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_char_p,
    ]
    lib.rt_transfer_serve.restype = ctypes.c_int
    lib.rt_transfer_stop.argtypes = [ctypes.c_int]
    lib.rt_transfer_fetch.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rt_transfer_fetch.restype = ctypes.c_int
    _lib = lib
    return _lib

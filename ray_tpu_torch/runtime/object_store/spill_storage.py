"""Pluggable spill storage: local filesystem or external object stores.

Role-equivalent of the reference's external storage layer
(_private/external_storage.py:399 — FileSystemStorage and the smart_open
S3/GCS backends): spilled primary copies can land on a remote store instead
of node-local disk, surviving node loss and freeing local disk on shared
hosts. Refs without a URI scheme are plain local paths (the default, fast
path); refs with a scheme dispatch through fsspec — ``memory://`` works out
of the box (tests), ``s3://``/``gs://`` wherever s3fs/gcsfs are installed.
Configure with ``spill_storage_uri`` (e.g. "memory://spill",
"gs://bucket/cluster-1"); empty keeps node-local disk.

A copy of ``ray_tpu/runtime/object_store/spill_storage.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import os


class SpillStorageError(Exception):
    """Transient/unknown backend failure — deliberately NOT OSError: callers
    treat FileNotFoundError/OSError as 'the copy is gone' and drop their
    pointer; a network timeout against a durable blob must not do that."""


def is_external(ref: str) -> bool:
    return "://" in ref


def write(ref: str, data: bytes) -> None:
    if not is_external(ref):
        tmp = ref + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, ref)
        return
    import fsspec

    # same tmp+rename discipline as the local path: a crash mid-write must
    # leave either nothing under the final key or a fully-formed blob —
    # never a truncated object a later restore would read as valid data.
    # (On object stores mv is copy+delete, but the final key still only
    # ever holds complete bytes; an orphaned .tmp key is never read.)
    fs, path = fsspec.core.url_to_fs(ref)
    tmp_path = f"{path}.tmp-{os.getpid()}"
    with fs.open(tmp_path, "wb") as f:
        f.write(data)
    fs.mv(tmp_path, path)


def read(ref: str) -> bytes:
    if not is_external(ref):
        with open(ref, "rb") as f:
            return f.read()
    import fsspec

    try:
        with fsspec.open(ref, "rb") as f:
            return f.read()
    except FileNotFoundError:
        raise  # the copy is genuinely gone
    except Exception as e:
        raise SpillStorageError(f"spill read failed: {ref}: {e}") from e


def read_range(ref: str, offset: int, length: int) -> tuple:
    """(total_size, chunk) — ranged read for chunked peer pulls; external
    backends issue a ranged GET instead of downloading the whole blob per
    chunk."""
    if not is_external(ref):
        total = os.path.getsize(ref)
        with open(ref, "rb") as f:
            f.seek(offset)
            return total, f.read(length)
    import fsspec

    try:
        fs, path = fsspec.core.url_to_fs(ref)
        total = fs.info(path)["size"]
        with fs.open(path, "rb") as f:
            f.seek(offset)
            return total, f.read(length)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise SpillStorageError(f"spill range read failed: {ref}: {e}") from e


def delete(ref: str) -> None:
    if not is_external(ref):
        try:
            os.remove(ref)
        except OSError:
            pass
        return
    import fsspec

    try:
        fs, path = fsspec.core.url_to_fs(ref)
        fs.rm(path)
    except Exception:
        pass

"""Runtime environments: per-task/actor execution environments.

Role-equivalent of the reference's runtime_env subsystem
(python/ray/_private/runtime_env/: working_dir.py, py_modules.py,
plugin.py and the per-node runtime-env agent): a task or actor may declare
``runtime_env={"env_vars": ..., "working_dir": ..., "py_modules": [...]}``.
The driver normalizes the env — packaging local directories into zip
archives uploaded once to the GCS KV (reference: runtime-env packaging
into the GCS / external storage) — and the raylet gives tasks **dedicated
workers** whose environment fingerprint matches (reference: WorkerPool
runtime-env matching, worker_pool.h:276). Worker processes materialize the
env at startup: download + extract packages, set sys.path/cwd, apply env
vars.

``pip``/``conda`` envs are rejected: this framework runs on immutable TPU
images where dependencies are baked in (the reference's conda/pip plugins
install at worker start, which is forbidden here).

A copy of ``ray_tpu/_internal/runtime_env.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import tempfile
import zipfile
from typing import Any, Dict, Optional

from ..runtime.gcs import keys as gcs_keys

_VALID_KEYS = {"env_vars", "working_dir", "py_modules", "pip", "conda",
               "config", "excludes"}
_PKG_PREFIX = gcs_keys.RUNTIME_ENV_PKG.scan
_PKG_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_pkgs")
_MAX_PKG_BYTES = 100 * 1024 * 1024


class RuntimeEnvSetupError(Exception):
    pass


def _zip_dir(path: str, excludes=()) -> bytes:
    buf = io.BytesIO()
    path = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in ("__pycache__", ".git")]
            for name in files:
                full = os.path.join(root, name)
                rel = os.path.relpath(full, path)
                if any(rel.startswith(e) for e in excludes):
                    continue
                zf.write(full, rel)
    data = buf.getvalue()
    if len(data) > _MAX_PKG_BYTES:
        raise RuntimeEnvSetupError(
            f"packaged {path} is {len(data)} bytes (> {_MAX_PKG_BYTES}); "
            "use excludes to trim it"
        )
    return data


async def _upload_package(worker, path: str, excludes=()) -> str:
    """Zip + content-address + upload once; returns the pkg URI."""
    data = _zip_dir(path, excludes)
    digest = hashlib.sha1(data).hexdigest()
    key = f"{_PKG_PREFIX}{digest}"
    gcs = worker.client_pool.get(*worker.gcs_address)
    if not await gcs.call("kv_exists", key):
        await gcs.call("kv_put", key, data, True)
    return key


async def normalize(runtime_env: Optional[dict], worker) -> Optional[dict]:
    """Driver-side validation + packaging (reference:
    runtime_env/runtime_env.py RuntimeEnv validation + upload_*_if_needed)."""
    if not runtime_env:
        return None
    unknown = set(runtime_env) - _VALID_KEYS
    if unknown:
        raise RuntimeEnvSetupError(f"unknown runtime_env keys: {sorted(unknown)}")
    if runtime_env.get("pip") or runtime_env.get("conda"):
        raise RuntimeEnvSetupError(
            "pip/conda runtime envs are not supported on immutable TPU "
            "images; bake dependencies into the image or use py_modules"
        )
    out: Dict[str, Any] = {}
    env_vars = runtime_env.get("env_vars")
    if env_vars:
        if not all(
            isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()
        ):
            raise RuntimeEnvSetupError("env_vars must be Dict[str, str]")
        out["env_vars"] = dict(sorted(env_vars.items()))
    excludes = tuple(runtime_env.get("excludes") or ())
    wd = runtime_env.get("working_dir")
    if wd:
        if not os.path.isdir(wd):
            raise RuntimeEnvSetupError(f"working_dir {wd!r} is not a directory")
        out["working_dir"] = await _upload_package(worker, wd, excludes)
    mods = runtime_env.get("py_modules")
    if mods:
        uris = []
        for mod in mods:
            if not os.path.isdir(mod):
                raise RuntimeEnvSetupError(f"py_module {mod!r} is not a directory")
            uris.append(await _upload_package(worker, mod, excludes))
        out["py_modules"] = uris
    return out or None


def env_key(normalized: Optional[dict]) -> str:
    """Stable fingerprint used for dedicated-worker matching (reference:
    WorkerPool keying worker processes by serialized runtime env)."""
    if not normalized:
        return ""
    return hashlib.sha1(
        json.dumps(normalized, sort_keys=True).encode()
    ).hexdigest()[:16]


async def materialize(normalized: dict, gcs_client) -> None:
    """Worker-side setup at process start (reference: the runtime-env
    agent's CreateRuntimeEnv handled per plugin)."""
    for k, v in (normalized.get("env_vars") or {}).items():
        os.environ[k] = v
    paths = []
    wd_uri = normalized.get("working_dir")
    if wd_uri:
        target = await _fetch_package(wd_uri, gcs_client)
        os.chdir(target)
        paths.append(target)
    for uri in normalized.get("py_modules") or []:
        paths.append(await _fetch_package(uri, gcs_client))
    for p in reversed(paths):
        if p not in sys.path:
            sys.path.insert(0, p)


_normalize_cache: Dict[str, Optional[dict]] = {}


def normalize_cached(runtime_env: Optional[dict], worker) -> Optional[dict]:
    """Sync driver-side normalization with memoization (re-zipping the
    working_dir on every .remote() would dominate submission cost)."""
    if not runtime_env:
        return None
    cache_key = json.dumps(runtime_env, sort_keys=True, default=str)
    if cache_key not in _normalize_cache:
        from .. import _worker_api

        _normalize_cache[cache_key] = _worker_api.run_on_worker_loop(
            normalize(runtime_env, worker)
        )
    return _normalize_cache[cache_key]


async def _fetch_package(uri: str, gcs_client) -> str:
    digest = uri[len(_PKG_PREFIX):]
    target = os.path.join(_PKG_DIR, digest)
    if os.path.isdir(target):
        return target
    data = await gcs_client.call("kv_get", uri)
    if data is None:
        raise RuntimeEnvSetupError(f"package {uri} not found in GCS")
    os.makedirs(_PKG_DIR, exist_ok=True)
    tmp = target + f".tmp.{os.getpid()}"
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, target)
    except OSError:
        # concurrent extraction won the race
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return target

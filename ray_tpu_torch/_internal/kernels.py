"""Build, load and call the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``_build/lib<name>-<hash>.so``,
where the hash covers the source, the shared headers and the flags: an
edited source builds anew, an unchanged one is reused. The build happens at
first use (or all at once through :func:`build`, one ``nvcc`` process per
source, started together) and the library is loaded with ``ctypes``.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``. A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# must match enum RtDtype in csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def sources() -> List[str]:
    """Names of the kernel libraries: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``), from
    ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or the PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", name), shutil.which(name)):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        f"{name} not found (looked in $CUDA_HOME/bin and on PATH); the port's "
        "kernels are built from ray_tpu_torch/csrc at first use"
    )


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` per source, all running at once. Returns the wall
    seconds spent; raises with the compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    t0 = time.perf_counter()
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = cuda_tool()
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def function(
    lib: str, fn: str, argtypes: Sequence, restype=ctypes.c_int
) -> ctypes._CFuncPtr:
    """The C entry ``fn`` of library ``lib``, built and loaded on first use,
    with its ``argtypes`` and ``restype`` (by default the ``int`` of a
    cudaError_t) set."""
    key = (lib, fn)
    with _lock:
        f = _fns.get(key)
        if f is None:
            if lib not in _libs:
                build([lib])
                _libs[lib] = ctypes.CDLL(str(lib_path(lib)))
            f = getattr(_libs[lib], fn)
            f.argtypes = list(argtypes)
            f.restype = restype
            _fns[key] = f
    return f


def check(lib: str, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err:
        name = function(lib, "rt_error_string", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(
            f"{what} failed: CUDA error {err} ({name(err).decode()})"
        )


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(
            f"kernel takes float32, bfloat16 or float16, not {dtype}"
        ) from None


def check_layout(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is contiguous and 16-byte aligned, as the kernels'
    vector loads need."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

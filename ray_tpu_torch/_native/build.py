"""Build the native object store (g++ -> ``_build/libstore-<hash>.so``).

The port of ray_tpu/_native/build.py. The library is built from the port's
own copy of ``store.cc`` at first use (``runtime.object_store.native_store.
create_object_store``) or by hand (``python -m ray_tpu_torch._native.build``),
into ``ray_tpu_torch/_build/``, under a name keyed by the source's content
and the flags: a process that finds the file loads it, and no two
processes of one checkout build it twice unless they race (the rename is
atomic). No external dependency: plain g++ and pthread. The reference's C++
cross-language client is not ported.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "store.cc"
BUILD_DIR = _DIR.parent / "_build"
FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-pthread"]


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libstore-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> str:
    """Compile the store library if it is not built yet; returns its path.
    Raises with the compiler's output if g++ fails."""
    out = lib_path()
    if out.exists() and not force:
        return str(out)
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{r.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders race safely
    return str(out)


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))

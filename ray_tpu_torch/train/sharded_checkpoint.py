"""Sharded checkpointing of tensor state: the port of
ray_tpu/train/sharded_checkpoint.py.

The reference writes a pytree of jax arrays with orbax (OCDBT): every host
writes only its own shards, and a restore lays the arrays out onto any
target sharding, so a checkpoint taken on one mesh restores onto a mesh of
another size. The port does the same with its own format (``torch.save``;
orbax is not on the card's machine, so the port cannot read a checkpoint of
the reference's):

    <path>/sharded_state/manifest.json   global shape, dtype and spec of
                                         every tensor, the block each file
                                         holds, and the scalars
    <path>/sharded_state/rank<r>.pt      the blocks rank r wrote

A state is a mapping (nested or flat) of tensors and Python scalars; each
tensor is the rank's block under the :class:`~ray_tpu_torch.parallel.
sharding.NamedSharding` at the same place in ``shardings`` (its mesh bound
to the rank), or the whole tensor where there is none (without
``shardings`` the caller is rank 0). Each block is
written once, by the lowest rank that holds it (a replicated tensor by rank
0). Every rank calls :func:`save_sharded`; the checkpoint is whole once all
have returned (the caller's barrier, as orbax's). A restore maps the files
and copies out only the blocks that overlap what the rank asks for.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from ..parallel.sharding import NamedSharding, block_index

_STATE_SUBDIR = "sharded_state"
_MANIFEST = "manifest.json"
_SEP = "/"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}{_SEP}"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, val in flat.items():
        *parents, leaf = path.split(_SEP)
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = val
    return out


def _spec_json(spec) -> List[Any]:
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _global_shape(local: torch.Tensor, sharding: NamedSharding) -> List[int]:
    """The sharding's recorded shape, else the block's scaled by its axes
    (a padded dimension needs the recorded one)."""
    if sharding.shape is not None:
        return list(sharding.shape)
    shape = list(local.shape)
    for dim, axes in enumerate(sharding.spec):
        names = () if axes is None else ((axes,) if isinstance(axes, str) else axes)
        for a in names:
            shape[dim] *= sharding.mesh.shape[a]
    return shape


def _layout(flat: Mapping[str, Any], shardings: Mapping[str, Any]):
    """(rank, manifest entries, {path: this rank's tensor to write})."""
    rank = _rank_of(shardings)
    leaves, values, mine = {}, {}, {}
    for path, val in flat.items():
        if not isinstance(val, torch.Tensor):
            values[path] = val
            continue
        sharding = shardings.get(path)
        if sharding is None:
            leaves[path] = dict(shape=list(val.shape), dtype=str(val.dtype), spec=[],
                                mesh=None, shards=[dict(rank=0, index=[[0, n] for n in val.shape])])
            if rank == 0:
                mine[path] = val
            continue
        mesh = sharding.mesh
        shape = _global_shape(val, sharding)
        writers: Dict[Tuple, int] = {}
        for r in range(mesh.size):
            index = tuple((o, o + n) for o, n in block_index(shape, sharding.spec,
                                                             mesh.coords(r), mesh.shape))
            writers.setdefault(index, r)
        leaves[path] = dict(shape=shape, dtype=str(val.dtype), spec=_spec_json(sharding.spec),
                            mesh=mesh.shape, shards=[dict(rank=r, index=[list(i) for i in index])
                                                     for index, r in writers.items()])
        if rank in writers.values():
            mine[path] = val
    return rank, dict(format=1, leaves=leaves, values=values), mine


def _rank_of(shardings: Mapping[str, Any]) -> int:
    ranks = {s.mesh.rank for s in shardings.values() if s is not None}
    if len(ranks) > 1:
        raise ValueError(f"the shardings' meshes are bound to ranks {sorted(ranks)}, not one")
    return ranks.pop() if ranks else 0


def _write(target: str, rank: int, manifest: dict, blocks: Mapping[str, torch.Tensor]) -> None:
    os.makedirs(target, exist_ok=True)
    tmp = os.path.join(target, f".rank{rank:05d}.pt.{os.getpid()}")
    torch.save(dict(blocks), tmp)
    os.replace(tmp, os.path.join(target, f"rank{rank:05d}.pt"))
    if rank == 0:
        tmp = os.path.join(target, f".{_MANIFEST}.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(target, _MANIFEST))


def _prepare(path: str, state: Mapping[str, Any], shardings: Optional[Mapping[str, Any]],
             snapshot: bool):
    flat = _flatten(state)
    shard_flat = _flatten(shardings) if shardings is not None else {}
    unknown = set(shard_flat) - set(flat)
    if unknown:
        raise KeyError(f"shardings name no tensor of the state: {sorted(unknown)}")
    rank, manifest, mine = _layout(flat, shard_flat)
    blocks = {p: (t.detach().to("cpu", copy=True) if snapshot else t.detach().cpu()).contiguous()
              for p, t in mine.items()}
    return os.path.join(os.path.abspath(path), _STATE_SUBDIR), rank, manifest, blocks


def save_sharded(path: str, state: Mapping[str, Any],
                 shardings: Optional[Mapping[str, Any]] = None) -> str:
    """Write this rank's blocks of ``state`` (see the module docstring) and,
    on rank 0, the manifest; an earlier checkpoint at ``path`` is
    overwritten. Returns the state directory."""
    target, rank, manifest, blocks = _prepare(path, state, shardings, snapshot=False)
    _write(target, rank, manifest, blocks)
    return target


class ShardedCheckpointWriter:
    """Async writer: :meth:`save` copies this rank's blocks to the host
    before it returns (the optimizer updates the tensors in place), then
    writes them in a background thread while training goes on. A second
    save, :meth:`wait` and :meth:`close` join the write in flight and raise
    its error, if it failed."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, path: str, state: Mapping[str, Any],
             shardings: Optional[Mapping[str, Any]] = None) -> str:
        self.wait()
        target, rank, manifest, blocks = _prepare(path, state, shardings, snapshot=True)

        def run():
            try:
                _write(target, rank, manifest, blocks)
            except Exception as e:  # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="sharded-checkpoint", daemon=True)
        self._thread.start()
        return target

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self):
        self.wait()


def _overlap(a: List[List[int]], b: List[Tuple[int, int]]):
    """The intersection of two boxes (one [start, stop) a dimension), or None."""
    box = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi and not (a0 == a1 == b0 == b1):
            return None
        box.append((lo, hi))
    return box


def _read_leaf(src: str, entry: dict, want: List[Tuple[int, int]], dtype, files: dict,
               path: str) -> torch.Tensor:
    out = torch.empty([hi - lo for lo, hi in want], dtype=dtype)
    filled = 0
    for shard in entry["shards"]:
        box = _overlap(shard["index"], want)
        if box is None:
            continue
        r = shard["rank"]
        if r not in files:
            files[r] = torch.load(os.path.join(src, f"rank{r:05d}.pt"), mmap=True,
                                  weights_only=True)
        block = files[r][path]
        got = block[tuple(slice(lo - s0, hi - s0) for (lo, hi), (s0, _) in
                          zip(box, shard["index"]))]
        out[tuple(slice(lo - w0, hi - w0) for (lo, hi), (w0, _) in zip(box, want))] = got
        filled += got.numel()
    if filled != out.numel():
        raise ValueError(f"{path}: the checkpoint's blocks cover {filled} of {out.numel()} "
                         "requested elements")
    return out


def restore_sharded(path: str, *, target: Optional[Mapping[str, Any]] = None,
                    shardings: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Restore a sharded checkpoint.

    ``target``: a template tree fixing the structure (only its tensors are
    read), and the dtype and device of each tensor. ``shardings``: a
    matching tree of :class:`NamedSharding` (meshes bound to this rank) that
    lays the restored tensors onto the CURRENT mesh: each leaf comes back as
    this rank's block, on its mesh's device, whatever mesh wrote it. A
    tensor without either comes back whole, on the CPU."""
    src = os.path.join(os.path.abspath(path), _STATE_SUBDIR)
    if not os.path.exists(os.path.join(src, _MANIFEST)):
        raise FileNotFoundError(f"no sharded state under {path}")
    with open(os.path.join(src, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves, values = manifest["leaves"], manifest["values"]
    shard_flat = _flatten(shardings) if shardings is not None else {}
    target_flat = _flatten(target) if target is not None else {}
    paths = list(target_flat) if target is not None else list(leaves) + list(values)
    files: Dict[int, Any] = {}
    out: Dict[str, Any] = {}
    for p in paths:
        if p in values:
            out[p] = values[p]
            continue
        if p not in leaves:
            raise KeyError(f"the checkpoint holds no {p!r}")
        entry = leaves[p]
        like = target_flat.get(p)
        dtype = like.dtype if isinstance(like, torch.Tensor) else getattr(torch, entry["dtype"][6:])
        sharding = shard_flat.get(p)
        if sharding is not None:
            want = [(o, o + n) for o, n in block_index(entry["shape"], sharding.spec,
                                                       sharding.mesh.coords(),
                                                       sharding.mesh.shape)]
            device = sharding.mesh.device()
        else:
            want = [(0, n) for n in entry["shape"]]
            device = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
        out[p] = _read_leaf(src, entry, want, dtype, files, p).to(device)
    return _unflatten(out)


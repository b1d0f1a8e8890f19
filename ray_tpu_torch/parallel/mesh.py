"""Rank meshes: the port of ray_tpu/parallel/mesh.py.

The reference's mesh is a ``jax.sharding.Mesh``: one program over a grid of
devices, with XLA inserting the collectives. The port runs one process per
rank (PyTorch's idiom), so a :class:`Mesh` here is the rank grid with one
device per rank (a card index, or ``"cpu"``), this process's rank in it, and
the collective group of each axis once the ranks have formed one
(:meth:`Mesh.bind`). Axes and their order are the reference's:

  dp    data parallelism (pure replication of params)
  fsdp  fully-sharded data parallelism (params sharded over the batch axis)
  tp    tensor parallelism (megatron-style weight sharding, the fastest axis)
  sp    sequence/context parallelism (ring attention)
  ep    expert parallelism (MoE all_to_all dispatch)
  pp    pipeline stages
  dcn   across-host data parallelism

Rank r's coordinates are its row-major position in the grid of
:data:`AXIS_ORDER`, so the ranks of one ``tp`` group are neighbours, as the
reference puts tp on the innermost (fastest) device dimension.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

# canonical axis order: slowest (dcn) to fastest (tp)
AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")

# the axes that split the batch
BATCH_AXES = ("dcn", "dp", "fsdp")

#: a rank's device: a card index, or "cpu"
RankDevice = Union[int, str]


def normalize_devices(devices: Optional[Sequence[Any]] = None) -> List[RankDevice]:
    """Each entry as a card index or ``"cpu"``: ints, ``"cuda:<i>"``,
    ``"cpu"`` and ``torch.device`` are accepted. ``None`` means every card
    of this host, and raises without one (entry points run on the card
    unless the caller names the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] to run "
                "the ranks on the CPU"
            )
        return list(range(torch.cuda.device_count()))
    out: List[RankDevice] = []
    for d in devices:
        if isinstance(d, int):
            out.append(d)
            continue
        dev = torch.device(d)
        if dev.type == "cpu":
            out.append("cpu")
        elif dev.type == "cuda":
            out.append(0 if dev.index is None else dev.index)
        else:
            raise ValueError(f"a rank runs on a card or the CPU, got {d!r}")
    return out


def torch_device(device: RankDevice) -> torch.device:
    return torch.device("cpu") if device == "cpu" else torch.device("cuda", int(device))


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. -1 for at most one axis means 'absorb the
    remaining devices'."""

    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    dcn: int = 1

    def resolved_sizes(self, num_devices: int) -> Dict[str, int]:
        sizes = {
            "dcn": self.dcn,
            "pp": self.pp,
            "dp": self.dp,
            "fsdp": self.fsdp,
            "ep": self.ep,
            "sp": self.sp,
            "tp": self.tp,
        }
        fixed = 1
        wild = None
        for name, size in sizes.items():
            if size == -1:
                if wild is not None:
                    raise ValueError("only one mesh axis may be -1")
                wild = name
            else:
                fixed *= size
        if wild is not None:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[wild] = num_devices // fixed
        total = math.prod(sizes.values())
        if total != num_devices:
            raise ValueError(
                f"mesh {sizes} needs {total} devices, have {num_devices}"
            )
        return sizes

    def build(self, devices: Optional[Sequence[Any]] = None) -> "Mesh":
        devs = normalize_devices(devices)
        sizes = self.resolved_sizes(len(devs))
        return Mesh(devs, {a: sizes[a] for a in AXIS_ORDER})


class Mesh:
    """The rank grid: ``devices[r]`` is rank r's device, ``shape`` the size
    of every axis of :data:`AXIS_ORDER`. ``rank`` is this process's rank and
    ``groups`` the collective group of each axis it belongs to (empty until
    :meth:`bind`)."""

    axis_names = AXIS_ORDER

    def __init__(self, devices: Sequence[RankDevice], shape: Dict[str, int],
                 rank: int = 0, groups: Optional[Dict[str, Any]] = None):
        if math.prod(shape.values()) != len(devices):
            raise ValueError(f"mesh {shape} needs {math.prod(shape.values())} "
                             f"devices, have {len(devices)}")
        self.devices = list(devices)
        self.shape = {a: int(shape.get(a, 1)) for a in AXIS_ORDER}
        self.rank = int(rank)
        self.groups = dict(groups or {})

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Rank ``rank``'s (default: this process's) index along each axis."""
        rest = self.rank if rank is None else int(rank)
        out = {}
        for axis in reversed(AXIS_ORDER):
            out[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]
        return {a: out[a] for a in AXIS_ORDER}

    def device(self, rank: Optional[int] = None) -> torch.device:
        return torch_device(self.devices[self.rank if rank is None else rank])

    def group(self, axis: str):
        """This rank's collective group along ``axis``, or None (a trivial
        axis, or an unbound mesh)."""
        return self.groups.get(axis)

    def bind(self, rank: int, groups: Optional[Dict[str, Any]] = None) -> "Mesh":
        """The same grid as seen by ``rank``, with its groups."""
        return Mesh(self.devices, self.shape, rank, groups)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items() if s > 1) or "1 rank"
        return f"Mesh({axes}, devices={self.devices}, rank={self.rank})"


def make_mesh(
    num_devices: Optional[int] = None,
    *,
    dp: int = 1,
    fsdp: int = -1,
    tp: int = 1,
    sp: int = 1,
    ep: int = 1,
    pp: int = 1,
    dcn: int = 1,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    spec = MeshSpec(dp=dp, fsdp=fsdp, tp=tp, sp=sp, ep=ep, pp=pp, dcn=dcn)
    devs = normalize_devices(devices)
    if num_devices is not None:
        devs = devs[:num_devices]
    return spec.build(devs)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    denom = math.prod(mesh.shape[a] for a in BATCH_AXES)
    if global_batch % denom != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {denom}")
    return global_batch // denom

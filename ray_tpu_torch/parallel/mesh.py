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

:meth:`Mesh.form_groups` forms the gang's sub-groups: one process group for
each line of ranks along each axis past 1 (the ranks that differ in that
coordinate alone), and one for each combination of :data:`GROUP_COMBOS`
with two axes or more past 1: the data axes together (:data:`BATCH_AXES`:
the batch's shards, over which MoE routing counts are summed), ``dcn`` and
``dp`` (an FSDP block's gradient), ``ep`` and ``tp`` (the experts' partial
sums), and the data axes with ``sp`` (:data:`LOSS_AXES`: the shards of the
batch and of the sequence, over which the Llama's loss and its gradients
are summed) and without ``fsdp``. A combination whose axes past 1 are
another's (``sp`` = 1) shares that one's group. A
group's rank is the rank's coordinate along its axes, row-major, so the
data group's rank is the index of the rank's batch shard.
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

# the axes an expert's work is split over (its experts, its hidden units)
EXPERT_AXES = ("ep", "tp")

# the axes a loss's terms are split over: the batch's shards and the
# sequence's (sp = 1: the data axes alone)
LOSS_AXES = BATCH_AXES + ("sp",)

# the axis combinations that get a group of their own beside the single axes:
# the data axes (a loss's sum, MoE routing counts), the data axes but fsdp
# (an FSDP block's gradient, summed over fsdp by its gather), the experts',
# and both data combinations with sp (a sequence-parallel loss and gradient)
GROUP_COMBOS = (BATCH_AXES, ("dcn", "dp"), EXPERT_AXES, LOSS_AXES, ("dcn", "dp", "sp"))

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

    def group(self, axis):
        """This rank's collective group along ``axis`` (an axis name, or a
        tuple of names for the ranks that differ along those axes alone),
        or None (axes of size 1, or an unbound mesh)."""
        if isinstance(axis, str):
            return self.groups.get(axis)
        live = tuple(a for a in AXIS_ORDER if a in axis and self.shape[a] > 1)
        if len(live) == 1:
            return self.groups.get(live[0])
        return self.groups.get(live) if live else None

    def axes_size(self, axes: Sequence[str]) -> int:
        """The product of the sizes of ``axes``."""
        return math.prod(self.shape[a] for a in axes)

    def axes_index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """Rank ``rank``'s row-major index over ``axes`` (in
        :data:`AXIS_ORDER`): its rank in the group of those axes."""
        c, i = self.coords(rank), 0
        for a in AXIS_ORDER:
            if a in axes:
                i = i * self.shape[a] + c[a]
        return i

    def lines(self, axes: Sequence[str]) -> List[List[int]]:
        """Every group of ranks that differ along ``axes`` alone, each in
        rank order (its members' :meth:`axes_index` order), the groups in
        the order of the coordinates they share."""
        out: Dict[tuple, List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            out.setdefault(tuple(c[a] for a in AXIS_ORDER if a not in axes), []).append(r)
        return [out[k] for k in sorted(out)]

    def form_groups(self, backend: str = "gloo", world_ranks: Optional[Sequence[int]] = None,
                    whole=None, name: str = "mesh") -> Optional["Mesh"]:
        """This mesh bound to this process's rank with its sub-groups: one
        :class:`~ray_tpu_torch.collective.GlooGroup` or ``NcclGroup``
        (``backend``) for each axis past 1, and one for each combination of
        :data:`GROUP_COMBOS` with two axes or more past 1 (a combination
        with one is that axis's group). Each group's rank is
        :meth:`axes_index` over its axes.

        Every process of the default process group calls it, with the same
        mesh and arguments and in the same order as its other calls that
        form groups: ``torch.distributed.new_group`` is collective over the
        whole default group, for the groups a process is not in too (NCCL
        hangs otherwise). ``world_ranks[r]`` is mesh rank r's rank in the
        default group (default: the identity); a process outside them
        forms nothing of its own and gets None. ``whole``, a group of this
        backend over all the mesh's ranks in mesh order, stands for a group
        whose line is the whole mesh instead of a new one."""
        import torch.distributed as dist

        from ..collective import GlooGroup, NcclGroup

        cls = {"gloo": GlooGroup, "nccl": NcclGroup}[backend]
        world = list(range(self.size)) if world_ranks is None else [int(r) for r in world_ranks]
        if len(world) != self.size:
            raise ValueError(f"{len(world)} world ranks for a mesh of {self.size}")
        me = dist.get_rank()
        groups: Dict[Any, Any] = {}
        keys = [(a,) for a in AXIS_ORDER if self.shape[a] > 1]
        for combo in GROUP_COMBOS:
            live = tuple(a for a in combo if self.shape[a] > 1)
            if len(live) > 1 and live not in keys:
                keys.append(live)
        for axes in keys:
            key = axes[0] if len(axes) == 1 else axes
            for line in self.lines(axes):
                if whole is not None and len(line) == self.size:
                    if me in world:
                        groups[key] = whole
                    continue
                members = [world[r] for r in line]
                pg = dist.new_group(ranks=members, backend=backend)
                if me in members:
                    label = ",".join(axes)
                    groups[key] = cls(len(members), members.index(me),
                                      f"{name}:{label}:{line[0]}", process_group=pg)
        if me not in world:
            return None
        return self.bind(world.index(me), groups)

    def require_groups(self, axes: Sequence[Any], what: str) -> None:
        """Raise ValueError unless this mesh is bound with a group for each
        entry of ``axes`` (an axis name or a tuple of them) whose size is
        past 1, of that size and with this rank's :meth:`axes_index` as its
        rank. ``what`` names the caller in the message."""
        for axes_ in axes:
            names = (axes_,) if isinstance(axes_, str) else tuple(axes_)
            n = self.axes_size(names)
            if n == 1:
                continue
            group = self.group(axes_)
            if group is None or group.world_size != n or group.rank != self.axes_index(names):
                raise ValueError(
                    f"{what} needs the mesh bound to its rank with a group of its {n} ranks "
                    f"along {names} (Mesh.form_groups, or train.collective.gang_mesh); got "
                    f"{group!r}")

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


def check_model_mesh(mesh: Mesh, what: str) -> None:
    """Refuse the axis a model over a mesh does not take, ``pp``, and a
    mesh not bound with the groups of its other axes.

    No model of the reference pipelines: its rule table has no entry for
    ``pp``, so a reference model over a mesh with ``pp`` past 1 repeats the
    same work on every ``pp`` rank (ROADMAP kept item 33). The pipeline
    itself is :func:`~ray_tpu_torch.parallel.pipeline.pipeline_apply`,
    which a caller drives over a ``pp`` group with its own stages."""
    if mesh.shape["pp"] > 1:
        raise NotImplementedError(
            f"{what} with pp={mesh.shape['pp']}: no model of the reference pipelines (its "
            "rule table has no entry for pp, so every pp rank would repeat the same work; "
            "ROADMAP kept item 33); parallel.pipeline_apply runs GPipe over a pp group")
    mesh.require_groups(("dcn", "dp", "fsdp", "ep", "sp", "tp") + GROUP_COMBOS, what)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    denom = math.prod(mesh.shape[a] for a in BATCH_AXES)
    if global_batch % denom != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {denom}")
    return global_batch // denom

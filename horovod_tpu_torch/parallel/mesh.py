"""Named mesh axes over the ``torch.distributed`` world (counterpart of
``horovod_tpu/parallel/mesh.py``).

The axes are the reference's: ``dp`` (data parallel, the reduction axis
of every gradient collective), ``pp``, ``tp`` and ``sp``.  Where the
reference reshapes devices, the port reshapes ranks: a ``(dp, pp, tp,
sp)`` mesh puts global rank ``((d*pp + p)*tp + t)*sp + s`` at ``(d, p,
t, s)``, dp outermost, so a dp group is strided by ``pp*tp*sp``.  Under
hierarchical mode the dp axis splits into the ``("dpc", "dpl")`` pair,
cross-major: ``d = c*dpl + l``.

``HOROVOD_MESH=dp:4,tp:2`` (or ``init(mesh=...)``) names the data mesh;
``init`` builds its process groups once (:func:`build_data_mesh`), and
every collective resolves its ``axis_name`` through :func:`resolve_hops`:
``None`` is the data mesh's dp axis (or the dpc/dpl pair) when a mesh is
named, else the flat world ``"hvd"``.  A :class:`Hop` is one axis as this
rank sees it (group, size, index) with the transfers the data plane
runs over it; a :class:`HopPair` is a ``(cross, local)`` pair with the
group of both (``flat``), which carries the pair's reduction when the
hierarchical decomposition is off.  The LM's data axes ``("dp", "sp")``
are such a pair (cross = dp, local = sp, the flat group dp-major), as
any two-axis name is on the reference (``horovod_tpu/ops/collectives.py:
306``); :class:`Place` is a rank's hops along the model's axes.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError

AXES = ("dp", "pp", "tp", "sp")

#: The gradient-reduction axis of a named data mesh, and the (cross,
#: local) sub-axis pair it splits into under hierarchical mode.
DATA_AXIS = "dp"
HIER_DATA_AXES = ("dpc", "dpl")
WORLD_AXIS = "hvd"
#: The LM's data axes: every gradient not sharded on one of them reduces
#: over both (``horovod_tpu/parallel/sharding.py:73-80``)
LM_DATA_AXES = ("dp", "sp")

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

# Payload bytes this thread's transfers sent inside a counting_sent()
# block (the eager plane's hvd_data_wire_bytes_total: what a response
# really put on the wire, compression, padding and scales included).
_sent = threading.local()


@contextlib.contextmanager
def counting_sent():
    """Count the payload bytes every transfer this thread makes sends
    (a member's own payload, once per transfer); yields a one-element
    list holding the running total."""
    prev = getattr(_sent, "box", None)
    box = [0]
    _sent.box = box
    try:
        yield box
    finally:
        _sent.box = prev
        if prev is not None:
            prev[0] += box[0]


def note_sent(t) -> None:
    """Add ``t``'s bytes to the open :func:`counting_sent` block (a
    transport calls it for each payload it sends)."""
    box = getattr(_sent, "box", None)
    if box is not None and t is not None:
        box[0] += t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# One axis as this rank sees it, and the transfers over it
# ---------------------------------------------------------------------------


class Hop:
    """One reduction axis as this rank sees it: its member ranks (global,
    in axis order), this rank's index among them, and its process group
    (``None``: the default world group).  Each method is one transfer
    over the axis; a hop of one rank moves nothing."""

    def __init__(self, ranks, index: int, group=None, name: str = ""):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = int(index)
        self.group = group
        self.name = name

    def __repr__(self):
        return f"Hop({self.name!r}, ranks={self.ranks}, index={self.index})"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the axis (``sum`` or ``max``)."""
        if self.size > 1:
            note_sent(t)
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def reduce_scatter(self, out, src, async_op: bool = False):
        """Sum ``src`` (``size`` equal segments) over the axis; segment
        ``index`` lands in ``out``.  Returns the work (``async_op``) or
        ``None``.  ``reduce_scatter_tensor`` and
        ``all_gather_into_tensor`` take a subgroup on gloo and NCCL alike
        (``tests/test_torch_data_plane.py``,
        ``test_four_cards_data_plane``); newer torch warns that both are
        deprecated."""
        if self.size == 1:
            out.copy_(src.reshape(out.shape))
            return None
        note_sent(src)
        return dist.reduce_scatter_tensor(out, src, group=self.group,
                                          async_op=async_op)

    def all_gather(self, out, src, async_op: bool = False):
        """Every member's ``src`` into ``out``, in axis order."""
        if self.size == 1:
            out.copy_(src.reshape(out.shape))
            return None
        note_sent(src)
        return dist.all_gather_into_tensor(out, src, group=self.group,
                                           async_op=async_op)

    def all_to_all(self, out, src) -> None:
        """Equal split along dim 0: chunk ``j`` goes to member ``j``."""
        if self.size == 1:
            out.copy_(src)
            return
        note_sent(src)
        dist.all_to_all_single(out, src, group=self.group)

    def broadcast(self, t: torch.Tensor, root: int) -> torch.Tensor:
        """Overwrite ``t`` with member ``root``'s (an axis index)."""
        if self.size > 1:
            note_sent(t)
            dist.broadcast(t, src=self.ranks[root], group=self.group)
        return t

    def exchange(self, t: torch.Tensor, peer: int) -> torch.Tensor:
        """Send ``t`` to member ``peer`` and return what it sent here."""
        if peer == self.index:
            return t.clone()
        recv = torch.empty_like(t)
        note_sent(t)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, self.ranks[peer], self.group),
            dist.P2POp(dist.irecv, recv, self.ranks[peer], self.group)])
        for w in works:
            w.wait()
        return recv

    def permute(self, t, pairs, like=None):
        """``lax.ppermute`` over the axis: ``pairs`` are ``(src, dst)``
        axis indices, no source or destination twice.  This member sends
        ``t`` to the ``dst`` of its ``(index, dst)`` pair and returns what
        the source of its ``(src, index)`` pair sent (a new tensor shaped
        like ``like``, default ``t``), or ``None`` where no pair ends
        here; ``t`` may be ``None`` where none starts here.  Every member
        calls it with the same pairs; only the pairs' members move data,
        in one ``batch_isend_irecv``.  The first call runs one all-reduce
        over the axis: NCCL builds a group's communicator at its first
        collective, and a batch of point-to-point operations may be that
        first only where every member takes part."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        for end in (0, 1):
            if len({p[end] for p in pairs}) < len(pairs):
                raise HorovodTpuError(f"permute pairs {pairs} repeat a "
                                      f"{('source', 'destination')[end]}")
        dst = next((d for s, d in pairs if s == self.index), None)
        src = next((s for s, d in pairs if d == self.index), None)
        if dst is not None and t is None:
            raise HorovodTpuError(f"permute: member {self.index} of "
                                  f"{self.name!r} sends but holds nothing")
        if src == self.index:
            return t.clone()
        if not pairs:
            return None
        ref = t if t is not None else like
        if self.size > 1 and not getattr(self, "_p2p_ready", False):
            dist.all_reduce(torch.zeros(1, device=ref.device),
                            group=self.group)
            self._p2p_ready = True
        ops, recv = [], None
        if dst is not None:
            note_sent(t)
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self.ranks[dst], self.group))
        if src is not None:
            recv = torch.empty_like(t if like is None else like)
            ops.append(dist.P2POp(dist.irecv, recv, self.ranks[src],
                                  self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return recv


class HopPair(NamedTuple):
    """A ``(cross, local)`` axis pair and ``flat``, the axis of both
    (its index cross-major: ``c * local.size + l``)."""
    cross: Hop
    local: Hop
    flat: Hop


def _axis_rows(shape, axes) -> np.ndarray:
    """The groups along ``axes`` (a tuple of dims of a C-order rank grid
    of ``shape``, earlier dims major), one row each, in the order every
    rank builds them."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    rest = [a for a in range(len(shape)) if a not in axes]
    return np.transpose(ranks, rest + list(axes)).reshape(
        -1, math.prod(shape[a] for a in axes))


def _axis_groups(shape, axes, me: int, name: str) -> Hop:
    """Every group of :func:`_axis_rows`, built in one order, and rank
    ``me``'s hop.  ``torch.distributed.new_group`` must be called by
    every rank for every group, its own or not."""
    mine = None
    for row in _axis_rows(shape, axes):
        group = dist.new_group(row.tolist()) if row.size > 1 else None
        if me in row:
            mine = Hop(row, row.tolist().index(me), group, name)
    return mine


class RankMesh:
    """A named mesh over the world's ranks (C order: the last axis
    fastest) with this rank's hop along every axis, and along each pair
    in ``pairs`` (``(cross, local)`` names) the flat hop of both."""

    def __init__(self, names, shape, pairs=()):
        world, rank = _basics.size(), _basics.rank()
        shape = tuple(int(s) for s in shape)
        if math.prod(shape) != world:
            raise HorovodTpuError(
                f"mesh {dict(zip(names, shape))} covers {math.prod(shape)} "
                f"ranks but the world has {world}; every rank must belong "
                "to exactly one mesh coordinate")
        self.axis_names = tuple(names)
        self.shape = shape
        self.coord = tuple(int(c) for c in np.unravel_index(rank, shape))
        self.hops = {n: _axis_groups(shape, (a,), rank, n)
                     for a, n in enumerate(names)}
        self.flat = {}
        for cross, local in pairs:
            axes = (names.index(cross), names.index(local))
            self.flat[(cross, local)] = _axis_groups(
                shape, axes, rank, f"{cross}*{local}")
        if world > 1:
            # gloo connects a new group's members eagerly: no rank may
            # go on (and perhaps exit) while another still connects
            dist.barrier()

    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def pair(self, cross: str, local: str) -> HopPair:
        if (cross, local) not in self.flat:
            raise HorovodTpuError(
                f"the mesh {self.sizes()} has no ({cross!r}, {local!r}) "
                f"pair; its pairs are {sorted(self.flat)}")
        return HopPair(self.hops[cross], self.hops[local],
                       self.flat[(cross, local)])

    def place(self) -> "Place":
        """This rank's hops along the model's axes (the mesh must have
        the ``dp``, ``pp``, ``tp`` and ``sp`` axes and the ``("dp",
        "sp")`` pair)."""
        missing = [a for a in AXES if a not in self.hops]
        if missing or LM_DATA_AXES not in self.flat:
            raise HorovodTpuError(
                f"the mesh {self.sizes()} has no {'/'.join(missing) or 'dp'}"
                " axis for the model: under the hierarchical split "
                "(HOROVOD_HIERARCHICAL_LOCAL_SIZE) the dp axis is the "
                "('dpc', 'dpl') pair, and the LM names 'dp' (as the "
                "reference's make_train_step does); build the model's "
                "mesh with make_mesh(dp, pp, tp, sp)")
        h = self.hops
        return Place(h["dp"], h["pp"], h["tp"], h["sp"],
                     self.pair(*LM_DATA_AXES))


class Place(NamedTuple):
    """A rank's hops along the model's axes: ``dp``, ``pp``, ``tp``,
    ``sp``, and ``data``, the ``("dp", "sp")`` pair the LM's gradients
    and loss reduce over.  ``RankMesh.place()`` gives it; an emulated
    world builds one from its own hops."""
    dp: Hop
    pp: Hop
    tp: Hop
    sp: Hop
    data: HopPair

    def coord(self) -> dict:
        """``{axis: (index, size)}`` of the four axes."""
        return {a: (h.index, h.size) for a, h in
                zip(AXES, (self.dp, self.pp, self.tp, self.sp))}


def make_mesh(dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1) -> RankMesh:
    """A ``(dp, pp, tp, sp)`` mesh over the world's ranks, with the
    ``("dp", "sp")`` pair."""
    return RankMesh(AXES, (dp, pp, tp, sp), pairs=(LM_DATA_AXES,))


def place_ranks(rank: int, dp: int = 1, pp: int = 1, tp: int = 1,
                sp: int = 1) -> dict:
    """The members of each hop of ``rank``'s place in ``make_mesh(dp, pp,
    tp, sp)``, by hop name (the four axes and ``"dp*sp"``, the ``("dp",
    "sp")`` pair's flat hop): the layout for a world that builds its
    hops another way, as ``chip_smoke.py``'s emulated ranks do."""
    shape = (dp, pp, tp, sp)
    dims = {a: (i,) for i, a in enumerate(AXES)}
    dims["*".join(LM_DATA_AXES)] = tuple(AXES.index(a)
                                         for a in LM_DATA_AXES)
    return {name: next(row.tolist() for row in _axis_rows(shape, d)
                       if rank in row)
            for name, d in dims.items()}


def hierarchical_mesh(local_size: int | None = None) -> RankMesh:
    """The two-level ``("cross", "local")`` mesh of the reference's
    LOCAL/CROSS split: ``local_size`` consecutive ranks per local group
    (default: the launcher's ``HOROVOD_LOCAL_SIZE``).  ``pair("cross",
    "local")`` is the pair the hierarchical collectives take."""
    world = _basics.size()
    if local_size is None:
        local_size = _basics.local_size()
    if local_size < 1 or world % local_size:
        raise HorovodTpuError(
            f"world size {world} not divisible by local size {local_size}")
    return RankMesh(("cross", "local"), (world // local_size, local_size),
                    pairs=(("cross", "local"),))


def hier_admissibility(size: int, rank: int, local_size: int,
                       cross_size: int, cross_rank: int, local_rank: int):
    """``(local, warn)``: the local group size when a (cross, local)
    split of the world exists, else ``(0, reason or None)``
    (``xla_exec.py:_hier_admissibility``).  ``HOROVOD_HIERARCHICAL_
    LOCAL_SIZE`` overrides the launcher's local size; otherwise ranks
    must be host-contiguous and every host the same size, so rank ``r``
    sits at ``(r // local, r % local)``.  The one rule for the eager
    plane's groups and local SGD's topology."""
    if size <= 1:
        return 0, None
    forced = int(_config.get("hierarchical_local_size"))
    local = forced if forced else local_size
    if local <= 1 or size % local:
        if forced:
            return 0, (
                f"HOROVOD_HIERARCHICAL_LOCAL_SIZE={forced} does not give "
                f"a 2-level split of world size {size}; using flat "
                "collectives")
        return 0, None
    if not forced:
        if local_size * cross_size != size or \
                rank != cross_rank * local_size + local_rank:
            return 0, ("hierarchical collectives requested but ranks are "
                       "not host-contiguous/homogeneous; falling back to "
                       "flat")
    return local, None


def sequence_groups(dp: int, sp: int):
    """This rank's sequence group and its place ``(d, s)`` in a ``(dp,
    sp)`` layout of the world: the sp axis of ``make_mesh(dp=dp,
    sp=sp)``, global rank ``d * sp + s``.  The caller passes the group to
    ``Transformer.forward``, ``lm_train_step`` and the attention
    functions, as the JAX caller passes its mesh."""
    world = dist.get_world_size()
    if dp < 1 or sp < 1 or dp * sp != world:
        raise HorovodTpuError(
            f"dp * sp = {dp} * {sp} != world size {world}")
    m = make_mesh(dp=dp, sp=sp)
    return m.hops["sp"].group, (m.coord[0], m.coord[3])


def group_place(group) -> tuple[int, int]:
    """``(size, index)`` of this rank in ``group`` (``None``: a group of
    this rank alone)."""
    if group is None:
        return 1, 0
    idx = dist.get_rank(group)
    if idx < 0:
        raise HorovodTpuError("this rank is not a member of the group")
    return dist.get_world_size(group), idx


# ---------------------------------------------------------------------------
# Pure functions of the reference module
# ---------------------------------------------------------------------------


def _prime_factors(n: int) -> list[int]:
    """Prime factorization, descending (largest factors first)."""
    out, f = [], 2
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def factor_devices(n: int, want_pp: bool = False) -> dict[str, int]:
    """Factor a device count into parallelism degrees, greedy over the
    prime factorization: tp takes the largest prime factor, sp the next,
    pp (when requested) a 2-way cut, and dp the product of the rest."""
    if n < 1:
        raise HorovodTpuError(f"device count must be >= 1, got {n}")
    factors = {"dp": 1, "pp": 1, "tp": 1, "sp": 1}
    primes = _prime_factors(n)
    for axis in ("tp", "sp", "pp") if want_pp else ("tp", "sp"):
        for i, f in enumerate(primes):
            if axis == "pp" and f != 2:
                continue
            factors[axis] = f
            primes.pop(i)
            break
    for f in primes:
        factors["dp"] *= f
    return factors


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """Parse a ``HOROVOD_MESH`` spec ('dp:4,tp:2') into the full axis
    dict {'dp': 4, 'pp': 1, 'tp': 2, 'sp': 1}.  A repeated or unknown
    axis or a non-positive size is an error (a typo silently becoming a
    flat world would average tp-sharded values)."""
    axes = {a: 1 for a in AXES}
    seen: set[str] = set()
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise HorovodTpuError(
                f"malformed mesh spec entry {part!r} (want axis:size, "
                f"e.g. 'dp:4,tp:2'); full spec: {spec!r}")
        name, _, size = part.partition(":")
        name = name.strip()
        if name not in AXES:
            raise HorovodTpuError(
                f"unknown mesh axis {name!r} in {spec!r}; axes are "
                f"{'/'.join(AXES)}")
        if name in seen:
            raise HorovodTpuError(f"mesh axis {name!r} repeated in {spec!r}")
        seen.add(name)
        try:
            val = int(size.strip())
        except ValueError:
            raise HorovodTpuError(
                f"mesh axis {name!r} has non-integer size {size!r} in "
                f"{spec!r}") from None
        if val < 1:
            raise HorovodTpuError(
                f"mesh axis {name!r} size must be >= 1, got {val}")
        axes[name] = val
    if not seen:
        raise HorovodTpuError(
            f"empty mesh spec {spec!r}: unset HOROVOD_MESH for the flat "
            "world instead")
    return axes


def canonical_spec(axes: dict[str, int]) -> str:
    """The one spelling of an axis dict: AXES order, size-1 axes elided,
    dp always present."""
    return ",".join(f"{a}:{int(axes.get(a, 1))}" for a in AXES
                    if a == "dp" or int(axes.get(a, 1)) > 1)


def mesh_signature(axes: dict[str, int]) -> int:
    """One packed int: ``dp<<48 | pp<<32 | tp<<16 | sp`` (each extent
    capped at 16 bits)."""
    vals = [min(int(axes.get(a, 1)), 0xFFFF) for a in AXES]
    return (vals[0] << 48) | (vals[1] << 32) | (vals[2] << 16) | vals[3]


def _hier_local_split(dp: int) -> int:
    """The dp axis's local extent under hierarchical mode:
    ``HOROVOD_HIERARCHICAL_LOCAL_SIZE`` when ``1 < L < dp`` and ``L``
    divides dp, else 0 (no split).  The knob's default 0 means no split,
    and nothing here reads ``HOROVOD_LOCAL_SIZE``: a hierarchical knob
    alone does not make a reduction two-level."""
    if not (_config.get("hierarchical_allreduce")
            or _config.get("hierarchical_allgather")):
        return 0
    local = int(_config.get("hierarchical_local_size"))
    if 1 < local < dp and dp % local == 0:
        return local
    return 0


def build_data_mesh(axes: dict[str, int]) -> RankMesh:
    """The named data mesh of ``axes`` over the world: dp outermost, with
    the ``("dp", "sp")`` pair; under hierarchical mode dp becomes the
    ``("dpc", "dpl")`` pair (cross major), the pair's flat hop is the dp
    group, and there is no ``"dp"`` axis to pair with sp (the
    reference's mesh has none either, ``horovod_tpu/parallel/mesh.py:
    216-219``)."""
    dp, pp, tp, sp = (int(axes.get(a, 1)) for a in AXES)
    local = _hier_local_split(dp)
    if local:
        return RankMesh(HIER_DATA_AXES + AXES[1:],
                        (dp // local, local, pp, tp, sp),
                        pairs=(HIER_DATA_AXES,))
    return make_mesh(dp, pp, tp, sp)


def active_spec() -> dict[str, int] | None:
    """The data mesh's axis sizes, or ``None`` in the flat world: the
    mesh :func:`init` built wins, else the ``HOROVOD_MESH`` knob."""
    axes = _basics._state.data_axes
    if axes:
        return dict(axes)
    spec = str(_config.get("mesh") or "").strip()
    return parse_mesh_spec(spec) if spec else None


def data_axis(axes: dict[str, int] | None = None):
    """The default gradient-reduction axis: ``'dp'`` (or the ``('dpc',
    'dpl')`` pair) when a data mesh is named, else the flat world axis
    ``'hvd'`` -- whatever the hierarchical knobs say."""
    if axes is None:
        axes = active_spec()
    if not axes:
        return WORLD_AXIS
    if all(a in axes for a in HIER_DATA_AXES):
        return HIER_DATA_AXES
    if _hier_local_split(int(axes.get(DATA_AXIS, 1))):
        return HIER_DATA_AXES
    return DATA_AXIS


def resolve_axis(axis_name=None):
    """An explicit ``axis_name`` wins untouched; ``None`` is
    :func:`data_axis`."""
    return axis_name if axis_name is not None else data_axis()


def data_parallel_size(axes: dict[str, int] | None = None) -> int | None:
    """The dp extent of the data mesh (dpc*dpl under the split), or
    ``None`` when no mesh is named."""
    if axes is None:
        axes = active_spec()
    if not axes:
        return None
    if all(a in axes for a in HIER_DATA_AXES):
        return int(axes[HIER_DATA_AXES[0]]) * int(axes[HIER_DATA_AXES[1]])
    return int(axes.get(DATA_AXIS, 1))


def model_parallel_size(axes: dict[str, int] | None = None) -> int:
    """Product of the non-dp extents (tp*pp*sp), 1 without a mesh."""
    if axes is None:
        axes = active_spec()
    if not axes:
        return 1
    return math.prod(int(v) for v in axes.values()) // (
        data_parallel_size(axes) or 1)


# ---------------------------------------------------------------------------
# The resolver every collective calls
# ---------------------------------------------------------------------------


def _world_hop() -> Hop:
    return Hop(range(_basics.size()), _basics.rank(), None, WORLD_AXIS)


def _named_hop(name: str) -> Hop:
    if name == WORLD_AXIS:
        return _world_hop()
    mesh = _basics._state.data_mesh
    if mesh is None or name not in mesh.hops:
        have = sorted(mesh.hops) if mesh is not None else []
        raise HorovodTpuError(
            f"axis {name!r} has no process group: the data mesh built at "
            f"init() has axes {have} (HOROVOD_MESH / init(mesh=...) name "
            "the mesh before init)")
    return mesh.hops[name]


def resolve_hops(axis_name=None):
    """``axis_name`` as the hops it spans: a :class:`Hop` for one axis
    (``None`` through :func:`resolve_axis`, a name of the data mesh, or
    ``"hvd"``, the world), a :class:`HopPair` for a ``(cross, local)``
    pair.  Hops and pairs built elsewhere pass through."""
    ax = resolve_axis(axis_name)
    if isinstance(ax, (Hop, HopPair)):
        return ax
    if isinstance(ax, str):
        return _named_hop(ax)
    if isinstance(ax, (tuple, list)) and len(ax) == 2 \
            and all(isinstance(a, str) for a in ax):
        mesh = _basics._state.data_mesh
        if mesh is None or tuple(ax) not in mesh.flat:
            have = sorted(mesh.flat) if mesh is not None else []
            raise HorovodTpuError(
                f"the axis pair {tuple(ax)} has no process groups: the "
                f"data mesh built at init() has the pairs {have} (the "
                "('dp', 'sp') pair of HOROVOD_MESH, or its ('dpc', "
                "'dpl') split under HOROVOD_HIERARCHICAL_ALLREDUCE and "
                "_LOCAL_SIZE, which has no 'dp' axis); pass a HopPair "
                "(make_mesh(...).pair('dp', 'sp'), "
                "hierarchical_mesh().pair('cross', 'local')) instead")
        return mesh.pair(*ax)
    raise HorovodTpuError(f"unknown axis_name {axis_name!r}")


def two_level(hops):
    """``hops`` when it is a pair and ``HOROVOD_HIERARCHICAL_ALLREDUCE``
    is on (the local/cross decomposition), else ``None``: without the
    knob a pair reduces flat over both axes."""
    if isinstance(hops, HopPair) and _config.get("hierarchical_allreduce"):
        return hops
    return None


def flat_hop(axis_name=None) -> Hop:
    """The one hop that carries ``axis_name``'s flat reduction (a pair's
    ``flat``)."""
    h = resolve_hops(axis_name)
    return h.flat if isinstance(h, HopPair) else h


def axis_total(axis_name=None) -> int:
    """Ranks ``axis_name`` spans (a pair: cross * local)."""
    return flat_hop(axis_name).size


def shard_index(axis_name=None) -> int:
    """This rank's flat index over ``axis_name``: cross-major for a pair,
    the segment :func:`collectives._scatter_flat_buffer` gives it."""
    return flat_hop(axis_name).index

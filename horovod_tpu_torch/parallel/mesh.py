"""The rank layout of the reference's ``make_mesh``
(``horovod_tpu/parallel/mesh.py:47-56``) for the sequence axis.

The reference reshapes the devices to ``(dp, pp, tp, sp)``; with ``pp =
tp = 1`` global rank ``r`` sits at ``(d, s) = (r // sp, r % sp)``.
:func:`sequence_groups` builds the ``sp`` process groups of that layout;
the caller passes this rank's group to ``Transformer.forward``,
``lm_train_step`` and the attention functions, as the JAX caller passes
its mesh.  Gradients still reduce over the whole world
(``DistributedOptimizer``): every non-MoE gradient of the reference
reduces over ``("dp", "sp")``, which at world = dp x sp is the world.
Named mesh axes (``HOROVOD_MESH``) stay in ROADMAP.md Queue A item 9.
"""

from __future__ import annotations

import torch.distributed as dist

from horovod_tpu_torch.common.types import HorovodTpuError


def sequence_groups(dp: int, sp: int):
    """This rank's sequence group and its place ``(d, s)`` in a ``(dp,
    sp)`` layout of the world.  Every rank builds every group, in the
    same order, as ``torch.distributed.new_group`` requires."""
    world, r = dist.get_world_size(), dist.get_rank()
    if dp < 1 or sp < 1 or dp * sp != world:
        raise HorovodTpuError(
            f"dp * sp = {dp} * {sp} != world size {world}")
    mine = None
    for d in range(dp):
        group = dist.new_group(list(range(d * sp, (d + 1) * sp)))
        if d == r // sp:
            mine = group
    return mine, (r // sp, r % sp)


def group_place(group) -> tuple[int, int]:
    """``(size, index)`` of this rank in ``group`` (``None``: a group of
    this rank alone)."""
    if group is None:
        return 1, 0
    idx = dist.get_rank(group)
    if idx < 0:
        raise HorovodTpuError("this rank is not a member of the group")
    return dist.get_world_size(group), idx

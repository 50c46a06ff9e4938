"""Tensor-parallel collectives and partition specs: the counterpart of
``horovod_tpu/parallel/sharding.py``.

The Megatron pair of collectives over the tp hop, each with an
asymmetric backward:

- :func:`copy_to_tp` ("f"): identity forward, all-reduce sum backward.
  It feeds a replicated activation into column-parallel weights, and
  its backward sums each shard's input-gradient contribution, so the
  replicated parameters upstream see the whole gradient on every rank.
- :func:`reduce_from_tp` ("g"): all-reduce sum forward, identity
  backward.  It combines the row-parallel partial outputs; its backward
  passes the (already replicated) cotangent on once.

A hop of one rank (or ``None``) makes both the identity.  :class:`P` is
the port's ``PartitionSpec``: one mesh axis name (or a tuple of names,
or ``None``) per dimension of a parameter.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.parallel.mesh import LM_DATA_AXES


def _all_reduce(x: torch.Tensor, hop) -> torch.Tensor:
    out = x.contiguous().clone()
    hop.all_reduce(out)
    return out


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hop):
        ctx.hop = hop
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.hop), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hop):
        return _all_reduce(x, hop)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, hop) -> torch.Tensor:
    """Megatron "f": identity forward, sum over ``hop`` backward."""
    if hop is None or hop.size == 1:
        return x
    return _CopyToTp.apply(x, hop)


def reduce_from_tp(x: torch.Tensor, hop) -> torch.Tensor:
    """Megatron "g": sum over ``hop`` forward, identity backward."""
    if hop is None or hop.size == 1:
        return x
    return _ReduceFromTp.apply(x, hop)


class P(tuple):
    """A partition spec: per dimension, the mesh axis it is split over
    (a name, a tuple of names, or ``None``); trailing dimensions may be
    left out.  ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over (flattened)."""
    axes: list = []
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.extend(entry)
        else:
            axes.append(entry)
    return tuple(axes)


def grad_reduce_axes(spec, data_axes=LM_DATA_AXES) -> tuple:
    """The data axes a gradient is summed over: all of them but those
    the parameter is sharded on (a dp-sharded expert's gradient is its
    own shard's)."""
    sharded = set(spec_axes(spec))
    return tuple(a for a in data_axes if a not in sharded)


def tree_map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a nested dict ``tree`` and the dict of
    specs of the same structure (a :class:`P` is a leaf)."""
    if isinstance(specs, P):
        return fn(tree, specs)
    return {k: tree_map_with_specs(fn, tree[k], specs[k]) for k in tree}

"""The port's named data mesh (``horovod_tpu_torch.parallel.mesh``,
``init(mesh=...)``, ``HOROVOD_MESH``) against the JAX package, on the CPU.

1. The pure functions of ``tests/test_mesh.py:78-218`` at every case, each
   against the JAX package's: ``factor_devices``, ``parse_mesh_spec`` (every
   error, same messages), ``canonical_spec``, ``mesh_signature``, the axis
   resolution with and without the knobs.
2. ``init(mesh=...)``: a spec string, a dict, a ``DeviceMesh`` and the
   port's own mesh canonicalize through the knob; the reference's
   refusals (``tests/test_mesh.py:420-470``).
3. On spawned gloo worlds (``_torch_collectives_worker.mesh_main``): a
   flat world of 2, and a world of 4 under ``HOROVOD_MESH=dp:2,tp:2`` given
   to ``init`` as a torch ``DeviceMesh``:
   - the dp-axis parity grid (``tests/test_mesh.py:291-316``): stages 0-3
     x mono/overlap x none/int8, two steps on fixed integer gradients, bit
     for bit between every rank of the mesh (both tp columns) and the flat
     world of 2, and against the JAX package's flat world of 2 (dense bit
     for bit; int8 within one shared scale per step);
   - the groups (dp {0, 2} and {1, 3}), the default axis, every entry
     reducing over dp only, and ``build_data_mesh``'s layouts (with the
     hierarchical split) against the JAX package's;
   - re-initialized under ``dp:2,sp:2`` (knob, spec, dict, built): the
     sp groups and the ``("dp", "sp")`` pair; ROADMAP Queue C's repairs:
     the broadcast helpers raising under ``dp:2,tp:2`` and ``dp:2,sp:2``
     with weights seeded differently per rank, and ``alltoall`` raising
     over the ``(dpc, dpl)`` pair of ``dp:4``.
"""

import math
import os
import sys

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.optim import distributed as JD
from horovod_tpu.parallel import mesh as JM

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics as B
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import free_port
from horovod_tpu_torch.parallel import mesh as M

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import (MESH_GRID, MESH_LR,  # noqa: E402
                                       MESH_STEPS, SEQ_MESH_FORMS, spawn)
from test_torch_collectives import _f  # noqa: E402

KNOBS = ("HOROVOD_MESH", "HOROVOD_HIERARCHICAL_ALLREDUCE",
         "HOROVOD_HIERARCHICAL_ALLGATHER", "HOROVOD_HIERARCHICAL_LOCAL_SIZE")


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for k in KNOBS + ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# 1. The pure functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,want", [
    (1, {"dp": 1, "pp": 1, "tp": 1, "sp": 1}),
    (2, {"dp": 1, "pp": 1, "tp": 2, "sp": 1}),
    (4, {"dp": 1, "pp": 1, "tp": 2, "sp": 2}),
    (8, {"dp": 2, "pp": 1, "tp": 2, "sp": 2}),
    (9, {"dp": 1, "pp": 1, "tp": 3, "sp": 3}),
    (12, {"dp": 2, "pp": 1, "tp": 3, "sp": 2}),
])
def test_factor_devices(n, want):
    assert M.factor_devices(n) == JM.factor_devices(n) == want


def test_factor_devices_want_pp():
    assert M.factor_devices(8, want_pp=True) == \
        JM.factor_devices(8, want_pp=True) == \
        {"dp": 1, "pp": 2, "tp": 2, "sp": 2}
    assert M.factor_devices(9, want_pp=True) == \
        {"dp": 1, "pp": 1, "tp": 3, "sp": 3}


@pytest.mark.parametrize("n", list(range(1, 33)) + [48, 60, 96])
def test_factor_devices_product_invariant(n):
    for pp in (False, True):
        f = M.factor_devices(n, want_pp=pp)
        assert f == JM.factor_devices(n, want_pp=pp)
        assert f["dp"] * f["pp"] * f["tp"] * f["sp"] == n


def test_factor_devices_rejects_zero():
    with pytest.raises(HorovodTpuError, match="device count"):
        M.factor_devices(0)


def test_parse_mesh_spec():
    for spec, want in (("dp:4,tp:2", {"dp": 4, "pp": 1, "tp": 2, "sp": 1}),
                       (" tp:2 , dp:4 ", {"dp": 4, "pp": 1, "tp": 2,
                                          "sp": 1}),
                       ("sp:8", {"dp": 1, "pp": 1, "tp": 1, "sp": 8})):
        assert M.parse_mesh_spec(spec) == JM.parse_mesh_spec(spec) == want


@pytest.mark.parametrize("bad,msg", [
    ("ep:4", "unknown mesh axis"),
    ("dp:2,dp:4", "repeated"),
    ("dp:0", "must be >= 1"),
    ("dp:x", "non-integer"),
    ("dp=4", "malformed"),
    ("", "empty mesh spec"),
    (",", "empty mesh spec"),
])
def test_parse_mesh_spec_rejects(bad, msg):
    with pytest.raises(HorovodTpuError, match=msg) as got:
        M.parse_mesh_spec(bad)
    with pytest.raises(jhvd.HorovodTpuError) as want:
        JM.parse_mesh_spec(bad)
    assert str(got.value) == str(want.value)


def test_canonical_spec():
    for axes, want in (({"dp": 4, "tp": 2}, "dp:4,tp:2"),
                       ({"tp": 2}, "dp:1,tp:2"),
                       ({"sp": 2, "dp": 8, "pp": 1}, "dp:8,sp:2")):
        assert M.canonical_spec(axes) == JM.canonical_spec(axes) == want
    assert M.canonical_spec(M.parse_mesh_spec("tp:2,dp:4")) == "dp:4,tp:2"


def test_mesh_signature_packing():
    sig = M.mesh_signature({"dp": 4, "tp": 2})
    assert sig == JM.mesh_signature({"dp": 4, "tp": 2}) == \
        (4 << 48) | (1 << 32) | (2 << 16) | 1
    assert sig != M.mesh_signature({"dp": 2, "tp": 4})


def test_resolve_axis_flat_world():
    for mod in (M, JM):
        assert mod.resolve_axis() == "hvd"
        assert mod.resolve_axis("custom") == "custom"
        assert mod.data_parallel_size() is None
        assert mod.model_parallel_size() == 1


def test_resolve_axis_with_mesh_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_MESH", "dp:4,tp:2")
    for mod in (M, JM):
        assert mod.resolve_axis() == "dp"
        assert mod.resolve_axis("hvd") == "hvd"  # explicit always wins
        assert mod.data_parallel_size() == 4
        assert mod.model_parallel_size() == 2


def test_resolve_axis_hierarchical_pair(monkeypatch):
    monkeypatch.setenv("HOROVOD_MESH", "dp:4,tp:2")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_LOCAL_SIZE", "2")
    for mod in (M, JM):
        assert mod.resolve_axis() == ("dpc", "dpl")
        assert mod.data_parallel_size() == 4


@pytest.mark.parametrize("local,dp,want", [
    (0, 4, 0), (2, 4, 2), (3, 4, 0), (4, 4, 0), (1, 4, 0), (2, 6, 2),
    (4, 8, 4)])
def test_hier_local_split(monkeypatch, local, dp, want):
    """The dp axis splits only when a hierarchical knob is on and ``1 <
    L < dp``, ``L | dp``; ``HOROVOD_LOCAL_SIZE`` plays no part, and the
    knob with no mesh leaves the flat world."""
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_LOCAL_SIZE", str(local))
    monkeypatch.setenv("HOROVOD_LOCAL_SIZE", "2")
    assert M._hier_local_split(dp) == JM._hier_local_split(dp) == 0
    for knob in ("HOROVOD_HIERARCHICAL_ALLREDUCE",
                 "HOROVOD_HIERARCHICAL_ALLGATHER"):
        monkeypatch.setenv(knob, "1")
        assert M._hier_local_split(dp) == JM._hier_local_split(dp) == want
        assert M.resolve_axis() == JM.resolve_axis() == "hvd"
        monkeypatch.delenv(knob)


# ---------------------------------------------------------------------------
# 2. init(mesh=...) at a world of one
# ---------------------------------------------------------------------------


def _device_mesh():
    """A torch ``DeviceMesh`` ("dp", "tp") over a world of one."""
    from torch.distributed.device_mesh import DeviceMesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    return DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int),
                      mesh_dim_names=("dp", "tp"))


@pytest.mark.parametrize("form", ["spec", "dict", "device_mesh",
                                  "rank_mesh"])
def test_init_mesh_builds_data_mesh(form):
    arg = {"spec": "tp:1,dp:1", "dict": {"dp": 1},
           "device_mesh": None, "rank_mesh": None}[form]
    if form == "device_mesh":
        arg = _device_mesh()
    if form == "rank_mesh":
        hvd.init(device="cpu")
        arg = hvd.make_mesh(dp=1)
        hvd.shutdown()
    hvd.init(device="cpu", mesh=arg)
    try:
        assert _config.get("mesh") == "dp:1"
        m = hvd.data_mesh()
        assert m.axis_names == ("dp", "pp", "tp", "sp")
        assert m.shape == (1, 1, 1, 1)
        assert hvd.data_parallel_size() == 1
        hop = M.resolve_hops()
        assert (hop.name, hop.ranks, hop.index) == ("dp", (0,), 0)
        x = torch.arange(4.0)
        assert torch.equal(hvd.collectives.allreduce(x), x)
    finally:
        hvd.shutdown()
        os.environ.pop("HOROVOD_MESH", None)
    assert B._state.data_mesh is None and B._state.data_axes is None


def test_init_mesh_rejections(monkeypatch):
    monkeypatch.setenv("HOROVOD_MESH", "dp:8")
    with pytest.raises(HorovodTpuError, match="disagrees"):
        B._apply_mesh_arg("dp:4,tp:2")
    monkeypatch.setenv("HOROVOD_MESH", "")

    class FakeMesh:
        def __init__(self, names):
            self.mesh_dim_names, self.shape = names, (2,)

    with pytest.raises(HorovodTpuError, match="no 'dp' axis"):
        B._apply_mesh_arg(FakeMesh(("tp",)))
    with pytest.raises(HorovodTpuError, match="axis names"):
        B._apply_mesh_arg(FakeMesh(("rows",)))
    with pytest.raises(HorovodTpuError, match="wants a spec"):
        B._apply_mesh_arg(42)
    # a spec that does not cover the world refuses before any group
    with pytest.raises(HorovodTpuError, match="covers 2 ranks"):
        hvd.init(device="cpu", mesh="dp:2")
    assert not hvd.is_initialized()


def test_init_flat_world_default():
    hvd.init(device="cpu")
    try:
        assert hvd.data_mesh() is None
        assert hvd.data_parallel_size() == 1
        assert M.resolve_hops().name == "hvd"
        with pytest.raises(HorovodTpuError, match="no process group"):
            M.resolve_hops("tp")
        # the ("dp", "sp") pair is the data mesh's: the flat world has none
        with pytest.raises(HorovodTpuError,
                           match=r"\('dp', 'sp'\) has no process groups"):
            M.resolve_hops(("dp", "sp"))
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# 3. Worlds of 2 (flat) and 4 (dp:2,tp:2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    return (spawn(2, mode="mesh", timeout=200),
            spawn(4, mode="mesh", timeout=200,
                  env_extra={"HOROVOD_MESH": "dp:2,tp:2"}))


@pytest.fixture(scope="module")
def jax_grid():
    """The JAX package's flat world of 2 over the parity grid
    (``tests/test_mesh.py:_trained_params`` on two devices)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    params = {"w": jnp.arange(-10.0, 11.0, dtype=jnp.float32),
              "b": jnp.ones((3, 3), jnp.float32)}
    keys = sorted(params)

    def body(t):
        t = t[0, 0]
        outs = []
        for stage, overlap, comp in MESH_GRID:
            opt = jhvd.DistributedOptimizer(
                optax.sgd(MESH_LR), axis_name="hvd", zero_stage=stage,
                overlap=overlap, compression=jhvd.Compression.lookup(comp))
            if stage == 3:
                zp = JD.zero3_shard_params(params, axis_name="hvd")
                state = opt.init(zp)
                for _ in range(MESH_STEPS):
                    def loss(z):
                        full = JD.zero3_full_params(z, axis_name="hvd")
                        return sum((i + 1.0) * (t - 3.0) * jnp.sum(full[k])
                                   for i, k in enumerate(keys))
                    upd, state = opt.update(jax.grad(loss)(zp), state, zp)
                    zp = optax.apply_updates(zp, upd)
                p = JD.zero3_full_params(zp, axis_name="hvd")
            else:
                p, state = dict(params), opt.init(params)
                for _ in range(MESH_STEPS):
                    g = {k: jnp.full(p[k].shape, (i + 1.0) * (t - 3.0))
                         for i, k in enumerate(keys)}
                    upd, state = opt.update(g, state, p)
                    p = optax.apply_updates(p, upd)
            outs.append((p["b"][None], p["w"][None]))
        return tuple(outs)

    res = jax.jit(shard_map(body, mesh=mesh, check_vma=False,
                            in_specs=P("hvd"), out_specs=P("hvd")))(
        jnp.arange(2, dtype=jnp.float32).reshape(2, 1))
    return {cfg: {"b": np.asarray(b), "w": np.asarray(w)}
            for cfg, (b, w) in zip(MESH_GRID, res)}


@pytest.mark.parametrize("comp", ["none", "int8"])
@pytest.mark.parametrize("overlap", [False, True], ids=["mono", "overlap"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_dp_axis_parity_bit_exact(worlds, jax_grid, stage, overlap, comp):
    """The same training over the dp axis of dp:2,tp:2 gives, on every
    rank of both tp columns, bit for bit the weights of the flat world of
    2: the dp groups see exactly the ranks the flat world sees and tp
    never enters a reduction."""
    flat, mesh = worlds
    key = f"{stage}_{overlap}_{comp}"
    want = jax_grid[(stage, overlap, comp)]
    for k in ("b", "w"):
        base = _f(flat[0]["grid"][key][k])
        for r, o in enumerate(flat + mesh):
            np.testing.assert_array_equal(_f(o["grid"][key][k]), base,
                                          err_msg=f"{key} {k} rank {r}")
        for row in want[k]:         # the JAX package's dp replicas
            if comp == "none":
                np.testing.assert_array_equal(base, row)
            else:
                # one shared int8 scale (block absmax 6 over qmax 63)
                # per step, where XLA's x/c -> x*(1/c) rewrite may move it
                np.testing.assert_allclose(
                    base, row, rtol=0,
                    atol=MESH_STEPS * MESH_LR * 6 / 63)


def test_mesh_groups_and_default_axis(worlds):
    _, mesh = worlds
    for r, o in enumerate(mesh):
        d, t = divmod(r, 2)
        assert o["hops"]["dp"] == [[t, 2 + t], d]
        assert o["hops"]["tp"] == [[2 * d, 2 * d + 1], t]
        assert o["hops"]["hvd"] == [[0, 1, 2, 3], r]
        assert o["default"] == "dp"
        assert o["sizes"] == [2, 2, 2]


def test_entries_reduce_over_dp_only(worlds):
    """With no axis argument every entry runs over the rank's dp group:
    the tp columns keep their own results."""
    _, mesh = worlds
    for r, o in enumerate(mesh):
        d, t = divmod(r, 2)
        col = [t, 2 + t]                      # this rank's dp group
        assert o["sum"] == [1.0, float(sum(col))]
        assert o["avg_world"] == [0.5, 1.5]
        assert o["bcast"] == [1.0, float(col[1])]
        assert o["gather"] == [[0.0, float(col[0])], [1.0, float(col[1])]]
        seg = np.arange(4.0).reshape(2, 2)[d] * sum(c + 1 for c in col)
        assert o["rs"] == seg.tolist()
        a2a = np.concatenate([np.arange(2.0) + 2 * d + 10 * c for c in col])
        assert o["a2a"] == a2a.tolist()


@pytest.mark.parametrize("form", SEQ_MESH_FORMS)
def test_data_mesh_with_sequence_axis(worlds, form):
    """``dp:2,sp:2`` named by the knob, a spec, a dict, or built from the
    axes after a flat init: rank ``2d + s`` has the dp group ``{s, 2 +
    s}``, the sp group ``{2d, 2d + 1}``, and the ``("dp", "sp")`` pair
    (cross = dp, local = sp) over all four ranks, dp-major, which
    ``resolve_hops(("dp", "sp"))`` returns and the LM's place reduces
    over.  The default axis stays dp and sp counts as model-parallel (the
    reference's ``model_parallel_size``)."""
    _, mesh = worlds
    for r, o in enumerate(mesh):
        got = o["sequence_mesh"][form]
        d, s_ = divmod(r, 2)
        assert got["axes"] == [list(M.AXES), [2, 1, 1, 2]]
        assert got["dp"] == [[s_, 2 + s_], d]
        assert got["sp"] == [[2 * d, 2 * d + 1], s_]
        assert got["pair"] == [[0, 1, 2, 3], r, [s_, 2 + s_],
                               [2 * d, 2 * d + 1]]
        assert got["place_data"] == [0, 1, 2, 3]
        if form != "build":
            assert got["resolved"] == [[0, 1, 2, 3], r]
            assert got["default"] == "dp"
            assert got["mp"] == JM.model_parallel_size(
                {"dp": 2, "pp": 1, "tp": 1, "sp": 2}) == 2


def test_lm_without_mesh_refuses_a_partial_average(worlds):
    """Under ``HOROVOD_MESH=dp:2,sp:2`` an LM without a mesh is whole on
    every rank: ``lm_train_step`` refuses an optimizer that averages over
    the default dp axis (2 of the 4 ranks: each sp rank would apply its
    own chunk's gradient and the replicas drift apart with no error) or
    not at all, naming the data-mesh recipe; over ``("dp", "sp")`` it
    trains, the global loss equal on every rank."""
    _, mesh = worlds
    for o in mesh:
        got = o["lm_without_mesh"]
        assert "reduces over 2 (axis 'dp')" in got["default"], got
        assert "reduces over 1 (axis None)" in got["plain"], got
        for msg in (got["default"], got["plain"]):
            assert "Transformer(..., mesh=hvd.data_mesh())" in msg
            assert "lm_optimizer" in msg
        assert math.isfinite(got["pair"])
        assert got["pair"] == mesh[0]["lm_without_mesh"]["pair"]


def _eager_refusal() -> str:
    """The head of the reference's message (``horovod_tpu/ops/eager.py:
    126-133``)."""
    return ("eager collectives reduce over the whole world and cannot "
            "honor a data mesh with model-parallel axes")


@pytest.mark.parametrize("spec", ["dp:2,tp:2", "dp:2,sp:2"])
def test_broadcast_helpers_refuse_a_model_parallel_mesh(worlds, spec):
    """ROADMAP Queue C, repaired: under a data mesh with tp or sp > 1 the
    broadcast helpers raise the reference's error on every rank (its
    helpers run on the eager plane, which refuses such a mesh), and the
    weights, seeded differently on every rank, stay each rank's own.
    Before the repair ranks 1 and 3 of ``dp:2,tp:2`` took rank 1's
    weights and nothing raised."""
    _, mesh = worlds
    weights = []
    for o in mesh:
        got = o["queue_c"][spec]
        for what in ("params", "state", "object", "skipping"):
            assert got[what] is not None, f"{what} returned under {spec}"
            assert got[what].startswith(_eager_refusal()), got[what]
            assert repr(spec) in got[what]
        assert got["unchanged"]
        weights.append(np.asarray(got["weights"]))
    for r in range(1, len(weights)):
        assert not np.array_equal(weights[r], weights[0])


def test_alltoall_refuses_an_axis_pair(worlds):
    """ROADMAP Queue C, repaired: under ``dp:4`` split into (cross 2,
    local 2) the default axis is the ``("dpc", "dpl")`` pair, and
    ``alltoall`` over it, named or as a ``HopPair``, raises the
    reference's message (``horovod_tpu/ops/collectives.py:857-860``);
    over one axis of the pair it runs."""
    _, mesh = worlds
    msg = ("alltoall over a hierarchical (cross, local) axis pair is "
           "not supported; pass a single mesh axis name")
    for r, o in enumerate(mesh):
        got = o["queue_c"]["alltoall"]
        assert got["default_axis"] == list(M.HIER_DATA_AXES)
        for what in ("default", "pair", "hop_pair"):
            assert got[what] == msg, what
        c, _ = divmod(r, 2)
        assert got["local"] == [10.0 * (2 * c) + r % 2,
                                10.0 * (2 * c + 1) + r % 2]


def test_build_data_mesh_layouts(worlds):
    """``build_data_mesh``: dp outermost; under the hierarchical split
    (knob on, local size 2) dp becomes (dpc, dpl) with the pair's flat
    group over the whole dp axis, cross-major; a local size that does not
    cut dp leaves the flat dp axis.  The JAX package's on 4 devices have
    the same names and shapes."""
    _, mesh = worlds
    devs = jax.devices()[:4]
    jm = JM.build_data_mesh({"dp": 2, "tp": 2}, devices=devs)
    os.environ.update({"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                       "HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2"})
    try:
        js = JM.build_data_mesh({"dp": 4}, devices=devs)
        os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"] = "3"
        jn = JM.build_data_mesh({"dp": 4}, devices=devs)
    finally:
        for k in KNOBS[1:]:
            os.environ.pop(k, None)
    for r, o in enumerate(mesh):
        assert o["built"] == [list(jm.axis_names), list(jm.devices.shape)]
        assert o["split"] == [list(js.axis_names), list(js.devices.shape),
                              [0, 1, 2, 3], r]
        assert o["nosplit"] == list(jn.axis_names)

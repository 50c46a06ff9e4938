"""The port's negotiation wire codec: the native one
(``horovod_tpu_torch/csrc/wire.cc``, built with ``g++`` at first use)
against the port's pure-Python one and the JAX package's
(``horovod_tpu.runtime.wire``), byte for byte, on hypothesis-generated
rank and response messages; truncated and corrupt input raises as the
reference's does (``tests/test_wire.py:154-195``)."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from horovod_tpu.runtime import wire as jwire

from horovod_tpu_torch import _build
from horovod_tpu_torch.runtime import wire as twire

KINDS = ["allreduce", "allgather", "broadcast", "alltoall", "join", "error",
         "reducescatter"]
NAME = st.text(min_size=0, max_size=24)
U32 = st.integers(0, 2 ** 32 - 1)
I64 = st.integers(-(2 ** 63), 2 ** 63 - 1)
DIMS = st.lists(st.integers(0, 2 ** 40), max_size=4)


@pytest.fixture(scope="module")
def native():
    assert twire.native_loaded(), "the native codec did not build"
    return twire._native


REQUEST = st.fixed_dictionaries({
    "n": NAME, "k": st.sampled_from(KINDS[:4] + ["reducescatter"]),
    "o": st.integers(0, 3), "d": st.integers(0, 10), "s": DIMS,
    "r": st.integers(-1, 2 ** 31 - 1)})

RANK_MSG = st.builds(
    lambda b, i, req, j, x, cfg: {
        "b": sorted(b), "i": sorted(i), "req": req, "j": j, "x": x,
        **({"cfg": cfg} if cfg is not None else {})},
    st.lists(U32, max_size=8), st.lists(U32, max_size=4),
    st.lists(REQUEST, max_size=5), st.booleans(), st.booleans(),
    st.none() | st.lists(I64, min_size=1, max_size=28))

RESPONSE = st.builds(
    lambda k, names, o, r, d, shapes, e, j, fd: {
        "k": k, "n": names, "o": o, "r": r, "d": d,
        "s": shapes[:len(names)], "e": e if k == "error" else None,
        "j": j, "fd": fd},
    st.sampled_from(KINDS), st.lists(NAME, max_size=3),
    st.integers(0, 3), st.integers(-1, 7), st.integers(0, 10),
    st.lists(DIMS, max_size=3), st.text(max_size=40),
    st.integers(-1, 7), st.lists(st.integers(0, 2 ** 40), max_size=4))

RESP_MSG = st.one_of(
    st.builds(lambda f: {"f": sorted(f)}, st.lists(U32, max_size=10)),
    st.builds(lambda resp, i, x, aj, lj: {"resp": resp, "i": sorted(i),
                                          "x": x, "aj": aj, "lj": lj},
              st.lists(RESPONSE, max_size=4), st.lists(U32, max_size=4),
              st.booleans(), st.booleans(), st.integers(-1, 7)))


@settings(max_examples=150, deadline=None, database=None)
@given(m=RANK_MSG)
def test_rank_messages_byte_identical(native, m):
    b = native.encode_rank_msg(m)
    assert b == twire._py_encode_rank_msg(m) == jwire._py_encode_rank_msg(m)
    assert native.decode_rank_msg(b) == twire._py_decode_rank_msg(b) == \
        jwire._py_decode_rank_msg(b)
    assert twire.dumps_rank(m) == jwire.dumps_rank(m)


@settings(max_examples=150, deadline=None, database=None)
@given(m=RESP_MSG)
def test_response_messages_byte_identical(native, m):
    b = native.encode_resp_msg(m)
    assert b == twire._py_encode_resp_msg(m) == jwire._py_encode_resp_msg(m)
    assert native.decode_resp_msg(b) == twire._py_decode_resp_msg(b) == \
        jwire._py_decode_resp_msg(b)
    assert twire.loads_resp(jwire.dumps_resp(m)) == jwire.loads_resp(
        twire.dumps_resp(m))


def test_tune_field_byte_identical(native):
    m = {"f": [1, 2], "t": {"fusion_threshold": 1024,
                            "cache_enabled": True}}
    assert native.encode_resp_msg(m) == twire._py_encode_resp_msg(m) == \
        jwire._py_encode_resp_msg(m)


def _good_rank():
    return twire._py_encode_rank_msg(
        {"b": [], "i": [], "j": False, "x": False,
         "req": [{"n": "t", "k": "allreduce", "o": 2, "d": 8, "s": [4],
                  "r": -1}]})


def test_truncated_input_raises_as_the_reference(native):
    good = _good_rank()
    bad_kind = bytearray(good)
    bad_kind[14] = 99
    for blob in (b"R\x00\xff", good[:15], bytes(bad_kind)):
        with pytest.raises(ValueError):
            twire._py_decode_rank_msg(blob)
        with pytest.raises(ValueError):
            jwire._py_decode_rank_msg(blob)
        with pytest.raises(ValueError):
            native.decode_rank_msg(blob)
    for cut in range(len(good)):
        with pytest.raises(ValueError):
            native.decode_rank_msg(good[:cut])
    with pytest.raises(ValueError):
        twire._py_decode_resp_msg(b"P\x00")
    with pytest.raises(ValueError):
        native.decode_resp_msg(b"P\x00")
    # a u32 count of 0xFFFFFFFF raises instead of allocating
    for blob in (b"R\x00" + b"\xff\xff\xff\xff",
                 b"P\x00\xff\xff\xff\xff" + b"\xff\xff\xff\xff"):
        with pytest.raises(Exception):
            native.decode_rank_msg(blob) if blob[:1] == b"R" \
                else native.decode_resp_msg(blob)
    base = {"b": [], "i": [], "j": False, "x": False, "req": []}
    with pytest.raises(OverflowError):
        native.encode_rank_msg({**base, "b": [1 << 33]})


def test_codec_switch_and_build_key(monkeypatch):
    """The module without its native codec (the logged fallback's state)
    encodes the same bytes, and the extension lands in the build
    directory under its source hash."""
    m = {"b": [3], "i": [], "j": True, "x": False, "req": [],
         "cfg": [1, 2, 3]}
    assert twire.native_loaded()
    fast = twire.dumps_rank(m)
    mod = twire._native
    with monkeypatch.context() as mp:
        mp.setattr(twire, "_native", None)
        assert not twire.native_loaded()
        assert twire.dumps_rank(m) == fast
    assert mod.__file__.startswith(_build.BUILD_DIR)
    assert "_hvdtorchwire_" in mod.__file__

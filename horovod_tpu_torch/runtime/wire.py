"""The negotiation wire's codec (counterpart of
``horovod_tpu/runtime/wire.py``): the JAX package's pure-Python codec,
byte for byte, so either package decodes the other's messages.

Layout (little-endian, fixed widths):

RankMsg ('R'): magic u8, flags u8 (1=joined, 2=shutdown, 4=has_cfg),
  [cfg: u8 count + i64[count], the round-0 handshake knobs],
  u32 nbits + u32[], u32 ninv + u32[], u32 nreq + requests
  (request: kind u8, op u8, dtype u8, root i32, name u16+bytes,
   ndims u8, dims i64[]).

RespMsg ('P'): magic u8, flags u8 (1=shutdown, 2=all_joined, 4=fast,
  8=has_tune), lj i32, [tune: u32 + json-utf8], then either fast-path
  u32 nbits + u32[] or u32 ninv + u32[], u32 nresp + responses
  (response: kind u8, op u8, dtype u8, root i32, last_joined i32,
   has_error u8 [+ u32+bytes], nnames u16 + (u16+bytes)[],
   nshapes u16 + (ndims u8, dims i64[])[], nfd u16 + i64[]).

The store carries strings, so the binary is base64-wrapped by
``dumps_*``/``loads_*``.  The codec is the native one,
``horovod_tpu_torch/csrc/wire.cc`` (built with ``g++`` at first use,
:func:`horovod_tpu_torch._build.load_host_extension`), byte-identical to
this module's pure-Python one, which takes over with a logged warning
when the build fails (``horovod_tpu/runtime/wire.py:241-282``).
:func:`native_loaded` says which codec runs.
"""

from __future__ import annotations

import base64
import json
import struct

KINDS = ["allreduce", "allgather", "broadcast", "alltoall", "join",
         "error", "reducescatter"]
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}

_u8 = struct.Struct("<B")
_u16 = struct.Struct("<H")
_u32 = struct.Struct("<I")
_i32 = struct.Struct("<i")
_i64 = struct.Struct("<q")


def _py_encode_rank_msg(m: dict) -> bytes:
    out = [b"R"]
    cfg = m.get("cfg")
    flags = ((1 if m.get("j") else 0) | (2 if m.get("x") else 0)
             | (4 if cfg is not None else 0))
    out.append(_u8.pack(flags))
    if cfg is not None:
        if not 1 <= len(cfg) <= 255:
            raise ValueError("cfg must be a 1..255-element sequence")
        out.append(_u8.pack(len(cfg)))
        for v in cfg:
            out.append(_i64.pack(int(v)))
    for key in ("b", "i"):
        vals = m.get(key) or []
        out.append(_u32.pack(len(vals)))
        out.append(struct.pack(f"<{len(vals)}I", *vals))
    reqs = m.get("req") or []
    out.append(_u32.pack(len(reqs)))
    for q in reqs:
        name = q["n"].encode()
        dims = q["s"]
        out.append(struct.pack("<BBBi", _KIND_CODE[q["k"]], q["o"],
                               q["d"], q["r"]))
        out.append(_u16.pack(len(name)))
        out.append(name)
        out.append(_u8.pack(len(dims)))
        out.append(struct.pack(f"<{len(dims)}q", *dims))
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, st: struct.Struct):
        try:
            v = st.unpack_from(self.buf, self.pos)[0]
        except struct.error as e:
            raise ValueError(f"truncated wire message: {e}") from None
        self.pos += st.size
        return v

    def take_n(self, fmt_char: str, n: int, width: int):
        try:
            v = list(struct.unpack_from(f"<{n}{fmt_char}", self.buf,
                                        self.pos))
        except struct.error as e:
            raise ValueError(f"truncated wire message: {e}") from None
        self.pos += n * width
        return v

    def take_bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated wire message")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def take_fmt(self, fmt: str, size: int):
        try:
            v = struct.unpack_from(fmt, self.buf, self.pos)
        except struct.error as e:
            raise ValueError(f"truncated wire message: {e}") from None
        self.pos += size
        return v


def _py_decode_rank_msg(buf: bytes) -> dict:
    r = _Reader(buf)
    if r.take_bytes(1) != b"R":
        raise ValueError("bad rank-message magic")
    flags = r.take(_u8)
    m: dict = {"j": bool(flags & 1), "x": bool(flags & 2)}
    if flags & 4:
        m["cfg"] = r.take_n("q", r.take(_u8), 8)
    m["b"] = r.take_n("I", r.take(_u32), 4)
    m["i"] = r.take_n("I", r.take(_u32), 4)
    reqs = []
    for _ in range(r.take(_u32)):
        kind, op, dt, root = r.take_fmt("<BBBi", 7)
        if kind >= len(KINDS):
            raise ValueError(f"bad request kind code {kind}")
        name = r.take_bytes(r.take(_u16)).decode()
        dims = r.take_n("q", r.take(_u8), 8)
        reqs.append({"n": name, "k": KINDS[kind], "o": op, "d": dt,
                     "s": dims, "r": root})
    m["req"] = reqs
    return m


def _py_encode_resp_msg(m: dict) -> bytes:
    out = [b"P"]
    fast = "f" in m
    tune = m.get("t")
    flags = ((1 if m.get("x") else 0) | (2 if m.get("aj") else 0)
             | (4 if fast else 0) | (8 if tune is not None else 0))
    out.append(_u8.pack(flags))
    out.append(_i32.pack(int(m.get("lj", -1))))
    if tune is not None:
        tb = json.dumps(tune, sort_keys=True).encode()
        out.append(_u32.pack(len(tb)))
        out.append(tb)
    if fast:
        bits = m["f"]
        out.append(_u32.pack(len(bits)))
        out.append(struct.pack(f"<{len(bits)}I", *bits))
        return b"".join(out)
    inv = m.get("i") or []
    out.append(_u32.pack(len(inv)))
    out.append(struct.pack(f"<{len(inv)}I", *inv))
    resps = m.get("resp") or []
    out.append(_u32.pack(len(resps)))
    for p in resps:
        out.append(struct.pack("<BBBii", _KIND_CODE[p["k"]], p["o"],
                               p["d"], p["r"], p["j"]))
        err = p.get("e")
        if err is None:
            out.append(_u8.pack(0))
        else:
            eb = err.encode()
            out.append(_u8.pack(1))
            out.append(_u32.pack(len(eb)))
            out.append(eb)
        names = p["n"]
        out.append(_u16.pack(len(names)))
        for nm in names:
            nb = nm.encode()
            out.append(_u16.pack(len(nb)))
            out.append(nb)
        shapes = p["s"]
        out.append(_u16.pack(len(shapes)))
        for sh in shapes:
            out.append(_u8.pack(len(sh)))
            out.append(struct.pack(f"<{len(sh)}q", *sh))
        fd = p.get("fd") or []
        out.append(_u16.pack(len(fd)))
        out.append(struct.pack(f"<{len(fd)}q", *fd))
    return b"".join(out)


def _py_decode_resp_msg(buf: bytes) -> dict:
    r = _Reader(buf)
    if r.take_bytes(1) != b"P":
        raise ValueError("bad response-message magic")
    flags = r.take(_u8)
    m: dict = {"x": bool(flags & 1), "aj": bool(flags & 2)}
    m["lj"] = r.take(_i32)
    if flags & 8:
        m["t"] = json.loads(r.take_bytes(r.take(_u32)).decode())
    if flags & 4:
        m["f"] = r.take_n("I", r.take(_u32), 4)
        del m["x"], m["aj"], m["lj"]
        return m
    m["i"] = r.take_n("I", r.take(_u32), 4)
    resps = []
    for _ in range(r.take(_u32)):
        kind, op, dt, root, lj = r.take_fmt("<BBBii", 11)
        if kind >= len(KINDS):
            raise ValueError(f"bad response kind code {kind}")
        err = None
        if r.take(_u8):
            err = r.take_bytes(r.take(_u32)).decode()
        names = [r.take_bytes(r.take(_u16)).decode()
                 for _ in range(r.take(_u16))]
        shapes = [r.take_n("q", r.take(_u8), 8)
                  for _ in range(r.take(_u16))]
        fd = r.take_n("q", r.take(_u16), 8)
        resps.append({"k": KINDS[kind], "n": names, "o": op, "r": root,
                      "d": dt, "s": shapes, "e": err, "j": lj,
                      "fd": fd})
    m["resp"] = resps
    return m


# ---------------------------------------------------------------------------
# Public API (strings on the store)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The native codec
# ---------------------------------------------------------------------------

_native = None
_native_tried = False


def _load_native():
    global _native, _native_tried
    if _native_tried:
        return _native
    _native_tried = True
    try:
        from horovod_tpu_torch import _build

        _native = _build.load_host_extension("_hvdtorchwire", "wire.cc")
    except Exception as exc:  # noqa: BLE001 -- the same bytes, in Python
        from horovod_tpu_torch.common import logging as _log

        _log.warning("native wire codec unavailable (%r); using the "
                     "pure-Python fallback" % (exc,))
        _native = None
    return _native


def native_loaded() -> bool:
    """True when the native codec is built, loaded and in use."""
    return _load_native() is not None


def encode_rank_msg(m: dict) -> bytes:
    n = _load_native()
    return n.encode_rank_msg(m) if n else _py_encode_rank_msg(m)


def decode_rank_msg(b: bytes) -> dict:
    n = _load_native()
    return n.decode_rank_msg(b) if n else _py_decode_rank_msg(b)


def encode_resp_msg(m: dict) -> bytes:
    n = _load_native()
    return n.encode_resp_msg(m) if n else _py_encode_resp_msg(m)


def decode_resp_msg(b: bytes) -> dict:
    n = _load_native()
    return n.decode_resp_msg(b) if n else _py_decode_resp_msg(b)


def dumps_rank(m: dict) -> str:
    return base64.b64encode(encode_rank_msg(m)).decode()


def loads_rank(s: str) -> dict:
    return decode_rank_msg(base64.b64decode(s))


def dumps_resp(m: dict) -> str:
    return base64.b64encode(encode_resp_msg(m)).decode()


def loads_resp(s: str) -> dict:
    return decode_resp_msg(base64.b64decode(s))

// The negotiation wire's native codec -- the C++ side of
// horovod_tpu_torch/runtime/wire.py.
//
// The reference serializes its negotiation messages with FlatBuffers in
// C++ (horovod/common/message.{h,cc}, horovod/common/wire/message.fbs);
// here the RankMsg/RespMsg layouts are fixed-width little-endian structs
// (spec in wire.py's docstring), and this CPython extension encodes and
// decodes them straight to and from Python dicts.  Rank 0 decodes
// world_size rank messages every negotiation round, which is why decode
// lives in C++.  It is host code: g++ builds it at first use.
//
// Byte-identical to the pure-Python codec (and to the JAX package's
// native codec, of which it is a copy); tests/test_torch_wire.py holds
// the three equal on generated messages.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

const char* kKinds[] = {"allreduce", "allgather",    "broadcast",
                        "alltoall",  "join",         "error",
                        "reducescatter"};
constexpr int kNumKinds = 7;

int kind_code(const char* k) {
  for (int i = 0; i < kNumKinds; ++i)
    if (std::strcmp(k, kKinds[i]) == 0) return i;
  return -1;
}

// ---- little-endian append helpers (x86-64 and aarch64 hosts are LE) ----
template <typename T>
void put(std::string& b, T v) {
  b.append(reinterpret_cast<const char*>(&v), sizeof(T));
}

struct Reader {
  const uint8_t* p;
  Py_ssize_t n;
  Py_ssize_t pos = 0;
  bool fail = false;

  template <typename T>
  T take() {
    if (pos + (Py_ssize_t)sizeof(T) > n) {
      fail = true;
      return T{};
    }
    T v;
    std::memcpy(&v, p + pos, sizeof(T));
    pos += sizeof(T);
    return v;
  }
  const char* take_bytes(Py_ssize_t len) {
    if (pos + len > n) {
      fail = true;
      return nullptr;
    }
    const char* out = reinterpret_cast<const char*>(p + pos);
    pos += len;
    return out;
  }
};

// ---- dict access helpers --------------------------------------------
PyObject* dget(PyObject* d, const char* k) {  // borrowed, may be null
  return PyDict_GetItemString(d, k);
}

bool truthy(PyObject* d, const char* k) {
  PyObject* v = dget(d, k);
  return v && PyObject_IsTrue(v) == 1;
}

// Append a u32-counted list of u32s from a Python list (or missing).
bool put_u32_list(std::string& b, PyObject* d, const char* k) {
  PyObject* v = dget(d, k);
  if (!v || v == Py_None) {
    put<uint32_t>(b, 0);
    return true;
  }
  if (!PyList_Check(v)) return false;
  Py_ssize_t n = PyList_GET_SIZE(v);
  // Range-check before casting: the Python codec raises on values that
  // don't fit u32, and a silent (uint32_t) truncation here would make
  // the two codecs disagree on the wire.
  if ((unsigned long long)n > 0xffffffffULL) {
    PyErr_Format(PyExc_OverflowError,
                 "wire: list '%s' length %zd exceeds u32", k, n);
    return false;
  }
  put<uint32_t>(b, (uint32_t)n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    long long x = PyLong_AsLongLong(PyList_GET_ITEM(v, i));
    if (x == -1 && PyErr_Occurred()) return false;
    if (x < 0 || (unsigned long long)x > 0xffffffffULL) {
      PyErr_Format(PyExc_OverflowError,
                   "wire: list '%s' value %lld does not fit u32", k, x);
      return false;
    }
    put<uint32_t>(b, (uint32_t)x);
  }
  return true;
}

PyObject* take_u32_list(Reader& r) {  // new ref
  uint32_t n = r.take<uint32_t>();
  // bound the allocation by the bytes actually present — a corrupt
  // count must fail cleanly, not allocate by attacker-controlled size
  if (r.fail || (Py_ssize_t)n * 4 > r.n - r.pos) {
    r.fail = true;
    return nullptr;
  }
  PyObject* out = PyList_New(n);
  if (!out) return nullptr;
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t x = r.take<uint32_t>();
    if (r.fail) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, PyLong_FromUnsignedLong(x));
  }
  return out;
}

bool put_str(std::string& b, PyObject* s, bool wide) {
  Py_ssize_t len;
  const char* utf = PyUnicode_AsUTF8AndSize(s, &len);
  if (!utf) return false;
  Py_ssize_t limit = wide ? (Py_ssize_t)UINT32_MAX : (Py_ssize_t)UINT16_MAX;
  if (len > limit) {
    PyErr_SetString(PyExc_ValueError, "string too long for wire field");
    return false;
  }
  if (wide)
    put<uint32_t>(b, (uint32_t)len);
  else
    put<uint16_t>(b, (uint16_t)len);
  b.append(utf, len);
  return true;
}

long as_long(PyObject* d, const char* k, long dflt) {
  PyObject* v = dget(d, k);
  if (!v || v == Py_None) return dflt;
  return PyLong_AsLong(v);
}

// ---------------------------------------------------------------------
// RankMsg
// ---------------------------------------------------------------------

PyObject* encode_rank_msg(PyObject*, PyObject* arg) {
  if (!PyDict_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected dict");
    return nullptr;
  }
  std::string b;
  b.reserve(256);
  b.push_back('R');
  PyObject* cfg = dget(arg, "cfg");
  uint8_t flags = (truthy(arg, "j") ? 1 : 0) | (truthy(arg, "x") ? 2 : 0) |
                  ((cfg && cfg != Py_None) ? 4 : 0);
  put<uint8_t>(b, flags);
  if (flags & 4) {
    if (!PySequence_Check(cfg) || PySequence_Size(cfg) < 1 ||
        PySequence_Size(cfg) > 255) {
      PyErr_SetString(PyExc_ValueError,
                      "cfg must be a 1..255-element sequence");
      return nullptr;
    }
    Py_ssize_t ncfg = PySequence_Size(cfg);
    put<uint8_t>(b, (uint8_t)ncfg);
    for (Py_ssize_t i = 0; i < ncfg; ++i) {
      PyObject* it = PySequence_GetItem(cfg, i);
      long long v = PyLong_AsLongLong(it);
      Py_XDECREF(it);
      if (v == -1 && PyErr_Occurred()) return nullptr;
      put<int64_t>(b, (int64_t)v);
    }
  }
  if (!put_u32_list(b, arg, "b") || !put_u32_list(b, arg, "i")) {
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "bad bit list");
    return nullptr;
  }
  PyObject* reqs = dget(arg, "req");
  Py_ssize_t nreq =
      (reqs && PyList_Check(reqs)) ? PyList_GET_SIZE(reqs) : 0;
  put<uint32_t>(b, (uint32_t)nreq);
  for (Py_ssize_t i = 0; i < nreq; ++i) {
    PyObject* q = PyList_GET_ITEM(reqs, i);
    if (!PyDict_Check(q)) {
      PyErr_SetString(PyExc_TypeError, "request must be dict");
      return nullptr;
    }
    PyObject* kindo = dget(q, "k");
    const char* kind = kindo ? PyUnicode_AsUTF8(kindo) : nullptr;
    int kc = kind ? kind_code(kind) : -1;
    if (kc < 0) {
      PyErr_SetString(PyExc_ValueError, "unknown request kind");
      return nullptr;
    }
    put<uint8_t>(b, (uint8_t)kc);
    put<uint8_t>(b, (uint8_t)as_long(q, "o", 0));
    put<uint8_t>(b, (uint8_t)as_long(q, "d", 0));
    put<int32_t>(b, (int32_t)as_long(q, "r", -1));
    if (PyErr_Occurred()) return nullptr;
    PyObject* name = dget(q, "n");
    if (!name || !put_str(b, name, false)) return nullptr;
    PyObject* dims = dget(q, "s");
    if (!dims || !PySequence_Check(dims)) {
      PyErr_SetString(PyExc_ValueError, "request shape missing");
      return nullptr;
    }
    Py_ssize_t nd = PySequence_Size(dims);
    if (nd > 255) {
      PyErr_SetString(PyExc_ValueError, "too many dims for wire field");
      return nullptr;
    }
    put<uint8_t>(b, (uint8_t)nd);
    for (Py_ssize_t j = 0; j < nd; ++j) {
      PyObject* it = PySequence_GetItem(dims, j);
      long long v = PyLong_AsLongLong(it);
      Py_XDECREF(it);
      if (v == -1 && PyErr_Occurred()) return nullptr;
      put<int64_t>(b, (int64_t)v);
    }
  }
  return PyBytes_FromStringAndSize(b.data(), (Py_ssize_t)b.size());
}

PyObject* decode_rank_msg(PyObject*, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) return nullptr;
  Reader r{(const uint8_t*)view.buf, view.len};
  PyObject* out = nullptr;
  PyObject *bits = nullptr, *inv = nullptr, *reqs = nullptr;
  do {
    const char* magic = r.take_bytes(1);
    if (!magic || magic[0] != 'R') {
      PyErr_SetString(PyExc_ValueError, "bad rank-message magic");
      break;
    }
    uint8_t flags = r.take<uint8_t>();
    out = PyDict_New();
    if (!out) break;
    PyDict_SetItemString(out, "j", (flags & 1) ? Py_True : Py_False);
    PyDict_SetItemString(out, "x", (flags & 2) ? Py_True : Py_False);
    if (flags & 4) {
      uint8_t ncfg = r.take<uint8_t>();
      if (r.fail) break;
      PyObject* cfg = PyList_New(ncfg);
      if (!cfg) break;
      bool cfg_ok = true;
      for (uint8_t i = 0; i < ncfg; ++i) {
        int64_t v = r.take<int64_t>();
        if (r.fail) { cfg_ok = false; break; }
        PyObject* it = PyLong_FromLongLong((long long)v);
        if (!it) { cfg_ok = false; break; }
        PyList_SET_ITEM(cfg, i, it);
      }
      if (!cfg_ok) {
        Py_DECREF(cfg);
        break;
      }
      PyDict_SetItemString(out, "cfg", cfg);
      Py_DECREF(cfg);
    }
    bits = take_u32_list(r);
    inv = bits ? take_u32_list(r) : nullptr;
    if (!inv) break;
    PyDict_SetItemString(out, "b", bits);
    PyDict_SetItemString(out, "i", inv);
    uint32_t nreq = r.take<uint32_t>();
    // each request occupies >= 10 bytes; a count beyond the remaining
    // buffer is corrupt — reject before allocating
    if (r.fail || (Py_ssize_t)nreq > (r.n - r.pos) / 10 + 1) break;
    reqs = PyList_New(nreq);
    if (!reqs) break;
    bool ok = true;
    for (uint32_t i = 0; i < nreq && ok; ++i) {
      uint8_t kc = r.take<uint8_t>();
      uint8_t op = r.take<uint8_t>();
      uint8_t dt = r.take<uint8_t>();
      int32_t root = r.take<int32_t>();
      uint16_t nlen = r.take<uint16_t>();
      const char* name = r.take_bytes(nlen);
      uint8_t nd = r.take<uint8_t>();
      if (r.fail || kc >= kNumKinds || !name) {
        ok = false;
        break;
      }
      PyObject* dims = PyList_New(nd);
      if (!dims) {
        ok = false;
        break;
      }
      for (uint8_t j = 0; j < nd; ++j) {
        int64_t v = r.take<int64_t>();
        PyList_SET_ITEM(dims, j, PyLong_FromLongLong(v));
      }
      if (r.fail) {
        Py_DECREF(dims);
        ok = false;
        break;
      }
      PyObject* q = Py_BuildValue(
          "{s:s#, s:s, s:i, s:i, s:N, s:i}", "n", name, (Py_ssize_t)nlen,
          "k", kKinds[kc], "o", (int)op, "d", (int)dt, "s", dims, "r",
          (int)root);
      if (!q) {
        ok = false;
        break;
      }
      PyList_SET_ITEM(reqs, i, q);
    }
    if (!ok) break;
    PyDict_SetItemString(out, "req", reqs);
    Py_DECREF(reqs);
    Py_DECREF(bits);
    Py_DECREF(inv);
    PyBuffer_Release(&view);
    return out;
  } while (false);
  Py_XDECREF(bits);
  Py_XDECREF(inv);
  Py_XDECREF(reqs);
  Py_XDECREF(out);
  PyBuffer_Release(&view);
  if (!PyErr_Occurred())
    PyErr_SetString(PyExc_ValueError, "truncated rank message");
  return nullptr;
}

// ---------------------------------------------------------------------
// RespMsg
// ---------------------------------------------------------------------

PyObject* encode_resp_msg(PyObject*, PyObject* arg) {
  if (!PyDict_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected dict");
    return nullptr;
  }
  std::string b;
  b.reserve(256);
  b.push_back('P');
  PyObject* fast = dget(arg, "f");
  PyObject* tune = dget(arg, "t");
  bool has_tune = tune && tune != Py_None;
  uint8_t flags = (truthy(arg, "x") ? 1 : 0) | (truthy(arg, "aj") ? 2 : 0) |
                  (fast ? 4 : 0) | (has_tune ? 8 : 0);
  put<uint8_t>(b, flags);
  long lj = as_long(arg, "lj", -1);
  if (PyErr_Occurred()) return nullptr;
  put<int32_t>(b, (int32_t)lj);
  if (has_tune) {
    PyObject* json = PyImport_ImportModule("json");
    if (!json) return nullptr;
    PyObject* kw = Py_BuildValue("{s:O}", "sort_keys", Py_True);
    PyObject* dumps = PyObject_GetAttrString(json, "dumps");
    PyObject* args = PyTuple_Pack(1, tune);
    PyObject* s = (dumps && args && kw)
                      ? PyObject_Call(dumps, args, kw)
                      : nullptr;
    Py_XDECREF(args);
    Py_XDECREF(kw);
    Py_XDECREF(dumps);
    Py_DECREF(json);
    if (!s) return nullptr;
    bool ok = put_str(b, s, true);
    Py_DECREF(s);
    if (!ok) return nullptr;
  }
  if (fast) {
    if (!put_u32_list(b, arg, "f")) return nullptr;
    return PyBytes_FromStringAndSize(b.data(), (Py_ssize_t)b.size());
  }
  if (!put_u32_list(b, arg, "i")) return nullptr;
  PyObject* resps = dget(arg, "resp");
  Py_ssize_t nresp =
      (resps && PyList_Check(resps)) ? PyList_GET_SIZE(resps) : 0;
  put<uint32_t>(b, (uint32_t)nresp);
  for (Py_ssize_t i = 0; i < nresp; ++i) {
    PyObject* p = PyList_GET_ITEM(resps, i);
    if (!PyDict_Check(p)) {
      PyErr_SetString(PyExc_TypeError, "response must be dict");
      return nullptr;
    }
    PyObject* kindo = dget(p, "k");
    const char* kind = kindo ? PyUnicode_AsUTF8(kindo) : nullptr;
    int kc = kind ? kind_code(kind) : -1;
    if (kc < 0) {
      PyErr_SetString(PyExc_ValueError, "unknown response kind");
      return nullptr;
    }
    put<uint8_t>(b, (uint8_t)kc);
    put<uint8_t>(b, (uint8_t)as_long(p, "o", 0));
    put<uint8_t>(b, (uint8_t)as_long(p, "d", 0));
    put<int32_t>(b, (int32_t)as_long(p, "r", -1));
    put<int32_t>(b, (int32_t)as_long(p, "j", -1));
    if (PyErr_Occurred()) return nullptr;
    PyObject* err = dget(p, "e");
    if (!err || err == Py_None) {
      put<uint8_t>(b, 0);
    } else {
      put<uint8_t>(b, 1);
      if (!put_str(b, err, true)) return nullptr;
    }
    PyObject* names = dget(p, "n");
    Py_ssize_t nn =
        (names && PyList_Check(names)) ? PyList_GET_SIZE(names) : 0;
    put<uint16_t>(b, (uint16_t)nn);
    for (Py_ssize_t j = 0; j < nn; ++j)
      if (!put_str(b, PyList_GET_ITEM(names, j), false)) return nullptr;
    PyObject* shapes = dget(p, "s");
    Py_ssize_t ns =
        (shapes && PyList_Check(shapes)) ? PyList_GET_SIZE(shapes) : 0;
    put<uint16_t>(b, (uint16_t)ns);
    for (Py_ssize_t j = 0; j < ns; ++j) {
      PyObject* sh = PyList_GET_ITEM(shapes, j);
      if (!PySequence_Check(sh)) {
        PyErr_SetString(PyExc_ValueError, "shape must be a sequence");
        return nullptr;
      }
      Py_ssize_t nd = PySequence_Size(sh);
      if (nd > 255) {
        PyErr_SetString(PyExc_ValueError, "too many dims for wire field");
        return nullptr;
      }
      put<uint8_t>(b, (uint8_t)nd);
      for (Py_ssize_t d = 0; d < nd; ++d) {
        PyObject* it = PySequence_GetItem(sh, d);
        long long v = PyLong_AsLongLong(it);
        Py_XDECREF(it);
        if (v == -1 && PyErr_Occurred()) return nullptr;
        put<int64_t>(b, (int64_t)v);
      }
    }
    // per-rank allgather first dims ("fd"; empty for other kinds)
    PyObject* fd = dget(p, "fd");
    Py_ssize_t nfd = (fd && PyList_Check(fd)) ? PyList_GET_SIZE(fd) : 0;
    put<uint16_t>(b, (uint16_t)nfd);
    for (Py_ssize_t j = 0; j < nfd; ++j) {
      long long v = PyLong_AsLongLong(PyList_GET_ITEM(fd, j));
      if (v == -1 && PyErr_Occurred()) return nullptr;
      put<int64_t>(b, (int64_t)v);
    }
  }
  return PyBytes_FromStringAndSize(b.data(), (Py_ssize_t)b.size());
}

PyObject* decode_resp_msg(PyObject*, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) return nullptr;
  Reader r{(const uint8_t*)view.buf, view.len};
  PyObject* out = nullptr;
  do {
    const char* magic = r.take_bytes(1);
    if (!magic || magic[0] != 'P') {
      PyErr_SetString(PyExc_ValueError, "bad response-message magic");
      break;
    }
    uint8_t flags = r.take<uint8_t>();
    int32_t lj = r.take<int32_t>();
    if (r.fail) break;
    out = PyDict_New();
    if (!out) break;
    if (flags & 8) {
      uint32_t tlen = r.take<uint32_t>();
      const char* tb = r.take_bytes(tlen);
      if (r.fail || !tb) break;
      PyObject* json = PyImport_ImportModule("json");
      if (!json) break;
      PyObject* t =
          PyObject_CallMethod(json, "loads", "s#", tb, (Py_ssize_t)tlen);
      Py_DECREF(json);
      if (!t) break;
      PyDict_SetItemString(out, "t", t);
      Py_DECREF(t);
    }
    if (flags & 4) {
      PyObject* bits = take_u32_list(r);
      if (!bits) break;
      PyDict_SetItemString(out, "f", bits);
      Py_DECREF(bits);
      PyBuffer_Release(&view);
      return out;
    }
    PyDict_SetItemString(out, "x", (flags & 1) ? Py_True : Py_False);
    PyDict_SetItemString(out, "aj", (flags & 2) ? Py_True : Py_False);
    PyObject* ljo = PyLong_FromLong(lj);
    PyDict_SetItemString(out, "lj", ljo);
    Py_DECREF(ljo);
    PyObject* inv = take_u32_list(r);
    if (!inv) break;
    PyDict_SetItemString(out, "i", inv);
    Py_DECREF(inv);
    uint32_t nresp = r.take<uint32_t>();
    // each response occupies >= 16 bytes; bound like the rank decoder
    if (r.fail || (Py_ssize_t)nresp > (r.n - r.pos) / 16 + 1) break;
    PyObject* resps = PyList_New(nresp);
    if (!resps) break;
    bool ok = true;
    for (uint32_t i = 0; i < nresp && ok; ++i) {
      uint8_t kc = r.take<uint8_t>();
      uint8_t op = r.take<uint8_t>();
      uint8_t dt = r.take<uint8_t>();
      int32_t root = r.take<int32_t>();
      int32_t plj = r.take<int32_t>();
      uint8_t has_err = r.take<uint8_t>();
      if (r.fail || kc >= kNumKinds) {
        ok = false;
        break;
      }
      PyObject* err = nullptr;  // new ref or null
      if (has_err) {
        uint32_t elen = r.take<uint32_t>();
        const char* eb = r.take_bytes(elen);
        if (r.fail || !eb) {
          ok = false;
          break;
        }
        err = PyUnicode_FromStringAndSize(eb, elen);
        if (!err) {
          ok = false;
          break;
        }
      }
      uint16_t nn = r.take<uint16_t>();
      if ((Py_ssize_t)nn > (r.n - r.pos) / 2 + 1) r.fail = true;
      PyObject* names = PyList_New(r.fail ? 0 : nn);
      if (!names || r.fail) {
        Py_XDECREF(err);
        Py_XDECREF(names);
        ok = false;
        break;
      }
      for (uint16_t j = 0; j < nn && ok; ++j) {
        uint16_t nl = r.take<uint16_t>();
        const char* nm = r.take_bytes(nl);
        if (r.fail || !nm) {
          ok = false;
          break;
        }
        PyObject* s = PyUnicode_FromStringAndSize(nm, nl);
        if (!s) {
          ok = false;
          break;
        }
        PyList_SET_ITEM(names, j, s);
      }
      uint16_t nshape = ok ? r.take<uint16_t>() : 0;
      if ((Py_ssize_t)nshape > (r.n - r.pos) + 1) r.fail = true;
      PyObject* shapes = ok && !r.fail ? PyList_New(nshape) : nullptr;
      if (!shapes) {
        Py_XDECREF(err);
        Py_DECREF(names);
        ok = false;
        break;
      }
      for (uint16_t j = 0; j < nshape && ok; ++j) {
        uint8_t nd = r.take<uint8_t>();
        PyObject* sh = r.fail ? nullptr : PyList_New(nd);
        if (!sh) {
          ok = false;
          break;
        }
        for (uint8_t d = 0; d < nd; ++d) {
          int64_t v = r.take<int64_t>();
          PyList_SET_ITEM(sh, d, PyLong_FromLongLong(v));
        }
        if (r.fail) {
          Py_DECREF(sh);
          ok = false;
          break;
        }
        PyList_SET_ITEM(shapes, j, sh);
      }
      uint16_t nfd = ok ? r.take<uint16_t>() : 0;
      if ((Py_ssize_t)nfd > (r.n - r.pos) / 8 + 1) r.fail = true;
      PyObject* fdl = ok && !r.fail ? PyList_New(nfd) : nullptr;
      if (fdl) {
        for (uint16_t j = 0; j < nfd; ++j) {
          int64_t v = r.take<int64_t>();
          PyList_SET_ITEM(fdl, j, PyLong_FromLongLong(v));
        }
        if (r.fail) {
          Py_DECREF(fdl);
          fdl = nullptr;
        }
      }
      if (!fdl) ok = false;
      if (!ok) {
        Py_XDECREF(err);
        Py_DECREF(names);
        Py_XDECREF(shapes);
        break;
      }
      PyObject* p = Py_BuildValue(
          "{s:s, s:N, s:i, s:i, s:i, s:N, s:N, s:i, s:N}", "k", kKinds[kc],
          "n", names, "o", (int)op, "r", (int)root, "d", (int)dt, "s",
          shapes, "e", err ? err : (Py_INCREF(Py_None), Py_None), "j",
          (int)plj, "fd", fdl);
      if (!p) {
        ok = false;
        break;
      }
      PyList_SET_ITEM(resps, i, p);
    }
    if (!ok) {
      Py_DECREF(resps);
      break;
    }
    PyDict_SetItemString(out, "resp", resps);
    Py_DECREF(resps);
    PyBuffer_Release(&view);
    return out;
  } while (false);
  Py_XDECREF(out);
  PyBuffer_Release(&view);
  if (!PyErr_Occurred())
    PyErr_SetString(PyExc_ValueError, "truncated response message");
  return nullptr;
}

PyMethodDef kMethods[] = {
    {"encode_rank_msg", encode_rank_msg, METH_O, "dict -> bytes"},
    {"decode_rank_msg", decode_rank_msg, METH_O, "bytes -> dict"},
    {"encode_resp_msg", encode_resp_msg, METH_O, "dict -> bytes"},
    {"decode_resp_msg", decode_resp_msg, METH_O, "bytes -> dict"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_hvdtorchwire",
                       "native controller wire codec", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__hvdtorchwire(void) { return PyModule_Create(&kModule); }

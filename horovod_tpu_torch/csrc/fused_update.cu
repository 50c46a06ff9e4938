// Fused optimizer tail for Hopper (sm_90a): kernels B1-B3 of the port.
//
// Replaces the Pallas kernels of horovod_tpu/optim/fused_update.py:
//   hvd_momentum, hvd_momentum_multi <- _momentum_pallas (:314)
//   hvd_sgd, hvd_sgd_multi           <- _sgd_pallas (:299)
//   hvd_adam, hvd_adam_multi         <- _adam_pallas (:331)
// (kernels :265, :260, :273).
//
// Contract: bit-exact against optax's expressions in their order
// (fused_update.py:208-232).  Every float operation is written as an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), which nvcc never contracts into an FMA: `g + decay * t`
// as one FMA would differ from optax by an ulp.  For bfloat16 the value
// is rounded to bf16 after every operation, as JAX's per-op semantics
// round; the constants arrive already rounded to the working dtype.
// The per-element arithmetic of each update lives once, in its functor
// (SgdOp, MomentumOp, AdamOp); the one-buffer and the multi-leaf
// kernels both call it, so their bits are the same.
//
// Bound: each is a single elementwise pass, so device-memory bandwidth
// bounds it.  Momentum moves 16 B per f32 element (reads g and t, writes
// u and t'): about 409 MB for the 25,557,032 parameters of ResNet-50,
// some 0.12 ms at the H100 SXM's 3.35 TB/s.  SGD moves 8 B per element,
// Adam 24 B (reads g, mu, nu; writes u, mu', nu').  They do 1 to 12
// operations per 8 to 24 bytes, three orders of magnitude below the
// card's ridge of about 295 operations per byte, and each byte is read
// or written once with nothing reused: so no TMA, no wgmma and no
// shared-memory tiles, since there is nothing to stage.  What the design
// goes after instead is what per-leaf launches lose: host time per
// launch (some 15-27 us of Python and ctypes each, 161 launches per
// ResNet-50 step), idle SMs on small leaves, and narrow accesses.
//
// The multi-leaf launcher (hvd_sgd_multi, hvd_momentum_multi,
// hvd_adam_multi) runs one update over a list of leaves of one dtype in
// one launch.  Its leaf table travels in the kernel's parameters (a
// __grid_constant__ struct; since CUDA 12.1 a kernel may take 32,764
// bytes of them), not in device memory: no device table, no
// host-to-device copy, nothing cached.  A row holds the leaf's pointers
// (inputs, then outputs), its element count and its first chunk; each
// block takes one 4096-element chunk of one leaf and finds its row by a
// binary search over the first chunks, every thread of the block reading
// the same row (uniform reads of parameter space are broadcast).  A leaf
// whose pointers are all 16-byte aligned is swept with 16-byte accesses
// (float4, or 8 bf16), chunk starts being multiples of 4096 elements;
// any other leaf (a view at an odd offset) with the scalar loop.  Both
// loops call the same functor per element.  A list longer than the
// table's capacity (Table<Op>::kCap rows, fixed by a static_assert on
// its size) takes ceil(rows / capacity) launches, each with its first
// chunks numbered from 0.
//
// Interface: plain C, loaded with ctypes.  dtype 0 = float32, 1 =
// bfloat16.  Each entry returns the first CUDA error of its launches on
// the caller's stream; nothing is allocated and nothing is synchronised.
// t/t_out (mu/mu_out, nu/nu_out) may alias within a leaf: each element
// is read before it is written by the same thread.  Leaves must not
// alias one another: one launch runs them in no order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

static_assert(CUDART_VERSION >= 12010,
              "the multi-leaf kernels take 32,764 bytes of parameters, "
              "which needs CUDA 12.1 or later");

namespace {

// bytes of parameters a kernel may take (CUDA 12.1 and later, Volta on)
constexpr int kParamBytes = 32764;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
// elements of one leaf that one block of a multi-leaf launch takes
constexpr int64_t kChunk = 4096;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p, int64_t i) {
    return p[i];
  }
  static __device__ __forceinline__ void store(float* p, int64_t i,
                                               float v) {
    p[i] = v;
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p,
                                               int64_t i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i,
                                               float v) {
    p[i] = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// 16 bytes of T as floats: 4 float32 or 8 bfloat16 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const void* p, int64_t i,
                                              float* v) {
    const float4 x =
        *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void store(void* p, int64_t i,
                                               const float* v) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const void* p, int64_t i,
                                              float* v) {
    const uint4 x = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(void* p, int64_t i,
                                               const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + i) = x;
  }
};

// One operation of the working dtype T: exact-rounded in f32, then
// rounded to T.
template <typename T>
__device__ __forceinline__ float mul(float a, float b) {
  return Io<T>::round(__fmul_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float add(float a, float b) {
  return Io<T>::round(__fadd_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float div(float a, float b) {
  return Io<T>::round(__fdiv_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float sqrt_(float a) {
  return Io<T>::round(__fsqrt_rn(a));
}

// _prep_grad: g / navg (Average) when navg > 1, already in dtype T.
template <typename T>
__device__ __forceinline__ float prep(float g, int divide, float navg) {
  return divide ? div<T>(g, navg) : g;
}

// The updates, one element each.  in[0] is the prepared gradient, the
// other inputs the state read at the same element; out[] in the order
// of the row's output pointers.
struct SgdOp {
  static constexpr int kIn = 1, kOut = 1;  // in: g; out: u
  float neg_lr;
  template <typename T>
  __device__ __forceinline__ void apply(const float* in, float* out) const {
    out[0] = mul<T>(neg_lr, in[0]);
  }
};

struct MomentumOp {
  static constexpr int kIn = 2, kOut = 2;  // in: g, t; out: u, t'
  float decay, neg_lr;
  template <typename T>
  __device__ __forceinline__ void apply(const float* in, float* out) const {
    // optax.trace: g + decay * t; optax.scale: (-lr) * t'
    float t2 = add<T>(in[0], mul<T>(decay, in[1]));
    out[1] = t2;
    out[0] = mul<T>(neg_lr, t2);
  }
};

struct AdamOp {
  static constexpr int kIn = 3, kOut = 3;  // in: g, mu, nu; out: u, mu', nu'
  float c1, b1, c2, b2, bc1, bc2, eps_root, eps, neg_lr;
  template <typename T>
  __device__ __forceinline__ void apply(const float* in, float* out) const {
    const float x = in[0];
    // mu2 = (1 - b1) * g + b1 * mu
    float mu2 = add<T>(mul<T>(c1, x), mul<T>(b1, in[1]));
    // nu2 = (1 - b2) * (g * g) + b2 * nu
    float nu2 = add<T>(mul<T>(c2, mul<T>(x, x)), mul<T>(b2, in[2]));
    float mu_hat = div<T>(mu2, bc1);
    float nu_hat = div<T>(nu2, bc2);
    // (-lr) * (mu_hat / (sqrt(nu_hat + eps_root) + eps))
    float den = add<T>(sqrt_<T>(add<T>(nu_hat, eps_root)), eps);
    out[1] = mu2;
    out[2] = nu2;
    out[0] = mul<T>(neg_lr, div<T>(mu_hat, den));
  }
};

// One leaf: its pointers (inputs, then outputs), its element count and
// its first chunk in its launch (int64 values, as the caller lays them
// out).
template <typename Op>
struct Row {
  const void* in[Op::kIn];
  void* out[Op::kOut];
  int64_t n;
  int64_t chunk0;
};

// The multi-leaf kernel's parameters: the update's constants and up to
// kCap rows, sorted by first chunk, the first at chunk 0, every n > 0.
template <typename Op>
struct Table {
  static constexpr int kCap = (kParamBytes - 64) / sizeof(Row<Op>);
  Op op;
  float navg;
  int divide;
  int n_rows;
  Row<Op> rows[kCap];
};
static_assert(sizeof(Table<SgdOp>) <= kParamBytes, "SGD table size");
static_assert(sizeof(Table<MomentumOp>) <= kParamBytes,
              "momentum table size");
static_assert(sizeof(Table<AdamOp>) <= kParamBytes, "Adam table size");

template <typename T, typename Op>
__device__ __forceinline__ void update_at(const Op& op, const Row<Op>& r,
                                          int64_t i, int divide,
                                          float navg) {
  float in[Op::kIn], out[Op::kOut];
  in[0] = prep<T>(Io<T>::load(static_cast<const T*>(r.in[0]), i), divide,
                  navg);
#pragma unroll
  for (int k = 1; k < Op::kIn; ++k)
    in[k] = Io<T>::load(static_cast<const T*>(r.in[k]), i);
  op.template apply<T>(in, out);
#pragma unroll
  for (int k = 0; k < Op::kOut; ++k)
    Io<T>::store(static_cast<T*>(r.out[k]), i, out[k]);
}

// Vec<T>::kN consecutive elements from i (16-byte aligned): the same
// functor per element as update_at.
template <typename T, typename Op>
__device__ __forceinline__ void update_vec(const Op& op, const Row<Op>& r,
                                           int64_t i, int divide,
                                           float navg) {
  constexpr int V = Vec<T>::kN;
  float in[Op::kIn][V], out[Op::kOut][V];
#pragma unroll
  for (int k = 0; k < Op::kIn; ++k) Vec<T>::load(r.in[k], i, in[k]);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float a[Op::kIn], o[Op::kOut];
    a[0] = prep<T>(in[0][e], divide, navg);
#pragma unroll
    for (int k = 1; k < Op::kIn; ++k) a[k] = in[k][e];
    op.template apply<T>(a, o);
#pragma unroll
    for (int k = 0; k < Op::kOut; ++k) out[k][e] = o[k];
  }
#pragma unroll
  for (int k = 0; k < Op::kOut; ++k) Vec<T>::store(r.out[k], i, out[k]);
}

// One buffer of r.n elements, grid-stride.
template <typename T, typename Op>
__global__ void update_kernel(const __grid_constant__ Row<Op> r, int divide,
                              float navg, const __grid_constant__ Op op) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < r.n;
       i += (int64_t)gridDim.x * blockDim.x)
    update_at<T>(op, r, i, divide, navg);
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
    multi_kernel(const __grid_constant__ Table<Op> tab) {
  // the leaf of this block's chunk: the last whose first chunk is <= it
  const int64_t b = blockIdx.x;
  int lo = 0, hi = tab.n_rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.rows[mid].chunk0 <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Row<Op> r = tab.rows[lo];
  const int64_t begin = (b - r.chunk0) * kChunk;
  const int64_t end = begin + kChunk < r.n ? begin + kChunk : r.n;
  uintptr_t bits = 0;
#pragma unroll
  for (int k = 0; k < Op::kIn; ++k)
    bits |= reinterpret_cast<uintptr_t>(r.in[k]);
#pragma unroll
  for (int k = 0; k < Op::kOut; ++k)
    bits |= reinterpret_cast<uintptr_t>(r.out[k]);
  int64_t tail = begin;
  if ((bits & 15) == 0) {
    constexpr int V = Vec<T>::kN;
    tail = begin + (end - begin) / V * V;
    for (int64_t i = begin + (int64_t)threadIdx.x * V; i < tail;
         i += (int64_t)kThreads * V)
      update_vec<T>(tab.op, r, i, tab.divide, tab.navg);
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads)
    update_at<T>(tab.op, r, i, tab.divide, tab.navg);
}

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// One buffer: ptrs holds Op::kIn input pointers, then Op::kOut outputs.
template <typename Op>
int launch_one(int dtype, const void* const* ptrs, int64_t n, int divide,
               float navg, const Op& op, void* stream) {
  if (n <= 0) return 0;
  Row<Op> r;
  for (int k = 0; k < Op::kIn; ++k) r.in[k] = ptrs[k];
  for (int k = 0; k < Op::kOut; ++k)
    r.out[k] = const_cast<void*>(ptrs[Op::kIn + k]);
  r.n = n;
  r.chunk0 = 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    update_kernel<float, Op><<<blocks_for(n), kThreads, 0, s>>>(
        r, divide, navg, op);
  } else if (dtype == 1) {
    update_kernel<__nv_bfloat16, Op><<<blocks_for(n), kThreads, 0, s>>>(
        r, divide, navg, op);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// n_rows rows of Op::kIn + Op::kOut + 2 int64 values each (pointers,
// n, first chunk), numbered from chunk 0 again at every kCap rows.  The
// whole table is checked before the first launch.
template <typename Op>
int launch_multi(int dtype, const int64_t* rows, int n_rows, int chunk,
                 int divide, float navg, const Op& op, void* stream) {
  using Tab = Table<Op>;
  constexpr int kW = Op::kIn + Op::kOut + 2;
  if (rows == nullptr || n_rows <= 0 || chunk != kChunk ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int64_t next = 0;
  for (int j = 0; j < n_rows; ++j) {
    const int64_t n = rows[(int64_t)j * kW + kW - 2];
    const int64_t chunk0 = rows[(int64_t)j * kW + kW - 1];
    if (j % Tab::kCap == 0) next = 0;
    if (n <= 0 || chunk0 != next) return (int)cudaErrorInvalidValue;
    next += (n + kChunk - 1) / kChunk;
    if (next > 0x7fffffff) return (int)cudaErrorInvalidValue;
  }
  Tab tab;
  tab.op = op;
  tab.navg = navg;
  tab.divide = divide;
  cudaStream_t s = (cudaStream_t)stream;
  for (int first = 0; first < n_rows; first += Tab::kCap) {
    const int m = n_rows - first < Tab::kCap ? n_rows - first : Tab::kCap;
    const int64_t* src = rows + (int64_t)first * kW;
    for (int j = 0; j < m; ++j, src += kW) {
      Row<Op>& d = tab.rows[j];
      for (int k = 0; k < Op::kIn; ++k)
        d.in[k] = reinterpret_cast<const void*>(src[k]);
      for (int k = 0; k < Op::kOut; ++k)
        d.out[k] = reinterpret_cast<void*>(src[Op::kIn + k]);
      d.n = src[kW - 2];
      d.chunk0 = src[kW - 1];
    }
    tab.n_rows = m;
    const Row<Op>& last = tab.rows[m - 1];
    const unsigned blocks =
        (unsigned)(last.chunk0 + (last.n + kChunk - 1) / kChunk);
    if (dtype == 0)
      multi_kernel<float, Op><<<blocks, kThreads, 0, s>>>(tab);
    else
      multi_kernel<__nv_bfloat16, Op><<<blocks, kThreads, 0, s>>>(tab);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// Rows one launch of the multi-leaf kernel takes: kind 0 = SGD, 1 =
// momentum, 2 = Adam.
int hvd_multi_capacity(int kind) {
  switch (kind) {
    case 0:
      return Table<SgdOp>::kCap;
    case 1:
      return Table<MomentumOp>::kCap;
    case 2:
      return Table<AdamOp>::kCap;
    default:
      return -1;
  }
}

int hvd_sgd(int dtype, const void* g, void* u, int64_t n, int divide,
            float navg, float neg_lr, void* stream) {
  const void* p[] = {g, u};
  return launch_one(dtype, p, n, divide, navg, SgdOp{neg_lr}, stream);
}

int hvd_momentum(int dtype, const void* g, const void* t, void* u,
                 void* t_out, int64_t n, int divide, float navg,
                 float decay, float neg_lr, void* stream) {
  const void* p[] = {g, t, u, t_out};
  return launch_one(dtype, p, n, divide, navg, MomentumOp{decay, neg_lr},
                    stream);
}

int hvd_adam(int dtype, const void* g, const void* mu, const void* nu,
             void* u, void* mu_out, void* nu_out, int64_t n, int divide,
             float navg, float c1, float b1, float c2, float b2, float bc1,
             float bc2, float eps_root, float eps, float neg_lr,
             void* stream) {
  const void* p[] = {g, mu, nu, u, mu_out, nu_out};
  return launch_one(dtype, p, n, divide, navg,
                    AdamOp{c1, b1, c2, b2, bc1, bc2, eps_root, eps, neg_lr},
                    stream);
}

// The multi-leaf entries: `rows` is a host array of n_rows rows (g, u,
// n, first chunk for SGD; g, t, u, t', n, first chunk for momentum; g,
// mu, nu, u, mu', nu', n, first chunk for Adam), `chunk` must be 4096.
int hvd_sgd_multi(int dtype, const int64_t* rows, int n_rows, int chunk,
                  int divide, float navg, float neg_lr, void* stream) {
  return launch_multi(dtype, rows, n_rows, chunk, divide, navg,
                      SgdOp{neg_lr}, stream);
}

int hvd_momentum_multi(int dtype, const int64_t* rows, int n_rows,
                       int chunk, int divide, float navg, float decay,
                       float neg_lr, void* stream) {
  return launch_multi(dtype, rows, n_rows, chunk, divide, navg,
                      MomentumOp{decay, neg_lr}, stream);
}

int hvd_adam_multi(int dtype, const int64_t* rows, int n_rows, int chunk,
                   int divide, float navg, float c1, float b1, float c2,
                   float b2, float bc1, float bc2, float eps_root, float eps,
                   float neg_lr, void* stream) {
  return launch_multi(
      dtype, rows, n_rows, chunk, divide, navg,
      AdamOp{c1, b1, c2, b2, bc1, bc2, eps_root, eps, neg_lr}, stream);
}

}  // extern "C"

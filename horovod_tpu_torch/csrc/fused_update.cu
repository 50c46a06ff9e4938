// Fused optimizer tail for Hopper (sm_90a): kernels B1-B3 of the port.
//
// Replaces the Pallas kernels of horovod_tpu/optim/fused_update.py:
//   hvd_momentum  <- _momentum_pallas (:314) / _momentum_kernel (:265)
//   hvd_sgd       <- _sgd_pallas      (:299) / _sgd_kernel      (:260)
//   hvd_adam      <- _adam_pallas     (:331) / _adam_kernel     (:273)
//
// Contract: bit-exact against optax's expressions in their order
// (fused_update.py:208-232).  Every float operation is written as an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), which nvcc never contracts into an FMA: `g + decay * t`
// as one FMA would differ from optax by an ulp.  For bfloat16 the value
// is rounded to bf16 after every operation, as JAX's per-op semantics
// round; the constants arrive already rounded to the working dtype.
//
// Bound: each is a single elementwise pass, so device-memory bandwidth
// bounds it.  Momentum moves 16 B per f32 element (reads g and t, writes
// u and t'): about 409 MB for the 25,557,032 parameters of ResNet-50,
// some 0.12 ms at the H100 SXM's 3.35 TB/s.  SGD moves 8 B per element,
// Adam 24 B (reads g, mu, nu; writes u, mu', nu').  What the design does
// about it: each element is read and written exactly once, with no
// padding (the Pallas (16, 128) row tile
// is a TPU layout detail and is not carried over) and no intermediate
// in device memory; consecutive threads touch consecutive elements so
// every warp access is coalesced, and a grid-stride loop with a masked
// tail covers any length.  Launched once per leaf, as the stage-0 path
// launches B1 and B3, the small leaves are launch-bound: 161 launches of
// some 18 us of host time each for ResNet-50.  So B2 also has one launch
// for a whole list of leaves of one dtype (hvd_sgd_multi): each block
// takes one fixed-size chunk of one leaf and finds its leaf by a
// binary search of a table of (g, u, n, first chunk), which the caller
// builds on the host and copies to the card; empty leaves are left out
// of the table.  The per-element arithmetic is sgd_kernel's, so the
// result is bit for bit the per-leaf one.
//
// Interface: plain C, one entry per kernel, loaded with ctypes.  dtype
// 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after the
// launch on the caller's stream; nothing is allocated and nothing is
// synchronised.  t/t_out (mu/mu_out, nu/nu_out) may alias: each element
// is read before it is written by the same thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

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
__device__ __forceinline__ float prep(const T* g, int64_t i, int divide,
                                      float navg) {
  float x = Io<T>::load(g, i);
  return divide ? div<T>(x, navg) : x;
}

template <typename T>
__global__ void sgd_kernel(const T* g, T* u, int64_t n, int divide,
                           float navg, float neg_lr) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float x = prep<T>(g, i, divide, navg);
    Io<T>::store(u, i, mul<T>(neg_lr, x));
  }
}

// One entry of hvd_sgd_multi's leaf table (four int64 values).
struct Leaf {
  const void* g;
  void* u;
  int64_t n;       // elements, > 0
  int64_t chunk0;  // the leaf's first chunk, in launch order
};

template <typename T>
__global__ void sgd_multi_kernel(const Leaf* __restrict__ leaves,
                                 int n_leaves, int chunk, int divide,
                                 float navg, float neg_lr) {
  // the leaf of this block's chunk: the last whose first chunk is <= it
  const int64_t b = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf leaf = leaves[lo];
  const T* g = static_cast<const T*>(leaf.g);
  T* u = static_cast<T*>(leaf.u);
  const int64_t begin = (b - leaf.chunk0) * chunk;
  const int64_t end = begin + chunk < leaf.n ? begin + chunk : leaf.n;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    float x = prep<T>(g, i, divide, navg);
    Io<T>::store(u, i, mul<T>(neg_lr, x));
  }
}

template <typename T>
__global__ void momentum_kernel(const T* g, const T* t, T* u, T* t_out,
                                int64_t n, int divide, float navg,
                                float decay, float neg_lr) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float x = prep<T>(g, i, divide, navg);
    // optax.trace: g + decay * t; optax.scale: (-lr) * t'
    float t2 = add<T>(x, mul<T>(decay, Io<T>::load(t, i)));
    Io<T>::store(t_out, i, t2);
    Io<T>::store(u, i, mul<T>(neg_lr, t2));
  }
}

struct AdamConsts {
  float c1, b1, c2, b2, bc1, bc2, eps_root, eps, neg_lr;
};

template <typename T>
__global__ void adam_kernel(const T* g, const T* mu, const T* nu, T* u,
                            T* mu_out, T* nu_out, int64_t n, int divide,
                            float navg, AdamConsts k) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float x = prep<T>(g, i, divide, navg);
    // mu2 = (1 - b1) * g + b1 * mu
    float mu2 = add<T>(mul<T>(k.c1, x), mul<T>(k.b1, Io<T>::load(mu, i)));
    // nu2 = (1 - b2) * (g * g) + b2 * nu
    float nu2 = add<T>(mul<T>(k.c2, mul<T>(x, x)),
                       mul<T>(k.b2, Io<T>::load(nu, i)));
    float mu_hat = div<T>(mu2, k.bc1);
    float nu_hat = div<T>(nu2, k.bc2);
    // (-lr) * (mu_hat / (sqrt(nu_hat + eps_root) + eps))
    float den = add<T>(sqrt_<T>(add<T>(nu_hat, k.eps_root)), k.eps);
    Io<T>::store(mu_out, i, mu2);
    Io<T>::store(nu_out, i, nu2);
    Io<T>::store(u, i, mul<T>(k.neg_lr, div<T>(mu_hat, den)));
  }
}

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

int hvd_sgd(int dtype, const void* g, void* u, int64_t n, int divide,
            float navg, float neg_lr, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    sgd_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)g, (float*)u, n, divide, navg, neg_lr);
  } else if (dtype == 1) {
    sgd_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        (const __nv_bfloat16*)g, (__nv_bfloat16*)u, n, divide, navg,
        neg_lr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B2 over n_leaves leaves in one launch of n_chunks blocks, each taking
// `chunk` elements: `leaves` is a device array of Leaf (the int64
// quadruples g, u, n, first chunk), sorted by first chunk, the first at
// chunk 0, every n > 0.
int hvd_sgd_multi(int dtype, const void* leaves, int n_leaves,
                  int64_t n_chunks, int chunk, int divide, float navg,
                  float neg_lr, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffff || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Leaf* t = (const Leaf*)leaves;
  if (dtype == 0) {
    sgd_multi_kernel<float><<<(unsigned)n_chunks, kThreads, 0, s>>>(
        t, n_leaves, chunk, divide, navg, neg_lr);
  } else if (dtype == 1) {
    sgd_multi_kernel<__nv_bfloat16><<<(unsigned)n_chunks, kThreads, 0, s>>>(
        t, n_leaves, chunk, divide, navg, neg_lr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int hvd_momentum(int dtype, const void* g, const void* t, void* u,
                 void* t_out, int64_t n, int divide, float navg,
                 float decay, float neg_lr, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    momentum_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)g, (const float*)t, (float*)u, (float*)t_out, n,
        divide, navg, decay, neg_lr);
  } else if (dtype == 1) {
    momentum_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)t,
        (__nv_bfloat16*)u, (__nv_bfloat16*)t_out, n, divide, navg, decay,
        neg_lr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int hvd_adam(int dtype, const void* g, const void* mu, const void* nu,
             void* u, void* mu_out, void* nu_out, int64_t n, int divide,
             float navg, float c1, float b1, float c2, float b2, float bc1,
             float bc2, float eps_root, float eps, float neg_lr,
             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  AdamConsts k{c1, b1, c2, b2, bc1, bc2, eps_root, eps, neg_lr};
  if (dtype == 0) {
    adam_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)g, (const float*)mu, (const float*)nu, (float*)u,
        (float*)mu_out, (float*)nu_out, n, divide, navg, k);
  } else if (dtype == 1) {
    adam_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)mu,
        (const __nv_bfloat16*)nu, (__nv_bfloat16*)u,
        (__nv_bfloat16*)mu_out, (__nv_bfloat16*)nu_out, n, divide, navg,
        k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

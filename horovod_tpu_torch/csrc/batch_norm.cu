// BatchNorm kernels for Hopper (sm_90a): kernels N1-N4 of the port.
//
// No Pallas kernel stands behind these: they replace flax.linen.BatchNorm
// as XLA fuses it in the JAX package (horovod_tpu/models/resnet.py:83-84,
// horovod_tpu/models/inception.py:33-34), where the port's plain version
// (ops/batch_norm.py) runs each step of the formula as a separate float32
// pass over the activation.
//
//   N1 hvd_bn_stats       mean = sum(x)/M, ex2 = sum(x^2)/M,
//                         var = max(ex2 - mean^2, 0), rstd = rsqrt(var + eps)
//                         per channel, and (optionally) the running
//                         statistics ra = m*ra + (1 - m)*stat in place
//   N2 hvd_bn_normalize   y = (x - mean) * (rstd * scale) + bias
//   N3 hvd_bn_bwd_reduce  dbias = sum(dy), dscale = sum(dy * xhat),
//                         xhat = (x - mean) * rstd recomputed from x
//   N4 hvd_bn_bwd_dx      dx = (scale*rstd / M) * (M*dy - dbias - xhat*dscale)
//
// x, dy, y and dx are (M, C) row-major (the NHWC activation, M = N*H*W)
// in float32 or bfloat16; every per-channel vector is float32 (C).
//
// Contract against the plain versions in ops/batch_norm.py:
//   N2 and N4 round every float32 operation as the plain version does
//   (explicit round-to-nearest intrinsics, so nvcc cannot contract them;
//   the plain N4 divides by M as a true division), then cast to x's dtype
//   with round-to-nearest-even: bit for bit on the same inputs.
//   N1 and N3 sum in another order than PyTorch: each thread sums a
//   strided run of rows of one row tile in float32, the block adds its
//   threads' sums in a fixed tree, and one finalize adds the tiles'
//   partial sums per channel in float64 and rounds once.  So they agree
//   with the plain version to float32 rounding, not bit for bit.  The
//   variance keeps flax's fast form E[x^2] - E[x]^2 in float32, as the
//   plain version evaluates it: mean and E[x^2] rounded to float32, their
//   difference rounded and clamped at 0.  Where |mean| >> std that
//   difference cancels to the rounding of E[x^2] (a few float32 ulps of
//   it), in the kernel as in the plain version, and the two disagree
//   there by that noise.  rstd is 1/sqrt(var + eps) in float64 from the
//   float32 var + eps, rounded once.  The running statistics use the
//   plain version's float32 constants and roundings.
//   No float atomics anywhere: the same input gives the same bits.
//
// Bound: device-memory bandwidth.  N1 reads x once (2 or 4 B/element),
// N2 reads x and writes y, N3 reads x and dy, N4 reads x and dy and
// writes dx; per-channel vectors and the partial sums are noise (a few
// hundred KB).  At ResNet-50's largest BatchNorm, (256*112*112, 64)
// bf16, N1 moves 411 MB: 0.123 ms at the H100 SXM's 3.35 TB/s.
// What the design does about it: a block covers a tile of rows and a
// chunk of up to 32 16-byte column vectors (8 bf16 or 4 float32
// channels each); its threads walk the tile's rows with 16-byte loads,
// neighbouring threads on neighbouring addresses, so every row segment
// is read coalesced exactly once; each thread holds its channels'
// per-channel values (mean, rstd, scale, bias) in registers for the
// whole tile.  About 1,056 blocks (8 per SM) keep enough loads in
// flight.  A C that is not a multiple of the vector width, or an
// operand off the 16-byte grid, takes the scalar loop (vector width 1).
//
// Interface: plain C, loaded with ctypes.  hvd_bn_partials gives the
// number of row tiles the reductions write partial sums for, so the
// caller can size their float32 scratch (2 * tiles * C).  Each launch
// entry returns cudaGetLastError() after its launches on the caller's
// stream; nothing is allocated and nothing is synchronised.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxColsPerBlock = 32;   // 16-byte column vectors
constexpr int kTargetBlocks = 132 * 8;
constexpr int kFinChannels = 32;       // finalize: channels per block
constexpr int kFinLanes = 8;           // finalize: partial lanes

struct Grid {
  int64_t m;      // rows
  int c;          // channels
  int cv;         // column vectors per row, c / V
  int cw;         // column vectors per block
  int rl;         // row lanes per block, kThreads / cw
  int64_t rpb;    // rows per block (one row tile)
  int gx;         // row tiles
  int gy;         // column chunks
};

Grid make_grid(int64_t m, int c, int vec) {
  Grid g;
  g.m = m;
  g.c = c;
  g.cv = c / vec;
  g.gy = (g.cv + kMaxColsPerBlock - 1) / kMaxColsPerBlock;
  g.cw = (g.cv + g.gy - 1) / g.gy;
  g.rl = kThreads / g.cw;
  int64_t gx = (m + g.rl - 1) / g.rl;
  int64_t cap = kTargetBlocks / g.gy;
  if (cap < 1) cap = 1;
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  g.rpb = (m + gx - 1) / gx;
  g.gx = (int)((m + g.rpb - 1) / g.rpb);
  return g;
}

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p,
                                        const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// The thread's place in its block: column vector `col` (global) and row
// lane `ty`; `active` is false for the threads past the last row lane
// or past the last column vector of the chunk.
#define BN_THREAD(g)                                                    \
  const int tx = threadIdx.x % (g).cw;                                  \
  const int ty = threadIdx.x / (g).cw;                                  \
  const int col = blockIdx.y * (g).cw + tx;                             \
  const bool active = ty < (g).rl && col < (g).cv;                      \
  const int64_t r0 = (int64_t)blockIdx.x * (g).rpb;                     \
  const int64_t r1 = r0 + (g).rpb < (g).m ? r0 + (g).rpb : (g).m;

// N1 (kBwd false) and N3 (kBwd true), first level: one row tile's float32
// sums per channel into part_a / part_b[blockIdx.x][channel].
template <typename T, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    reduce_tiles(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd, float* __restrict__ part_a,
                 float* __restrict__ part_b, Grid g) {
  __shared__ float sa[kThreads * V];
  __shared__ float sb[kThreads * V];
  BN_THREAD(g)
  float a[V], b[V], mu[V], rs[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = 0.0f;
    b[i] = 0.0f;
    mu[i] = 0.0f;
    rs[i] = 0.0f;
  }
  if (active) {
    if constexpr (kBwd) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        mu[i] = mean[col * V + i];
        rs[i] = rstd[col * V + i];
      }
    }
#pragma unroll 4
    for (int64_t r = r0 + ty; r < r1; r += g.rl) {
      float xv[V];
      load_v<V>(x + r * g.c + (int64_t)col * V, xv);
      if constexpr (kBwd) {
        float dv[V];
        load_v<V>(dy + r * g.c + (int64_t)col * V, dv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
          a[i] = __fadd_rn(a[i], dv[i]);
          b[i] = __fadd_rn(b[i], __fmul_rn(dv[i], xh));
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          a[i] = __fadd_rn(a[i], xv[i]);
          b[i] = __fadd_rn(b[i], __fmul_rn(xv[i], xv[i]));
        }
      }
    }
  }
  // add the row lanes' sums in a fixed tree: lane ty takes ty + s
  const int slot = threadIdx.x * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sa[slot + i] = a[i];
    sb[slot + i] = b[i];
  }
  __syncthreads();
  int half = 1;
  while (half * 2 < g.rl) half *= 2;
  for (int s = half; s > 0; s >>= 1) {
    if (ty < s && ty + s < g.rl) {
      const int other = slot + s * g.cw * V;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sa[slot + i] = __fadd_rn(sa[slot + i], sa[other + i]);
        sb[slot + i] = __fadd_rn(sb[slot + i], sb[other + i]);
      }
    }
    __syncthreads();
  }
  if (ty == 0 && col < g.cv) {
    float* pa = part_a + (int64_t)blockIdx.x * g.c + (int64_t)col * V;
    float* pb = part_b + (int64_t)blockIdx.x * g.c + (int64_t)col * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      pa[i] = sa[slot + i];
      pb[i] = sb[slot + i];
    }
  }
}

// Second level: per channel, the tiles' partial sums added in float64 in
// a fixed order (lane l takes tiles l, l + kFinLanes, ...; lane 0 adds
// the lanes in order), then the statistics (N1) or the sums (N3).
template <bool kBwd>
__global__ void __launch_bounds__(kFinChannels * kFinLanes)
    finalize(const float* __restrict__ part_a,
             const float* __restrict__ part_b, int parts, int c, int64_t m,
             float eps, float mom, float one_minus_mom,
             float* __restrict__ out_a, float* __restrict__ out_b,
             float* __restrict__ out_rstd, float* __restrict__ ra_mean,
             float* __restrict__ ra_var) {
  __shared__ double sa[kFinLanes][kFinChannels];
  __shared__ double sb[kFinLanes][kFinChannels];
  const int tx = threadIdx.x, lane = threadIdx.y;
  const int ch = blockIdx.x * kFinChannels + tx;
  double a = 0.0, b = 0.0;
  if (ch < c) {
    for (int p = lane; p < parts; p += kFinLanes) {
      a += (double)part_a[(int64_t)p * c + ch];
      b += (double)part_b[(int64_t)p * c + ch];
    }
  }
  sa[lane][tx] = a;
  sb[lane][tx] = b;
  __syncthreads();
  if (lane != 0 || ch >= c) return;
  a = 0.0;
  b = 0.0;
#pragma unroll
  for (int l = 0; l < kFinLanes; ++l) {
    a += sa[l][tx];
    b += sb[l][tx];
  }
  if constexpr (kBwd) {
    out_a[ch] = (float)a;  // dbias
    out_b[ch] = (float)b;  // dscale
  } else {
    // the contract's float32 fast variance: mean and E[x^2] rounded to
    // float32 once, then the difference and the clamp in float32 (NaN
    // passes the clamp, as in torch.clamp_min)
    const float mean = (float)(a / (double)m);
    const float ex2 = (float)(b / (double)m);
    const float d = __fsub_rn(ex2, __fmul_rn(mean, mean));
    const float var = d < 0.0f ? 0.0f : d;
    const float rstd =
        (float)(1.0 / sqrt((double)__fadd_rn(var, eps)));
    out_a[ch] = mean;
    out_b[ch] = var;
    out_rstd[ch] = rstd;
    if (ra_mean != nullptr) {
      ra_mean[ch] = __fadd_rn(__fmul_rn(mom, ra_mean[ch]),
                              __fmul_rn(one_minus_mom, mean));
      ra_var[ch] = __fadd_rn(__fmul_rn(mom, ra_var[ch]),
                             __fmul_rn(one_minus_mom, var));
    }
  }
}

// N2: y = (x - mean) * (rstd * scale) + bias.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    normalize(const T* __restrict__ x, const float* __restrict__ mean,
              const float* __restrict__ rstd,
              const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, Grid g) {
  BN_THREAD(g)
  if (!active) return;
  float mu[V], mul[V], bi[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = col * V + i;
    mu[i] = mean[ch];
    mul[i] = __fmul_rn(rstd[ch], scale[ch]);
    bi[i] = bias[ch];
  }
#pragma unroll 4
  for (int64_t r = r0 + ty; r < r1; r += g.rl) {
    const int64_t off = r * g.c + (int64_t)col * V;
    float v[V];
    load_v<V>(x + off, v);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mu[i]), mul[i]), bi[i]);
    store_v<V>(y + off, v);
  }
}

// N4: dx = (scale * rstd / M) * (M * dy - dbias - xhat * dscale).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bwd_dx(const T* __restrict__ dy, const T* __restrict__ x,
           const float* __restrict__ mean, const float* __restrict__ rstd,
           const float* __restrict__ scale, const float* __restrict__ dbias,
           const float* __restrict__ dscale, T* __restrict__ dx, Grid g) {
  BN_THREAD(g)
  if (!active) return;
  const float mf = (float)g.m;
  float mu[V], rs[V], k[V], db[V], ds[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = col * V + i;
    mu[i] = mean[ch];
    rs[i] = rstd[ch];
    k[i] = __fdiv_rn(__fmul_rn(scale[ch], rs[i]), mf);
    db[i] = dbias[ch];
    ds[i] = dscale[ch];
  }
#pragma unroll 4
  for (int64_t r = r0 + ty; r < r1; r += g.rl) {
    const int64_t off = r * g.c + (int64_t)col * V;
    float xv[V], dv[V];
    load_v<V>(x + off, xv);
    load_v<V>(dy + off, dv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
      const float t = __fsub_rn(__fsub_rn(__fmul_rn(mf, dv[i]), db[i]),
                                __fmul_rn(xh, ds[i]));
      dv[i] = __fmul_rn(k[i], t);
    }
    store_v<V>(dx + off, dv);
  }
}

template <typename T, int V, bool kBwd>
int reduce_launch(const void* x, const void* dy, const float* mean_in,
                  const float* rstd_in, int64_t m, int c, float* part,
                  float eps, float mom, float omm, float* out_a,
                  float* out_b, float* out_rstd, float* ra_mean,
                  float* ra_var, cudaStream_t st) {
  const Grid g = make_grid(m, c, V);
  float* part_a = part;
  float* part_b = part + (int64_t)g.gx * c;
  reduce_tiles<T, V, kBwd><<<dim3(g.gx, g.gy), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean_in, rstd_in,
      part_a, part_b, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize<kBwd><<<(c + kFinChannels - 1) / kFinChannels,
                   dim3(kFinChannels, kFinLanes), 0, st>>>(
      part_a, part_b, g.gx, c, m, eps, mom, omm, out_a, out_b, out_rstd,
      ra_mean, ra_var);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int normalize_launch(const void* x, const float* mean, const float* rstd,
                     const float* scale, const float* bias, void* y,
                     int64_t m, int c, cudaStream_t st) {
  const Grid g = make_grid(m, c, V);
  normalize<T, V><<<dim3(g.gx, g.gy), kThreads, 0, st>>>(
      static_cast<const T*>(x), mean, rstd, scale, bias, static_cast<T*>(y),
      g);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int dx_launch(const void* dy, const void* x, const float* mean,
              const float* rstd, const float* scale, const float* dbias,
              const float* dscale, void* dx, int64_t m, int c,
              cudaStream_t st) {
  const Grid g = make_grid(m, c, V);
  bwd_dx<T, V><<<dim3(g.gx, g.gy), kThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), mean, rstd, scale,
      dbias, dscale, static_cast<T*>(dx), g);
  return (int)cudaGetLastError();
}

// dtype 0 is float32 (vector width 4 or 1), 1 is bfloat16 (8 or 1).
#define BN_DISPATCH(dtype, vec, FN, ...)                                  \
  if ((dtype) == 0 && (vec) == 4) return FN<float, 4>(__VA_ARGS__);       \
  if ((dtype) == 0 && (vec) == 1) return FN<float, 1>(__VA_ARGS__);       \
  if ((dtype) == 1 && (vec) == 8) return FN<__nv_bfloat16, 8>(__VA_ARGS__); \
  if ((dtype) == 1 && (vec) == 1) return FN<__nv_bfloat16, 1>(__VA_ARGS__); \
  return (int)cudaErrorInvalidValue;

template <typename T, int V>
int stats_launch(const void* x, int64_t m, int c, float* part, float eps,
                 float mom, float omm, float* mean, float* var, float* rstd,
                 float* ra_mean, float* ra_var, cudaStream_t st) {
  return reduce_launch<T, V, false>(x, nullptr, nullptr, nullptr, m, c, part,
                                    eps, mom, omm, mean, var, rstd, ra_mean,
                                    ra_var, st);
}

template <typename T, int V>
int bwd_reduce_launch(const void* dy, const void* x, const float* mean,
                      const float* rstd, int64_t m, int c, float* part,
                      float* dbias, float* dscale, cudaStream_t st) {
  return reduce_launch<T, V, true>(x, dy, mean, rstd, m, c, part, 0.0f, 0.0f,
                                   0.0f, dbias, dscale, nullptr, nullptr,
                                   nullptr, st);
}

}  // namespace

extern "C" {

// Row tiles of the reductions at (m, c) and vector width `vec`: the
// scratch of N1 and N3 holds 2 * tiles * c floats.
int64_t hvd_bn_partials(int64_t m, int c, int vec) {
  return make_grid(m, c, vec).gx;
}

// N1.  ra_mean / ra_var may be null (no running statistics to update).
int hvd_bn_stats(int dtype, int vec, const void* x, int64_t m, int c,
                 float* part, float eps, float mom, float one_minus_mom,
                 float* mean, float* var, float* rstd, float* ra_mean,
                 float* ra_var, void* stream) {
  BN_DISPATCH(dtype, vec, stats_launch, x, m, c, part, eps, mom,
              one_minus_mom, mean, var, rstd, ra_mean, ra_var,
              static_cast<cudaStream_t>(stream));
}

// N2.
int hvd_bn_normalize(int dtype, int vec, const void* x, const float* mean,
                     const float* rstd, const float* scale,
                     const float* bias, void* y, int64_t m, int c,
                     void* stream) {
  BN_DISPATCH(dtype, vec, normalize_launch, x, mean, rstd, scale, bias, y,
              m, c, static_cast<cudaStream_t>(stream));
}

// N3.
int hvd_bn_bwd_reduce(int dtype, int vec, const void* dy, const void* x,
                      const float* mean, const float* rstd, int64_t m, int c,
                      float* part, float* dbias, float* dscale,
                      void* stream) {
  BN_DISPATCH(dtype, vec, bwd_reduce_launch, dy, x, mean, rstd, m, c, part,
              dbias, dscale, static_cast<cudaStream_t>(stream));
}

// N4.
int hvd_bn_bwd_dx(int dtype, int vec, const void* dy, const void* x,
                  const float* mean, const float* rstd, const float* scale,
                  const float* dbias, const float* dscale, void* dx,
                  int64_t m, int c, void* stream) {
  BN_DISPATCH(dtype, vec, dx_launch, dy, x, mean, rstd, scale, dbias, dscale,
              dx, m, c, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

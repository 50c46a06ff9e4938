// Flash attention for Hopper (sm_90a): kernels B8-B10 of the port.
//
// Replaces the Pallas kernels of horovod_tpu/ops/pallas_attention.py:
//   hvd_flash_fwd     <- _flash_block_step_impl (:94) / _flash_step_kernel
//                        (:39): one online-softmax step with (m, l, o)
//                        carried in and out
//   hvd_flash_bwd_dq  <- flash_bwd_dq  (:256) / _flash_bwd_dq_kernel  (:149)
//   hvd_flash_bwd_dkv <- flash_bwd_dkv (:301) / _flash_bwd_dkv_kernel (:197)
//
// Arithmetic follows the Pallas kernel bodies: scores are accumulated in
// f32 from the operands (a product of two bf16 values is exact in f32),
// s = dot * scale with scale = float32(1/sqrt(d)); the causal mask comes
// from global positions q_offset + i >= k_offset + j; fully masked rows
// are guarded as the TPU kernel guards them (m_safe, isfinite(s), alpha =
// 0 for m_prev = -inf, p = 0 where lse = -inf).  p is rounded to the
// value dtype before p.V, p to dO's dtype before p^T.dO and ds to the
// K/Q dtype before ds.K and ds^T.Q; sums of p stay f32.  Only the order
// of the sums differs from the plain PyTorch versions.  expf and logf,
// no fast-math intrinsics.
//
// Design.  The TPU carried the softmax state across a sequential grid
// axis in VMEM scratch; here that axis is a loop inside one thread
// block, so nothing carries between blocks and there are no atomics:
// the results are deterministic.  B8 and B9 run one block per (bh,
// 64-row Q tile) looping over 64-row K/V tiles; B10 runs one block per
// (bh, 64-row K tile) looping over Q tiles.  Tiles are staged in shared
// memory as f32 (rows padded by one word, so a column walk hits 32
// banks); each of the 256 threads owns a 4x4 micro-tile of the 64x64
// score tile and a 4-row strip of the output accumulator, so a row's
// max and sum are reduced by shuffles among 16 lanes of one warp.  Tiles
// that the causal mask hides entirely are skipped: for such a tile the
// TPU step leaves (m, l, o) unchanged (rows with m = -inf have their l
// and o multiplied by alpha = 0 once, at load).  Ragged edges are masked
// here, so any L works; the TPU's packed m|l lane tile and block-size
// fallback are layout details that are not carried over.
//
// Bound.  At the transformer path's shape (BH 192, L 1024, D 64, bf16,
// causal) B8 must read q, k, v and the carried f32 (m, l, o) and write
// (m, l, o): about 0.18 GB, some 0.05 ms at 3.35 TB/s, against 26 GFLOP
// of causal score and p.V products (0.03 ms at the 989 TFLOP/s bf16
// tensor-core peak).  B9 and B10 are bound the same way.  This first
// version multiplies with FMAs on the CUDA cores (67 TFLOP/s f32 peak),
// so the products, not the bytes, bound it; mma/wgmma tiles and TMA
// loads are the next step.
//
// Interface: plain C, one entry per kernel, loaded with ctypes.  dtype
// 0 = float32, 1 = bfloat16 (q, k, v, do); m, l, o, lse, delta and every
// output are f32.  All tensors are contiguous (BH, L[, D]).  Each entry
// returns cudaGetLastError() after the launch on the caller's stream;
// nothing is allocated and nothing is synchronised.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kMaxD = 128;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p, size_t i) {
    return p[i];
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p,
                                               size_t i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float neg_inf() { return -INFINITY; }

// Reductions over the 16 lanes of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [row0, row0 + 64) of a (L, D) matrix into shared memory as
// f32 with row stride D + 1; rows past L are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int L, int D) {
  const int sd = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * sd + c] =
        row0 + r < L ? Io<T>::load(src, (size_t)(row0 + r) * D + c) : 0.f;
  }
}

// A 4x4 micro-tile of products over D: acc[i][j] = A[ra+i].B[cb+16j]
// (A, B staged tiles).
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int ra, int cb, int D,
                                         float (&acc)[4][4]) {
  const int sd = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + i) * sd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(cb + 16 * j) * sd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Two such micro-tiles in one pass: acc = A.B^T and acc2 = A2.B2^T.
__device__ __forceinline__ void dot_tiles(const float* A, const float* B,
                                          const float* A2, const float* B2,
                                          int ra, int cb, int D,
                                          float (&acc)[4][4],
                                          float (&acc2)[4][4]) {
  const int sd = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4], a2[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ra + i) * sd + d];
      a2[i] = A2[(ra + i) * sd + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[(cb + 16 * j) * sd + d];
      b2[j] = B2[(cb + 16 * j) * sd + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        acc2[i][j] = fmaf(a2[i], b2[j], acc2[i][j]);
      }
  }
}

// B8: grid (ceil(Lq/64), BH).  NJ = ceil(D/16) output columns per thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* m_in,
                     const float* l_in, const float* o_in, float* m_out,
                     float* l_out, float* o_out, int Lq, int Lk, int D,
                     int q_offset, int k_offset, int causal, float scale) {
  extern __shared__ float smem[];
  const int sd = D + 1;
  float* Qs = smem;
  float* Ks = Qs + kBQ * sd;
  float* Vs = Ks + kBK * sd;
  float* Ps = Vs + kBK * sd;  // kBQ x (kBK + 1)
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int ra = (threadIdx.x >> 4) * 4;  // first of the thread's 4 rows
  const int cg = threadIdx.x & 15;
  const T* qb = q + (size_t)bh * Lq * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;

  load_tile(Qs, qb, q0, Lq, D);
  float m[4], l[4], o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ra + i;
    const size_t row = (size_t)bh * Lq + r;
    m[i] = r < Lq ? m_in[row] : neg_inf();
    l[i] = r < Lq ? l_in[row] : 0.f;
    // a row with m = -inf gets alpha = 0 at the first tile the TPU step
    // visits; applying it here makes skipped (fully masked) tiles exact
    const float keep = isfinite(m[i]) ? 1.f : 0.f;
    l[i] *= keep;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cg + 16 * j;
      o[i][j] = (r < Lq && c < D) ? o_in[row * D + c] * keep : 0.f;
    }
  }

  int kt_end = (Lk + kBK - 1) / kBK;
  if (causal) {
    // keys at index <= lim are visible to some row of this tile
    const long long lim = (long long)q_offset + min(q0 + kBQ, Lq) - 1 -
                          (long long)k_offset;
    kt_end = lim < 0 ? 0 : min((long long)kt_end, lim / kBK + 1);
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile(Ks, kb, k0, Lk, D);
    load_tile(Vs, vb, k0, Lk, D);
    __syncthreads();
    float s[4][4];
    dot_tile(Qs, Ks, ra, cg, D, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ra + i;
      float mc = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + cg + 16 * j;
        const bool ok = kk < Lk && (!causal || qpos >= k_offset + kk);
        s[i][j] = ok ? s[i][j] * scale : neg_inf();
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mc));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - m_safe) : 0.f;
        psum += p;
        Ps[(ra + i) * (kBK + 1) + cg + 16 * j] = Io<T>::round(p);
      }
      l[i] = l[i] * alpha + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    const int kn = min(kBK, Lk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ra + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 16 * j;
        const float vv = c < D ? Vs[kk * sd + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(p[i], vv, o[i][j]);
      }
    }
  }
  __syncthreads();  // every lane has read m_in before any lane writes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ra + i;
    if (r >= Lq) continue;
    const size_t row = (size_t)bh * Lq + r;
    if (cg == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cg + 16 * j;
      if (c < D) o_out[row * D + c] = o[i][j];
    }
  }
}

// p = exp(s - lse) for one score, with the TPU kernels' guards.
__device__ __forceinline__ float softmax_p(float s, float lse) {
  const bool lse_ok = isfinite(lse);
  return (isfinite(s) && lse_ok) ? expf(s - (lse_ok ? lse : 0.f)) : 0.f;
}

// B9: grid (ceil(Lq/64), BH).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* dq, int Lq,
                        int Lk, int D, int q_offset, int k_offset,
                        int causal, float scale) {
  extern __shared__ float smem[];
  const int sd = D + 1;
  float* Qs = smem;
  float* dOs = Qs + kBQ * sd;
  float* Ks = dOs + kBQ * sd;
  float* Vs = Ks + kBK * sd;
  float* dSs = Vs + kBK * sd;  // kBQ x (kBK + 1)
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int ra = (threadIdx.x >> 4) * 4;
  const int cg = threadIdx.x & 15;
  const size_t qbase = (size_t)bh * Lq;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;

  load_tile(Qs, q + qbase * D, q0, Lq, D);
  load_tile(dOs, dout + qbase * D, q0, Lq, D);
  float lse_r[4], delta_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ra + i;
    lse_r[i] = r < Lq ? lse[qbase + r] : neg_inf();
    delta_r[i] = r < Lq ? delta[qbase + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int kt_end = (Lk + kBK - 1) / kBK;
  if (causal) {
    const long long lim = (long long)q_offset + min(q0 + kBQ, Lq) - 1 -
                          (long long)k_offset;
    kt_end = lim < 0 ? 0 : min((long long)kt_end, lim / kBK + 1);
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile(Ks, kb, k0, Lk, D);
    load_tile(Vs, vb, k0, Lk, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tiles(Qs, Ks, dOs, Vs, ra, cg, D, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ra + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + cg + 16 * j;
        const bool ok = kk < Lk && (!causal || qpos >= k_offset + kk);
        const float p = softmax_p(ok ? s[i][j] * scale : neg_inf(), lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        dSs[(ra + i) * (kBK + 1) + cg + 16 * j] = Io<T>::round(ds);
      }
    }
    __syncthreads();
    const int kn = min(kBK, Lk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(ra + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 16 * j;
        const float kv = c < D ? Ks[kk * sd + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ra + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cg + 16 * j;
      if (c < D) dq[(qbase + r) * D + c] = acc[i][j];
    }
  }
}

// B10: grid (ceil(Lk/64), BH).  Tiles are computed transposed (rows are
// keys), so each thread's accumulator rows are its own keys.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* dk,
                         float* dv, int Lq, int Lk, int D, int q_offset,
                         int k_offset, int causal, float scale) {
  extern __shared__ float smem[];
  const int sd = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kBK * sd;
  float* Qs = Vs + kBK * sd;
  float* dOs = Qs + kBQ * sd;
  float* Pt = dOs + kBQ * sd;         // kBK x (kBQ + 1)
  float* dSt = Pt + kBK * (kBQ + 1);  // kBK x (kBQ + 1)
  float* lse_s = dSt + kBK * (kBQ + 1);
  float* delta_s = lse_s + kBQ;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int ra = (threadIdx.x >> 4) * 4;  // the thread's 4 key rows
  const int cg = threadIdx.x & 15;
  const size_t qbase = (size_t)bh * Lq;
  const size_t kbase = (size_t)bh * Lk;

  load_tile(Ks, k + kbase * D, k0, Lk, D);
  load_tile(Vs, v + kbase * D, k0, Lk, D);
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nqt = (Lq + kBQ - 1) / kBQ;
  int qt_begin = 0;
  if (causal) {
    // queries at index >= lim see some key of this tile
    const long long lim = (long long)k_offset + k0 - (long long)q_offset;
    qt_begin = lim <= 0 ? 0 : (int)min((long long)nqt, lim / kBQ);
  }
  for (int qt = qt_begin; qt < nqt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_tile(Qs, q + qbase * D, q0, Lq, D);
    load_tile(dOs, dout + qbase * D, q0, Lq, D);
    if (threadIdx.x < kBQ) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < Lq ? lse[qbase + r] : neg_inf();
      delta_s[threadIdx.x] = r < Lq ? delta[qbase + r] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    dot_tiles(Ks, Qs, Vs, dOs, ra, cg, D, st, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k_offset + k0 + ra + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qq = cg + 16 * j;
        const bool ok = q0 + qq < Lq && k0 + ra + i < Lk &&
                        (!causal || q_offset + q0 + qq >= kpos);
        const float p = softmax_p(ok ? st[i][j] * scale : neg_inf(),
                                  lse_s[qq]);
        const float ds = p * (dpt[i][j] - delta_s[qq]) * scale;
        Pt[(ra + i) * (kBQ + 1) + qq] = Io<T>::round(p);
        dSt[(ra + i) * (kBQ + 1) + qq] = Io<T>::round(ds);
      }
    }
    __syncthreads();
    const int qn = min(kBQ, Lq - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Pt[(ra + i) * (kBQ + 1) + qq];
        b[i] = dSt[(ra + i) * (kBQ + 1) + qq];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 16 * j;
        const float dov = c < D ? dOs[qq * sd + c] : 0.f;
        const float qv = c < D ? Qs[qq * sd + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(a[i], dov, acc_v[i][j]);
          acc_k[i][j] = fmaf(b[i], qv, acc_k[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ra + i;
    if (r >= Lk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cg + 16 * j;
      if (c < D) {
        dk[(kbase + r) * D + c] = acc_k[i][j];
        dv[(kbase + r) * D + c] = acc_v[i][j];
      }
    }
  }
}

bool shape_ok(int bh, int lq, int lk, int d) {
  return bh > 0 && bh <= 65535 && lq > 0 && lk > 0 && d > 0 && d % 8 == 0 &&
         d <= kMaxD;
}

// Launch a kernel after opting in to the dynamic shared memory it needs
// (above the default 48 KB).  The callers pick NJ = 4 (D <= 64) or 8
// (D <= 128).
template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, dim3 grid, size_t smem, cudaStream_t s,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

size_t fwd_smem(int d) {
  return sizeof(float) * (size_t)(kBQ * (d + 1) + 2 * kBK * (d + 1) +
                                  kBQ * (kBK + 1));
}
size_t dq_smem(int d) {
  return sizeof(float) * (size_t)(2 * kBQ * (d + 1) + 2 * kBK * (d + 1) +
                                  kBQ * (kBK + 1));
}
size_t dkv_smem(int d) {
  return sizeof(float) * (size_t)(2 * kBK * (d + 1) + 2 * kBQ * (d + 1) +
                                  2 * kBK * (kBQ + 1) + 2 * kBQ);
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const float* m,
                const float* l, const float* o, float* m_out, float* l_out,
                float* o_out, int bh, int lq, int lk, int d, int q_offset,
                int k_offset, int causal, float scale, cudaStream_t s) {
  const dim3 grid((lq + kBQ - 1) / kBQ, bh);
  const T* tq = (const T*)q;
  const T* tk = (const T*)k;
  const T* tv = (const T*)v;
  if (d <= 64)
    return launch(flash_fwd_kernel<T, 4>, grid, fwd_smem(d), s, tq, tk, tv,
                  m, l, o, m_out, l_out, o_out, lq, lk, d, q_offset, k_offset,
                  causal, scale);
  return launch(flash_fwd_kernel<T, 8>, grid, fwd_smem(d), s, tq, tk, tv, m,
                l, o, m_out, l_out, o_out, lq, lk, d, q_offset, k_offset,
                causal, scale);
}

template <typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   float* dq, int bh, int lq, int lk, int d, int q_offset,
                   int k_offset, int causal, float scale, cudaStream_t s) {
  const dim3 grid((lq + kBQ - 1) / kBQ, bh);
  const T* tq = (const T*)q;
  const T* tk = (const T*)k;
  const T* tv = (const T*)v;
  const T* tdo = (const T*)dout;
  if (d <= 64)
    return launch(flash_bwd_dq_kernel<T, 4>, grid, dq_smem(d), s, tq, tk, tv,
                  tdo, lse, delta, dq, lq, lk, d, q_offset, k_offset, causal,
                  scale);
  return launch(flash_bwd_dq_kernel<T, 8>, grid, dq_smem(d), s, tq, tk, tv,
                tdo, lse, delta, dq, lq, lk, d, q_offset, k_offset, causal,
                scale);
}

template <typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    float* dk, float* dv, int bh, int lq, int lk, int d,
                    int q_offset, int k_offset, int causal, float scale,
                    cudaStream_t s) {
  const dim3 grid((lk + kBK - 1) / kBK, bh);
  const T* tq = (const T*)q;
  const T* tk = (const T*)k;
  const T* tv = (const T*)v;
  const T* tdo = (const T*)dout;
  if (d <= 64)
    return launch(flash_bwd_dkv_kernel<T, 4>, grid, dkv_smem(d), s, tq, tk,
                  tv, tdo, lse, delta, dk, dv, lq, lk, d, q_offset, k_offset,
                  causal, scale);
  return launch(flash_bwd_dkv_kernel<T, 8>, grid, dkv_smem(d), s, tq, tk, tv,
                tdo, lse, delta, dk, dv, lq, lk, d, q_offset, k_offset,
                causal, scale);
}

}  // namespace

extern "C" {

int hvd_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                  const void* m, const void* l, const void* o, void* m_out,
                  void* l_out, void* o_out, int bh, int lq, int lk, int d,
                  int q_offset, int k_offset, int causal, float scale,
                  void* stream) {
  if (!shape_ok(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fm = (const float*)m, *fl = (const float*)l,
              *fo = (const float*)o;
  float *om = (float*)m_out, *ol = (float*)l_out, *oo = (float*)o_out;
  if (dtype == 0)
    return (int)fwd<float>(q, k, v, fm, fl, fo, om, ol, oo, bh, lq, lk, d,
                           q_offset, k_offset, causal, scale, s);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(q, k, v, fm, fl, fo, om, ol, oo, bh, lq,
                                   lk, d, q_offset, k_offset, causal, scale,
                                   s);
  return (int)cudaErrorInvalidValue;
}

int hvd_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int lq, int lk, int d, int q_offset,
                     int k_offset, int causal, float scale, void* stream) {
  if (!shape_ok(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fl = (const float*)lse, *fd = (const float*)delta;
  if (dtype == 0)
    return (int)bwd_dq<float>(q, k, v, dout, fl, fd, (float*)dq, bh, lq, lk,
                              d, q_offset, k_offset, causal, scale, s);
  if (dtype == 1)
    return (int)bwd_dq<__nv_bfloat16>(q, k, v, dout, fl, fd, (float*)dq, bh,
                                      lq, lk, d, q_offset, k_offset, causal,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

int hvd_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int lq, int lk, int d,
                      int q_offset, int k_offset, int causal, float scale,
                      void* stream) {
  if (!shape_ok(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fl = (const float*)lse, *fd = (const float*)delta;
  if (dtype == 0)
    return (int)bwd_dkv<float>(q, k, v, dout, fl, fd, (float*)dk, (float*)dv,
                               bh, lq, lk, d, q_offset, k_offset, causal,
                               scale, s);
  if (dtype == 1)
    return (int)bwd_dkv<__nv_bfloat16>(q, k, v, dout, fl, fd, (float*)dk,
                                       (float*)dv, bh, lq, lk, d, q_offset,
                                       k_offset, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

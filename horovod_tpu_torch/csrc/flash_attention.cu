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
// of the sums differs from the plain PyTorch versions.  The CUDA-core
// kernels take expf, the tensor-core kernels exp2f of scores scaled by
// log2(e); no fast-math flags.  Head dims: any multiple of 8 up to 256.
//
// Design.  The TPU carried the softmax state across a sequential grid
// axis in VMEM scratch; here that axis is a loop inside one thread
// block, so nothing carries between blocks and there are no atomics:
// the results are deterministic.  Tiles that the causal mask hides
// entirely are skipped: for such a tile the TPU step leaves (m, l, o)
// unchanged (rows with m = -inf have their l and o multiplied by alpha =
// 0 once, at load).  Ragged edges are masked here, so any L works; the
// TPU's packed m|l lane tile and block-size fallback are not carried
// over.  Two kernels per entry, chosen by dtype:
//
// bf16 B8, B9 and B10 (flash_fwd_tc_kernel, flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel) run on the tensor cores.  A block is two
// consumer warpgroups of 64 rows and one producer warp.  The producer's
// lane 0 issues TMA copies into shared memory (128-byte swizzle) behind a
// two-stage ring of mbarriers (full: bytes arrived; empty: the eight
// consumer warps are done), so the next K/V (B8, B9) or Q/dO/lse/delta
// (B10) tile is in flight while the current one is multiplied.  The
// products are wgmma.mma_async with f32 accumulators.  B8: one block per
// 128 Q rows (Q tiles walked last first: the causal mask gives the last
// the most keys), 128-key tiles at D <= 64 and 64-key tiles above (the
// tile is D rounded up to 64, 128, 192 or 256 columns); S
// = Q.K^T from shared memory (both K-major), row max and sum over the four
// threads of a quad; p is rounded to bf16 in registers and fed back as the
// register A operand of O += P.V (the accumulator layout of S over columns
// [16c, 16c + 16) is the A fragment of k-chunk c; V is the MN-major B
// operand, transpose bit set); l is kept as per-thread partial sums and
// reduced once at the end; exp2f on scores scaled by log2(e).  B10: one
// block per 128 keys, 64 per warpgroup, loop over 64-query tiles (32 at D
// = 128, which keeps dK, dV, S^T and dP^T within the register file): S^T =
// K.Q^T and dP^T = V.dO^T, p^T and ds^T in registers, then dV +=
// bf16(p^T).dO and dK += bf16(ds^T).Q with the same Q and dO tiles read
// MN-major.  Above D = 128 (tiles of 256 columns) dK and dV of 64 keys
// would take 256 f32 registers a thread: a block holds 64 keys, both
// warpgroups compute the same S^T and dP^T, and each accumulates dK and
// dV for its half of the head columns.  lse and delta reach B10's stages
// by plain loads of the producer warp.  B9: B8's block and walk (128 Q
// rows, Q tiles last first, hidden tiles not loaded) over 64-key tiles
// (S, dP and dQ fit the register file without spills at D = 128 too; 32
// above, where Q and dO take 96 or 128 KB); Q and dO arrive once,
// behind one barrier, lse and delta of the thread's two rows by plain
// loads (rows past Lq get lse = -inf, so p = 0); S = Q.K^T and dP = dO.V^T
// as B10's S^T and dP^T with the roles of Q and K swapped, ds in
// registers, then dQ += bf16(ds).K with K read MN-major from the same
// stage (B8's P.V with V replaced by K), so the stage is released only
// after that product's wait.  Each block owns its dQ rows: no atomics, and
// dQ stays a separate kernel from B10, as in the TPU contract.  The
// roundings are the Pallas bodies' (p to V's or dO's dtype, ds to Q's or
// K's); only the order of the sums moves, so bf16 results agree with the
// plain versions within the bf16 tolerance, not bit for bit.
//
// f32 B8-B10 run on the CUDA cores: tensor cores would take f32 as TF32,
// whose 10-bit mantissa breaks the f32 tolerance.  B8 and B9 run one block
// per (bh, 64-row Q tile) looping over 64-row K/V tiles; B10 one block per
// (bh, 64-row K tile) looping over Q tiles; above D = 128 B9's K/V tiles
// and B10's Q tiles hold 32 rows, so the staged tiles fit the 227 KB of
// shared memory (B8's fit at 64). Tiles are staged in shared
// memory as f32 (rows padded by one word, so a column walk hits 32 banks);
// each of the 256 threads owns a 4x4 micro-tile of the 64x64 score tile
// and a 4-row strip of the output, so a row's max and sum are reduced by
// shuffles among 16 lanes.
//
// Traps the tensor-core path handles:
// - Tensor maps are 3-D, (D, L, BH), never 2-D (D, BH*L): out-of-bounds
//   fill then zeroes the rows past L of one head instead of reading the
//   next head's, and the columns past D of a 64-column box, which pads
//   the wgmma depth (16 bf16 values) for any D % 8 == 0.  Keys zero-
//   filled past Lk are still masked to -inf, not scored 0.  A column
//   group wholly past D (B10's 256-column tiles at D <= 192) is not
//   loaded but zeroed in shared memory, behind fence.proxy.async.
// - lse and delta are not loaded by TMA: a 1-D box of the flattened (BH *
//   Lq) rows starts off the 16-byte grid unless Lq % 4 == 0, and the copy
//   then faults (error 715, an illegal instruction).
// - 288 threads are nine warps over the SM's four register partitions,
//   so ptxas caps every tensor-core kernel at 168 registers a thread: the
//   256-column B8 and B9 spill (a few hundred bytes of local memory).
// - cuTensorMapEncodeTiled is a driver-API function and the library is
//   not linked against libcuda: it is fetched once through
//   cudaGetDriverEntryPoint.
// - The maps are built on the host at every launch and passed by value
//   as __grid_constant__ const CUtensorMap parameters.
// - TMA needs 16-byte-aligned base addresses and row strides.  The
//   strides hold for D % 8 == 0; the wrapper refuses a base that is off
//   that grid.
// - The wgmma descriptors' swizzle mode (128 B), stride byte offset
//   (1024 B between 8-row atoms) and leading byte offset (the next
//   64-column region, MN-major only) match the TMA swizzle; tiles start
//   on 1024-byte boundaries.  At D = 64 one bf16 row is one swizzle row;
//   at D = 128 a tile is two 64-column regions and the k-steps cross
//   from the first to the second.
// - The source is one file, so the build's hash of <name>.cu covers it.
//
// Bound.  At the transformer path's shape (BH 192, L 1024, D 64, bf16,
// causal) B8 must read q, k, v and the carried f32 (m, l, o) and write
// (m, l, o): about 0.18 GB, 0.054 ms at 3.35 TB/s, against 26 GFLOP of
// causal score and p.V products (0.026 ms at the 989 TFLOP/s bf16
// peak), so bytes bound it; B10 reads q, k, v, dO, lse, delta and writes
// f32 dK and dV, 0.20 GB (0.061 ms) against 52 GFLOP (0.052 ms).  The
// f32 state is 100 MB of B8's 179 MB; its loads and stores sit in each
// block's prologue and epilogue.  B9 reads q, k, v, dO, lse, delta and
// writes f32 dQ, 0.15 GB (0.046 ms) against 39 GFLOP (0.039 ms), so
// bytes bound it too; at (12, 8192, 64) all three are bound by their
// products.  At the LM example's (64, 1024, 192) the same counts give
// 0.053, 0.045 and 0.060 ms, all bound by bytes.
//
// Interface: plain C, one entry per kernel, loaded with ctypes.  dtype
// 0 = float32, 1 = bfloat16 (q, k, v, do); m, l, o, lse, delta and every
// output are f32.  All tensors are contiguous (BH, L[, D]).  Each entry
// returns cudaGetLastError() after the launch on the caller's stream (or
// cudaErrorInvalidValue for a shape or tensor map it refuses); nothing
// is allocated and nothing is synchronised.  hvd_flash_tc_attributes
// reports the tensor-core kernels' registers, local and shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kMaxD = 256;
// D > 128 in f32: the B9 key and B10 query tiles hold 32 rows, so the
// staged tiles fit the 227 KB of shared memory
constexpr int kBWide = 32;

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

// Stage rows [row0, row0 + rows) of a (L, D) matrix into shared memory
// as f32 with row stride D + 1; rows past L are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int L, int D,
                                          int rows = 64) {
  const int sd = D + 1;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * sd + c] = row0 + r < L ? src[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

// A 4xJT micro-tile of products over D: acc[i][j] = A[ra+i].B[cb+16j]
// (A, B staged tiles; B has 16 JT rows).
template <int JT>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int ra, int cb, int D,
                                         float (&acc)[4][JT]) {
  const int sd = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JT; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[JT];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + i) * sd + d];
#pragma unroll
    for (int j = 0; j < JT; ++j) b[j] = B[(cb + 16 * j) * sd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Two such micro-tiles in one pass: acc = A.B^T and acc2 = A2.B2^T.
template <int JT>
__device__ __forceinline__ void dot_tiles(const float* A, const float* B,
                                          const float* A2, const float* B2,
                                          int ra, int cb, int D,
                                          float (&acc)[4][JT],
                                          float (&acc2)[4][JT]) {
  const int sd = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JT; ++j) acc[i][j] = acc2[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[JT], a2[4], b2[JT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ra + i) * sd + d];
      a2[i] = A2[(ra + i) * sd + d];
    }
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      b[j] = B[(cb + 16 * j) * sd + d];
      b2[j] = B2[(cb + 16 * j) * sd + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        acc2[i][j] = fmaf(a2[i], b2[j], acc2[i][j]);
      }
  }
}

// B8, f32: grid (ceil(Lq/64), BH).  NJ = ceil(D/16) output columns per
// thread.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* m_in,
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
  const float* qb = q + (size_t)bh * Lq * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;

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
    dot_tile<4>(Qs, Ks, ra, cg, D, s);
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
        Ps[(ra + i) * (kBK + 1) + cg + 16 * j] = p;
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

// B9, f32: grid (ceil(Lq/64), BH); BK keys per tile.
template <int NJ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* dq, int Lq,
                        int Lk, int D, int q_offset, int k_offset,
                        int causal, float scale) {
  extern __shared__ float smem[];
  const int sd = D + 1;
  float* Qs = smem;
  float* dOs = Qs + kBQ * sd;
  float* Ks = dOs + kBQ * sd;
  float* Vs = Ks + BK * sd;
  float* dSs = Vs + BK * sd;  // kBQ x (BK + 1)
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int ra = (threadIdx.x >> 4) * 4;
  const int cg = threadIdx.x & 15;
  const size_t qbase = (size_t)bh * Lq;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;

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

  int kt_end = (Lk + BK - 1) / BK;
  if (causal) {
    const long long lim = (long long)q_offset + min(q0 + kBQ, Lq) - 1 -
                          (long long)k_offset;
    kt_end = lim < 0 ? 0 : min((long long)kt_end, lim / BK + 1);
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(Ks, kb, k0, Lk, D, BK);
    load_tile(Vs, vb, k0, Lk, D, BK);
    __syncthreads();
    float s[4][BK / 16], dp[4][BK / 16];
    dot_tiles<BK / 16>(Qs, Ks, dOs, Vs, ra, cg, D, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ra + i;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int kk = k0 + cg + 16 * j;
        const bool ok = kk < Lk && (!causal || qpos >= k_offset + kk);
        const float p = softmax_p(ok ? s[i][j] * scale : neg_inf(), lse_r[i]);
        dSs[(ra + i) * (BK + 1) + cg + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    const int kn = min(BK, Lk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(ra + i) * (BK + 1) + kk];
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

// B10, f32: grid (ceil(Lk/64), BH); BQ queries per tile.  Tiles are
// computed transposed (rows are keys), so each thread's accumulator rows
// are its own keys.
template <int NJ, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* dk,
                         float* dv, int Lq, int Lk, int D, int q_offset,
                         int k_offset, int causal, float scale) {
  extern __shared__ float smem[];
  const int sd = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kBK * sd;
  float* Qs = Vs + kBK * sd;
  float* dOs = Qs + BQ * sd;
  float* Pt = dOs + BQ * sd;         // kBK x (BQ + 1)
  float* dSt = Pt + kBK * (BQ + 1);  // kBK x (BQ + 1)
  float* lse_s = dSt + kBK * (BQ + 1);
  float* delta_s = lse_s + BQ;
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

  const int nqt = (Lq + BQ - 1) / BQ;
  int qt_begin = 0;
  if (causal) {
    // queries at index >= lim see some key of this tile
    const long long lim = (long long)k_offset + k0 - (long long)q_offset;
    qt_begin = lim <= 0 ? 0 : (int)min((long long)nqt, lim / BQ);
  }
  for (int qt = qt_begin; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile(Qs, q + qbase * D, q0, Lq, D, BQ);
    load_tile(dOs, dout + qbase * D, q0, Lq, D, BQ);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < Lq ? lse[qbase + r] : neg_inf();
      delta_s[threadIdx.x] = r < Lq ? delta[qbase + r] : 0.f;
    }
    __syncthreads();
    float st[4][BQ / 16], dpt[4][BQ / 16];
    dot_tiles<BQ / 16>(Ks, Qs, Vs, dOs, ra, cg, D, st, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k_offset + k0 + ra + i;
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        const int qq = cg + 16 * j;
        const bool ok = q0 + qq < Lq && k0 + ra + i < Lk &&
                        (!causal || q_offset + q0 + qq >= kpos);
        const float p = softmax_p(ok ? st[i][j] * scale : neg_inf(),
                                  lse_s[qq]);
        const float ds = p * (dpt[i][j] - delta_s[qq]) * scale;
        Pt[(ra + i) * (BQ + 1) + qq] = p;
        dSt[(ra + i) * (BQ + 1) + qq] = ds;
      }
    }
    __syncthreads();
    const int qn = min(BQ, Lq - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Pt[(ra + i) * (BQ + 1) + qq];
        b[i] = dSt[(ra + i) * (BQ + 1) + qq];
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


// ---------------------------------------------------------------------------
// bf16 B8 and B10 on the tensor cores: wgmma on TMA-fed, 128-byte-swizzled
// shared-memory tiles behind a two-stage mbarrier ring.
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;     // Q rows (B8) or keys (B10) per block
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 rows each
constexpr int kTcThreads = 32 * kConsumerWarps + 32;  // + one producer warp
constexpr int kStages = 2;
constexpr int kAtom = 64;  // bf16 columns in one 128-byte swizzle row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a (D, L, BH) tensor map into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int C>
__device__ __forceinline__ void reg_fence(uint32_t (&f)[C][4]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[c][i])::"memory");
}

// wgmma shared-memory descriptors for tiles that TMA wrote with the
// 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (the
// stride byte offset, 64 x 16 B); layout type 1 = 128-byte swizzle.
// K-major (the reduction dimension is contiguous): the leading offset is
// unused, a 16-deep k-step starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
// MN-major (rows are the reduction dimension; used with the transpose
// bit): a k-step is 16 rows (2048 bytes) on, and the next 64 output
// columns lie `lbo` bytes away (the next 64-column region of the tile).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

// d (m64 x nN, f32) += A (m64 x k16, shared memory, K-major) .
// B (k16 x nN, shared memory, K-major); acc = 0 overwrites d.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int acc);
// d += A (registers, bf16 fragments) . B (shared memory, MN-major).
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(acc));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// An m64 x nN f32 accumulator rounded to bf16 as the A operand of the next
// product: its columns [16c, 16c + 16) are exactly the register fragment
// of k-chunk c (thread t holds rows 16 w + t/4 (+8), columns 2 (t%4) (+1)
// (+8) in both layouts).
template <int N>
__device__ __forceinline__ void to_frags(const float (&x)[N / 2],
                                         uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
    f[c][0] = pack_bf16(x[8 * c + 0], x[8 * c + 1]);
    f[c][1] = pack_bf16(x[8 * c + 2], x[8 * c + 3]);
    f[c][2] = pack_bf16(x[8 * c + 4], x[8 * c + 5]);
    f[c][3] = pack_bf16(x[8 * c + 6], x[8 * c + 7]);
  }
}

// Row max over the four threads of a quad, which hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// B8, bf16: grid (BH, ceil(Lq/128)), the Q tiles walked last first (the
// causal mask gives the last the most keys).  DP = D rounded up to a
// multiple of 64 (the tiles' width in shared memory), BK keys per tile.
template <int DP, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* m_in, const float* l_in,
                        const float* o_in, float* m_out, float* l_out,
                        float* o_out, int Lq, int Lk, int D, int q_offset,
                        int k_offset, int causal, float scale) {
  constexpr uint32_t kQBytes = kTcRows * DP * 2;
  constexpr uint32_t kTile = BK * DP * 2;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kQBytes;             // + stage * kTile
  const uint32_t sV = sK + kStages * kTile;     // + stage * kTile
  const uint32_t bars = sV + kStages * kTile;   // q, full[], empty[]
  const uint32_t q_full = bars;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    // keys at index <= lim are visible to some row of this tile
    const long long lim = (long long)q_offset + min(q0 + kTcRows, Lq) - 1 -
                          (long long)k_offset;
    n_kt = lim < 0 ? 0 : (int)min((long long)n_kt, lim / BK + 1);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one lane issues every copy
    if (lane == 0 && n_kt > 0) {
      mbar_expect_tx(q_full, kQBytes);
      for (int g = 0; g < DP / kAtom; ++g)
        tma_load_3d(sQ + g * kTcRows * 128, &tm_q, q_full, g * kAtom, q0, bh);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        const uint32_t full = bars + 8 * (1 + s);
        if (i >= kStages)
          mbar_wait(bars + 8 * (1 + kStages + s), ((i / kStages) + 1) & 1);
        mbar_expect_tx(full, 2 * kTile);
        for (int g = 0; g < DP / kAtom; ++g) {
          tma_load_3d(sK + s * kTile + g * BK * 128, &tm_k, full, g * kAtom,
                      i * BK, bh);
          tma_load_3d(sV + s * kTile + g * BK * 128, &tm_v, full, g * kAtom,
                      i * BK, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [wq0, wq0 + 64); this thread rows
  // r[0] and r[1] = r[0] + 8, columns 8 j + 2 quad (+1)
  const int wg = warp >> 2, quad = lane & 3;
  const int wq0 = q0 + 64 * wg;
  const int r[2] = {wq0 + 16 * (warp & 3) + (lane >> 2),
                    wq0 + 16 * (warp & 3) + (lane >> 2) + 8};
  float m[2], l[2], o[DP / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = r[i] < Lq;
    const size_t row = (size_t)bh * Lq + r[i];
    m[i] = in ? m_in[row] : neg_inf();
    // as in the CUDA-core kernel: alpha = 0 for m = -inf applied at load
    const float keep = isfinite(m[i]) ? 1.f : 0.f;
    // l is kept as four partial sums, one per thread of the quad
    l[i] = (in && quad == 0) ? l_in[row] * keep : 0.f;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      float2 v = make_float2(0.f, 0.f);
      if (in && c < D) v = *reinterpret_cast<const float2*>(o_in + row * D + c);
      o[4 * j + 2 * i] = v.x * keep;
      o[4 * j + 2 * i + 1] = v.y * keep;
    }
  }

  if (n_kt > 0) mbar_wait(q_full, 0);
  const bool rows_in = wq0 < Lq;
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const int k0 = i * BK;
    mbar_wait(bars + 8 * (1 + s), (i / kStages) & 1);
    // a tile whose first key follows the warpgroup's last row is hidden
    const bool visible =
        rows_in && (!causal || (long long)k_offset + k0 <=
                                   (long long)q_offset + wq0 + 63);
    if (visible) {
      float sc[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a = sQ + (kk / 4) * kTcRows * 128 + wg * 64 * 128 +
                           (kk % 4) * 32;
        const uint32_t b = sK + s * kTile + (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_ss<BK>(sc, desc_k(a), desc_k(b), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(sc);
      // ragged keys or a tile crossing the diagonal need the mask
      const bool edge = k0 + BK > Lk ||
                        (causal && (long long)k_offset + k0 + BK - 1 >
                                       (long long)q_offset + wq0);
      float alpha[2];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int qpos = q_offset + r[i2];
        float mc = neg_inf();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = sc[4 * j + 2 * i2 + c] * scale;
            if (edge) {
              const int kk = k0 + 8 * j + 2 * quad + c;
              if (!(kk < Lk && (!causal || qpos >= k_offset + kk)))
                x = neg_inf();
            }
            sc[4 * j + 2 * i2 + c] = x;
            mc = fmaxf(mc, x);
          }
        const float m_new = fmaxf(m[i2], quad_max(mc));
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        alpha[i2] = isfinite(m[i2]) ? exp2f((m[i2] - m_safe) * kLog2e) : 0.f;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = sc[4 * j + 2 * i2 + c];
            const float p = isfinite(x) ? exp2f((x - m_safe) * kLog2e) : 0.f;
            sc[4 * j + 2 * i2 + c] = p;
            psum += p;
          }
        l[i2] = l[i2] * alpha[i2] + psum;
        m[i2] = m_new;
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      uint32_t pf[BK / 16][4];  // p rounded to bf16, V's dtype
      to_frags<BK>(sc, pf);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs<DP>(o, pf[kc],
                     desc_mn(sV + s * kTile + kc * 16 * 128, BK * 128), 1);
      wg_commit();
      wg_wait0();
      reg_fence(o);
      reg_fence(pf);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + kStages + s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r[i] >= Lq) continue;
    const size_t row = (size_t)bh * Lq + r[i];
    if (quad == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      if (c < D)
        *reinterpret_cast<float2*>(o_out + row * D + c) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
    }
  }
}

// B9, bf16: grid (BH, ceil(Lq/128)), the Q tiles walked last first as in
// B8; each warpgroup owns 64 Q rows (and their dO rows) and loops over
// BK-key tiles of K and V (64 up to DP 128; 32 above, where Q and dO take
// 96 or 128 KB of shared memory and dQ 96 or 128 registers a thread).
template <int DP, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* lse, const float* delta, float* dq,
                           int Lq, int Lk, int D, int q_offset, int k_offset,
                           int causal, float scale) {
  constexpr uint32_t kQBytes = kTcRows * DP * 2;  // Q or dO
  constexpr uint32_t kTile = BK * DP * 2;         // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + kQBytes;
  const uint32_t sK = sdO + kQBytes;            // + stage * kTile
  const uint32_t sV = sK + kStages * kTile;     // + stage * kTile
  const uint32_t bars = sV + kStages * kTile;   // q/dO, full[], empty[]
  const uint32_t q_full = bars;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    // keys at index <= lim are visible to some row of this tile
    const long long lim = (long long)q_offset + min(q0 + kTcRows, Lq) - 1 -
                          (long long)k_offset;
    n_kt = lim < 0 ? 0 : (int)min((long long)n_kt, lim / BK + 1);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one lane issues every copy
    if (lane == 0 && n_kt > 0) {
      mbar_expect_tx(q_full, 2 * kQBytes);
      for (int g = 0; g < DP / kAtom; ++g) {
        tma_load_3d(sQ + g * kTcRows * 128, &tm_q, q_full, g * kAtom, q0, bh);
        tma_load_3d(sdO + g * kTcRows * 128, &tm_do, q_full, g * kAtom, q0,
                    bh);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        const uint32_t full = bars + 8 * (1 + s);
        if (i >= kStages)
          mbar_wait(bars + 8 * (1 + kStages + s), ((i / kStages) + 1) & 1);
        mbar_expect_tx(full, 2 * kTile);
        for (int g = 0; g < DP / kAtom; ++g) {
          tma_load_3d(sK + s * kTile + g * BK * 128, &tm_k, full, g * kAtom,
                      i * BK, bh);
          tma_load_3d(sV + s * kTile + g * BK * 128, &tm_v, full, g * kAtom,
                      i * BK, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [wq0, wq0 + 64); this thread rows
  // r[0] and r[1] = r[0] + 8, key columns 8 j + 2 quad (+1) of S and dP,
  // head columns 8 j + 2 quad (+1) of dQ
  const int wg = warp >> 2, quad = lane & 3;
  const int wq0 = q0 + 64 * wg;
  const int r[2] = {wq0 + 16 * (warp & 3) + (lane >> 2),
                    wq0 + 16 * (warp & 3) + (lane >> 2) + 8};
  float lse_r[2], delta_r[2], dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = r[i] < Lq;
    const size_t row = (size_t)bh * Lq + r[i];
    lse_r[i] = in ? lse[row] : neg_inf();  // p = 0 on rows past Lq
    delta_r[i] = in ? delta[row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;

  if (n_kt > 0) mbar_wait(q_full, 0);
  const bool rows_in = wq0 < Lq;
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const int k0 = i * BK;
    mbar_wait(bars + 8 * (1 + s), (i / kStages) & 1);
    // a tile whose first key follows the warpgroup's last row is hidden
    const bool visible =
        rows_in && (!causal || (long long)k_offset + k0 <=
                                   (long long)q_offset + wq0 + 63);
    if (visible) {
      float sc[BK / 2], dp[BK / 2];  // S = Q.K^T and dP = dO.V^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a = (kk / 4) * kTcRows * 128 + wg * 64 * 128 +
                           (kk % 4) * 32;
        const uint32_t b = s * kTile + (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_ss<BK>(sc, desc_k(sQ + a), desc_k(sK + b), kk > 0);
        wgmma_ss<BK>(dp, desc_k(sdO + a), desc_k(sV + b), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(sc);
      reg_fence(dp);
      // ragged keys or a tile crossing the diagonal need the mask
      const bool edge = k0 + BK > Lk ||
                        (causal && (long long)k_offset + k0 + BK - 1 >
                                       (long long)q_offset + wq0);
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int qpos = q_offset + r[i2];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * i2 + c;
            bool ok = true;
            if (edge) {
              // keys zero-filled past Lk are masked, not scored 0
              const int kk = k0 + 8 * j + 2 * quad + c;
              ok = kk < Lk && (!causal || qpos >= k_offset + kk);
            }
            // softmax_p's guards; then ds = p (dp - delta) scale
            const float sv = sc[idx] * scale;
            const float p = (ok && isfinite(sv) && isfinite(lse_r[i2]))
                                ? exp2f((sv - lse_r[i2]) * kLog2e)
                                : 0.f;
            sc[idx] = ok ? p * (dp[idx] - delta_r[i2]) * scale : 0.f;
          }
      }
      uint32_t sf[BK / 16][4];  // ds rounded to bf16, K's dtype
      to_frags<BK>(sc, sf);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs<DP>(dqa, sf[kc],
                     desc_mn(sK + s * kTile + kc * 16 * 128, BK * 128), 1);
      wg_commit();
      wg_wait0();
      reg_fence(dqa);
      reg_fence(sf);
    }
    // the dQ product has read K from the stage: release it
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + kStages + s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r[i] >= Lq) continue;
    const size_t row = (size_t)bh * Lq + r[i];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      if (c < D)
        *reinterpret_cast<float2*>(dq + row * D + c) =
            make_float2(dqa[4 * j + 2 * i], dqa[4 * j + 2 * i + 1]);
    }
  }
}

// B10, bf16: grid (BH, ceil(Lk/KR)); loops over BQ-query tiles of Q, dO,
// lse and delta.  Without SPLIT a block holds KR = 128 keys and each
// warpgroup owns 64 of them with every head column of their dK and dV.
// With SPLIT (DP 256: dK and dV of 64 keys over 256 columns would take
// 256 f32 registers a thread) a block holds KR = 64 keys, both
// warpgroups compute the same S^T and dP^T over the whole head dim, and
// warpgroup wg accumulates dK and dV for head columns [128 wg, 128 wg +
// 128) only.  The column groups of 64 that lie wholly past D are not
// loaded: they are zeroed once in shared memory (the tiles' other column
// groups arrive by TMA, which zero-fills past D within a group).
template <int DP, int BQ, bool SPLIT>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* lse_g, const float* delta_g,
                            float* dk, float* dv, int Lq, int Lk, int D,
                            int q_offset, int k_offset, int causal,
                            float scale) {
  constexpr int KR = SPLIT ? 64 : kTcRows;     // keys per block
  constexpr int NO = SPLIT ? DP / 2 : DP;      // output columns per warpgroup
  constexpr uint32_t kKv = KR * DP * 2;        // K or V
  constexpr uint32_t kQt = BQ * DP * 2;        // one Q or dO tile
  // a stage: Q, dO, then the tile's lse and delta
  constexpr uint32_t kStage = (2 * kQt + 2 * BQ * 4 + 1023) & ~1023u;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + kKv;
  const uint32_t sS = sV + kKv;  // stage s: Q, dO, lse, delta
  const uint32_t bars = sS + kStages * kStage;  // kv, full[], empty[]
  const uint32_t kv_full = bars;
  const uint8_t* gS = smem_raw + (sS - smem_u32(smem_raw));
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * KR;
  const int ng = min(DP / kAtom, (D + kAtom - 1) / kAtom);  // groups loaded
  const int nqt = (Lq + BQ - 1) / BQ;
  int qt_begin = 0;
  if (causal) {
    // queries at index >= lim see some key of this tile
    const long long lim = (long long)k_offset + k0 - (long long)q_offset;
    qt_begin = lim <= 0 ? 0 : (int)min((long long)nqt, lim / BQ);
  }
  const int n = nqt - qt_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (ng < DP / kAtom) {
    // zero the column groups past D in every tile; the wgmma reads them
    // through the async proxy, hence the proxy fence
    uint8_t* base = smem_raw + (sK - smem_u32(smem_raw));
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int g = ng; g < DP / kAtom; ++g) {
      for (int i = threadIdx.x; i < KR * 8; i += kTcThreads) {
        reinterpret_cast<uint4*>(base + g * KR * 128)[i] = z;
        reinterpret_cast<uint4*>(base + kKv + g * KR * 128)[i] = z;
      }
      for (int st = 0; st < kStages; ++st)
        for (int i = threadIdx.x; i < BQ * 8; i += kTcThreads) {
          uint8_t* t = base + 2 * kKv + st * kStage + g * BQ * 128;
          reinterpret_cast<uint4*>(t)[i] = z;
          reinterpret_cast<uint4*>(t + kQt)[i] = z;
        }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp
    if (n > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * ng * KR * 128);
        for (int g = 0; g < ng; ++g) {
          tma_load_3d(sK + g * KR * 128, &tm_k, kv_full, g * kAtom, k0, bh);
          tma_load_3d(sV + g * KR * 128, &tm_v, kv_full, g * kAtom, k0, bh);
        }
      }
      float* rows_base = reinterpret_cast<float*>(
          smem_raw + (sS - smem_u32(smem_raw)) + 2 * kQt);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int q0 = (qt_begin + i) * BQ;
        const uint32_t full = bars + 8 * (1 + s);
        const uint32_t st = sS + s * kStage;
        if (i >= kStages)
          mbar_wait(bars + 8 * (1 + kStages + s), ((i / kStages) + 1) & 1);
        // lse and delta by plain loads: a TMA box of the flattened (BH *
        // Lq) rows would start off the 16-byte grid unless Lq % 4 == 0.
        // Rows past Lq get lse = -inf (p = 0); they are masked below too.
        float* ls = rows_base + s * (kStage / 4);
        for (int j = lane; j < BQ; j += 32) {
          const bool in = q0 + j < Lq;
          const size_t row = (size_t)bh * Lq + q0 + j;
          ls[j] = in ? lse_g[row] : neg_inf();
          ls[BQ + j] = in ? delta_g[row] : 0.f;
        }
        __syncwarp();  // the lanes' stores precede lane 0's release
        if (lane == 0) {
          mbar_expect_tx(full, 2 * ng * BQ * 128);
          for (int g = 0; g < ng; ++g) {
            tma_load_3d(st + g * BQ * 128, &tm_q, full, g * kAtom, q0, bh);
            tma_load_3d(st + kQt + g * BQ * 128, &tm_do, full, g * kAtom, q0,
                        bh);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg's keys are [kw0, kw0 + 64); this thread key
  // rows kr[0] and kr[0] + 8, query columns 8 j + 2 quad (+1) of S^T, and
  // head columns c0 + 8 j + 2 quad (+1) of dK and dV
  const int wg = warp >> 2, quad = lane & 3;
  const int kw0 = k0 + (SPLIT ? 0 : 64 * wg);
  const uint32_t krow = SPLIT ? 0 : wg * 64 * 128;  // kw0's offset in a group
  const int c0 = SPLIT ? wg * NO : 0;
  const uint32_t cofs = SPLIT ? wg * (NO / kAtom) * BQ * 128 : 0;
  const int kr[2] = {kw0 + 16 * (warp & 3) + (lane >> 2),
                     kw0 + 16 * (warp & 3) + (lane >> 2) + 8};
  float dka[NO / 2], dva[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dka[i] = dva[i] = 0.f;
  if (n > 0) mbar_wait(kv_full, 0);
  const bool keys_in = kw0 < Lk;
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int q0 = (qt_begin + i) * BQ;
    const uint32_t st = sS + s * kStage;
    mbar_wait(bars + 8 * (1 + s), (i / kStages) & 1);
    // a tile whose last query precedes the warpgroup's first key is hidden
    const bool visible =
        keys_in && (!causal || (long long)q_offset + q0 + BQ - 1 >=
                                   (long long)k_offset + kw0);
    if (visible) {
      float sct[BQ / 2], dpt[BQ / 2];  // S^T = K.Q^T and dP^T = V.dO^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a = (kk / 4) * KR * 128 + krow + (kk % 4) * 32;
        const uint32_t b = st + (kk / 4) * BQ * 128 + (kk % 4) * 32;
        wgmma_ss<BQ>(sct, desc_k(sK + a), desc_k(b), kk > 0);
        wgmma_ss<BQ>(dpt, desc_k(sV + a), desc_k(b + kQt), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(sct);
      reg_fence(dpt);
      const bool edge = q0 + BQ > Lq ||
                        (causal && (long long)q_offset + q0 <
                                       (long long)k_offset + kw0 + 63);
      const float* lse_s = reinterpret_cast<const float*>(gS + s * kStage +
                                                          2 * kQt);
      const float* delta_s = lse_s + BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * i2 + c;
            const float lse = c ? ls.y : ls.x;
            bool ok = true;
            if (edge) {
              const int qq = q0 + col + c;
              ok = qq < Lq && (!causal || q_offset + qq >= k_offset + kr[i2]);
            }
            // softmax_p's guards; then ds = p (dp - delta) scale
            const float sv = sct[idx] * scale;
            const float p = (ok && isfinite(sv) && isfinite(lse))
                                ? exp2f((sv - lse) * kLog2e)
                                : 0.f;
            sct[idx] = p;
            dpt[idx] = ok ? p * (dpt[idx] - (c ? dl.y : dl.x)) * scale : 0.f;
          }
      }
      uint32_t pf[BQ / 16][4], sf[BQ / 16][4];  // bf16 p^T (dO's), ds^T (Q's)
      to_frags<BQ>(sct, pf);
      to_frags<BQ>(dpt, sf);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        const uint32_t b = st + kc * 16 * 128 + cofs;
        wgmma_rs<NO>(dva, pf[kc], desc_mn(b + kQt, BQ * 128), 1);
        wgmma_rs<NO>(dka, sf[kc], desc_mn(b, BQ * 128), 1);
      }
      wg_commit();
      wg_wait0();
      reg_fence(dva);
      reg_fence(dka);
      reg_fence(pf);
      reg_fence(sf);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + kStages + s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kr[i] >= Lk) continue;
    const size_t row = (size_t)bh * Lk + kr[i];
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      const int c = c0 + 8 * j + 2 * quad;
      if (c < D) {
        *reinterpret_cast<float2*>(dk + row * D + c) =
            make_float2(dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
        *reinterpret_cast<float2*>(dv + row * D + c) =
            make_float2(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    }
  }
}

bool shape_ok(int bh, int lq, int lk, int d) {
  return bh > 0 && bh <= 65535 && lq > 0 && lk > 0 && d > 0 && d % 8 == 0 &&
         d <= kMaxD;
}

// Launch a kernel after opting in to the dynamic shared memory it needs
// (above the default 48 KB).
template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled is a driver-API function; the library is not
// linked against libcuda, so it is looked up through the runtime once.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A (BH, L, D) bf16 tensor as the 3-D map (D, L, BH): a box of 64 columns
// (one 128-byte swizzle row) by `rows` rows of one head.  Out-of-bounds
// elements (rows past L, columns past D) are filled with zeros.
bool map_tiles(CUtensorMap* map, const void* p, int bh, int l, int d,
               int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)l, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)l * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kAtom, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-core kernels' extra limits: the Q-tile grid dimension and
// the flattened row coordinate of lse/delta fit their 32-bit fields.
bool tc_shape_ok(int bh, int lq) {
  return (lq + kTcRows - 1) / kTcRows <= 65535 &&
         (long long)bh * lq < (1ll << 31);
}

// Dynamic shared memory of the tensor-core kernels: 1024 bytes of slack
// to align the tiles to the swizzle atom, the tiles, the mbarriers.
template <int DP, int BK>
constexpr size_t fwd_tc_smem() {
  return 1024 + (size_t)(kTcRows + 2 * kStages * BK) * DP * 2 +
         8 * (1 + 2 * kStages);
}
template <int DP, int BK>
constexpr size_t dq_tc_smem() {
  return 1024 + (size_t)(2 * kTcRows + 2 * kStages * BK) * DP * 2 +
         8 * (1 + 2 * kStages);
}
template <int DP, int BQ, bool SPLIT>
constexpr size_t dkv_tc_smem() {
  return 1024 + (size_t)(SPLIT ? 64 : kTcRows) * DP * 4 +
         kStages * (((size_t)BQ * DP * 4 + BQ * 8 + 1023) & ~(size_t)1023) +
         8 * (1 + 2 * kStages);
}

template <int DP, int BK>
cudaError_t fwd_tc(const void* q, const void* k, const void* v,
                   const float* m, const float* l, const float* o,
                   float* m_out, float* l_out, float* o_out, int bh, int lq,
                   int lk, int d, int q_offset, int k_offset, int causal,
                   float scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!map_tiles(&tq, q, bh, lq, d, kTcRows) ||
      !map_tiles(&tk, k, bh, lk, d, BK) || !map_tiles(&tv, v, bh, lk, d, BK))
    return cudaErrorInvalidValue;
  const dim3 grid(bh, (lq + kTcRows - 1) / kTcRows);
  return launch(flash_fwd_tc_kernel<DP, BK>, grid, kTcThreads,
                fwd_tc_smem<DP, BK>(), s, tq,
                tk, tv, m, l, o, m_out, l_out, o_out, lq, lk, d, q_offset,
                k_offset, causal, scale);
}

template <int DP, int BK>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      float* dq, int bh, int lq, int lk, int d, int q_offset,
                      int k_offset, int causal, float scale,
                      cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo;
  if (!map_tiles(&tq, q, bh, lq, d, kTcRows) ||
      !map_tiles(&tk, k, bh, lk, d, BK) ||
      !map_tiles(&tv, v, bh, lk, d, BK) ||
      !map_tiles(&tdo, dout, bh, lq, d, kTcRows))
    return cudaErrorInvalidValue;
  const dim3 grid(bh, (lq + kTcRows - 1) / kTcRows);
  return launch(flash_bwd_dq_tc_kernel<DP, BK>, grid, kTcThreads,
                dq_tc_smem<DP, BK>(), s, tq, tk, tv, tdo, lse, delta, dq, lq,
                lk, d, q_offset, k_offset, causal, scale);
}

template <int DP, int BQ, bool SPLIT>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int lq, int lk, int d,
                       int q_offset, int k_offset, int causal, float scale,
                       cudaStream_t s) {
  constexpr int kr = SPLIT ? 64 : kTcRows;
  CUtensorMap tq, tk, tv, tdo;
  if ((lk + kr - 1) / kr > 65535 || !map_tiles(&tq, q, bh, lq, d, BQ) ||
      !map_tiles(&tk, k, bh, lk, d, kr) ||
      !map_tiles(&tv, v, bh, lk, d, kr) ||
      !map_tiles(&tdo, dout, bh, lq, d, BQ))
    return cudaErrorInvalidValue;
  const dim3 grid(bh, (lk + kr - 1) / kr);
  return launch(flash_bwd_dkv_tc_kernel<DP, BQ, SPLIT>, grid, kTcThreads,
                dkv_tc_smem<DP, BQ, SPLIT>(), s,
                tq, tk, tv, tdo, lse, delta, dk, dv, lq, lk, d, q_offset,
                k_offset, causal, scale);
}

size_t fwd_smem(int d) {
  return sizeof(float) * (size_t)(kBQ * (d + 1) + 2 * kBK * (d + 1) +
                                  kBQ * (kBK + 1));
}
size_t dq_smem(int d, int bk) {
  return sizeof(float) * (size_t)(2 * kBQ * (d + 1) + 2 * bk * (d + 1) +
                                  kBQ * (bk + 1));
}
size_t dkv_smem(int d, int bq) {
  return sizeof(float) * (size_t)(2 * kBK * (d + 1) + 2 * bq * (d + 1) +
                                  2 * kBK * (bq + 1) + 2 * bq);
}

cudaError_t fwd_f32(const float* q, const float* k, const float* v,
                    const float* m, const float* l, const float* o,
                    float* m_out, float* l_out, float* o_out, int bh, int lq,
                    int lk, int d, int q_offset, int k_offset, int causal,
                    float scale, cudaStream_t s) {
  const dim3 grid((lq + kBQ - 1) / kBQ, bh);
  if (d <= 64)
    return launch(flash_fwd_kernel<4>, grid, kThreads, fwd_smem(d), s, q, k,
                  v, m, l, o, m_out, l_out, o_out, lq, lk, d, q_offset,
                  k_offset, causal, scale);
  if (d <= 128)
    return launch(flash_fwd_kernel<8>, grid, kThreads, fwd_smem(d), s, q, k,
                  v, m, l, o, m_out, l_out, o_out, lq, lk, d, q_offset,
                  k_offset, causal, scale);
  return launch(flash_fwd_kernel<16>, grid, kThreads, fwd_smem(d), s, q, k,
                v, m, l, o, m_out, l_out, o_out, lq, lk, d, q_offset,
                k_offset, causal, scale);
}

cudaError_t bwd_dq_f32(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dq, int bh, int lq, int lk,
                       int d, int q_offset, int k_offset, int causal,
                       float scale, cudaStream_t s) {
  const dim3 grid((lq + kBQ - 1) / kBQ, bh);
  if (d <= 64)
    return launch(flash_bwd_dq_kernel<4, kBK>, grid, kThreads,
                  dq_smem(d, kBK), s, q, k, v, dout, lse, delta, dq, lq, lk,
                  d, q_offset, k_offset, causal, scale);
  if (d <= 128)
    return launch(flash_bwd_dq_kernel<8, kBK>, grid, kThreads,
                  dq_smem(d, kBK), s, q, k, v, dout, lse, delta, dq, lq, lk,
                  d, q_offset, k_offset, causal, scale);
  return launch(flash_bwd_dq_kernel<16, kBWide>, grid, kThreads,
                dq_smem(d, kBWide), s, q, k, v, dout, lse, delta, dq, lq, lk,
                d, q_offset, k_offset, causal, scale);
}

cudaError_t bwd_dkv_f32(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse,
                        const float* delta, float* dk, float* dv, int bh,
                        int lq, int lk, int d, int q_offset, int k_offset,
                        int causal, float scale, cudaStream_t s) {
  const dim3 grid((lk + kBK - 1) / kBK, bh);
  if (d <= 64)
    return launch(flash_bwd_dkv_kernel<4, kBQ>, grid, kThreads,
                  dkv_smem(d, kBQ), s, q, k, v, dout, lse, delta, dk, dv, lq,
                  lk, d, q_offset, k_offset, causal, scale);
  if (d <= 128)
    return launch(flash_bwd_dkv_kernel<8, kBQ>, grid, kThreads,
                  dkv_smem(d, kBQ), s, q, k, v, dout, lse, delta, dk, dv, lq,
                  lk, d, q_offset, k_offset, causal, scale);
  return launch(flash_bwd_dkv_kernel<16, kBWide>, grid, kThreads,
                dkv_smem(d, kBWide), s, q, k, v, dout, lse, delta, dk, dv, lq,
                lk, d, q_offset, k_offset, causal, scale);
}

// The attributes of one tensor-core instantiation and the dynamic shared
// memory it launches with.
template <typename Kern>
cudaError_t tc_attrs(Kern kern, size_t smem, cudaFuncAttributes* a,
                     size_t* out_smem) {
  *out_smem = smem;
  return cudaFuncGetAttributes(a, kern);
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
    return (int)fwd_f32((const float*)q, (const float*)k, (const float*)v,
                        fm, fl, fo, om, ol, oo, bh, lq, lk, d, q_offset,
                        k_offset, causal, scale, s);
  if (dtype == 1) {
    if (!tc_shape_ok(bh, lq)) return (int)cudaErrorInvalidValue;
    if (d <= 64)
      return (int)fwd_tc<64, 128>(q, k, v, fm, fl, fo, om, ol, oo, bh, lq, lk,
                                  d, q_offset, k_offset, causal, scale, s);
    if (d <= 128)
      return (int)fwd_tc<128, 64>(q, k, v, fm, fl, fo, om, ol, oo, bh, lq,
                                  lk, d, q_offset, k_offset, causal, scale, s);
    if (d <= 192)
      return (int)fwd_tc<192, 64>(q, k, v, fm, fl, fo, om, ol, oo, bh, lq,
                                  lk, d, q_offset, k_offset, causal, scale, s);
    return (int)fwd_tc<256, 64>(q, k, v, fm, fl, fo, om, ol, oo, bh, lq, lk,
                                d, q_offset, k_offset, causal, scale, s);
  }
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
    return (int)bwd_dq_f32((const float*)q, (const float*)k, (const float*)v,
                           (const float*)dout, fl, fd, (float*)dq, bh, lq, lk,
                           d, q_offset, k_offset, causal, scale, s);
  if (dtype == 1) {
    if (!tc_shape_ok(bh, lq)) return (int)cudaErrorInvalidValue;
    if (d <= 64)
      return (int)bwd_dq_tc<64, 64>(q, k, v, dout, fl, fd, (float*)dq, bh, lq,
                                    lk, d, q_offset, k_offset, causal, scale,
                                    s);
    if (d <= 128)
      return (int)bwd_dq_tc<128, 64>(q, k, v, dout, fl, fd, (float*)dq, bh,
                                     lq, lk, d, q_offset, k_offset, causal,
                                     scale, s);
    if (d <= 192)
      return (int)bwd_dq_tc<192, 32>(q, k, v, dout, fl, fd, (float*)dq, bh,
                                     lq, lk, d, q_offset, k_offset, causal,
                                     scale, s);
    return (int)bwd_dq_tc<256, 32>(q, k, v, dout, fl, fd, (float*)dq, bh, lq,
                                   lk, d, q_offset, k_offset, causal, scale,
                                   s);
  }
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
    return (int)bwd_dkv_f32((const float*)q, (const float*)k,
                            (const float*)v, (const float*)dout, fl, fd,
                            (float*)dk, (float*)dv, bh, lq, lk, d, q_offset,
                            k_offset, causal, scale, s);
  if (dtype == 1) {
    if (!tc_shape_ok(bh, lq)) return (int)cudaErrorInvalidValue;
    if (d <= 64)
      return (int)bwd_dkv_tc<64, 64, false>(q, k, v, dout, fl, fd, (float*)dk,
                                            (float*)dv, bh, lq, lk, d,
                                            q_offset, k_offset, causal, scale,
                                            s);
    if (d <= 128)
      return (int)bwd_dkv_tc<128, 32, false>(q, k, v, dout, fl, fd,
                                             (float*)dk, (float*)dv, bh, lq,
                                             lk, d, q_offset, k_offset,
                                             causal, scale, s);
    return (int)bwd_dkv_tc<256, 32, true>(q, k, v, dout, fl, fd, (float*)dk,
                                          (float*)dv, bh, lq, lk, d,
                                          q_offset, k_offset, causal, scale,
                                          s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 B8 (kernel 0), B10 (kernel 1) or B9 (kernel 2) instantiation
// that runs at head dim d: out[0] registers per thread, out[1] local
// memory per thread (stack frame and spills), out[2] the dynamic shared
// memory it launches with.  Returns the error of cudaFuncGetAttributes.
int hvd_flash_tc_attributes(int kernel, int d, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  size_t smem;
  const int tier = d <= 64 ? 0 : d <= 128 ? 1 : d <= 192 ? 2 : 3;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if (kernel == 0) {
    err = tier == 0 ? tc_attrs(flash_fwd_tc_kernel<64, 128>,
                               fwd_tc_smem<64, 128>(), &a, &smem)
        : tier == 1 ? tc_attrs(flash_fwd_tc_kernel<128, 64>,
                               fwd_tc_smem<128, 64>(), &a, &smem)
        : tier == 2 ? tc_attrs(flash_fwd_tc_kernel<192, 64>,
                               fwd_tc_smem<192, 64>(), &a, &smem)
                    : tc_attrs(flash_fwd_tc_kernel<256, 64>,
                               fwd_tc_smem<256, 64>(), &a, &smem);
  } else if (kernel == 1) {
    err = tier == 0 ? tc_attrs(flash_bwd_dkv_tc_kernel<64, 64, false>,
                               dkv_tc_smem<64, 64, false>(), &a, &smem)
        : tier == 1 ? tc_attrs(flash_bwd_dkv_tc_kernel<128, 32, false>,
                               dkv_tc_smem<128, 32, false>(), &a, &smem)
                    : tc_attrs(flash_bwd_dkv_tc_kernel<256, 32, true>,
                               dkv_tc_smem<256, 32, true>(), &a, &smem);
  } else if (kernel == 2) {
    err = tier == 0 ? tc_attrs(flash_bwd_dq_tc_kernel<64, 64>,
                               dq_tc_smem<64, 64>(), &a, &smem)
        : tier == 1 ? tc_attrs(flash_bwd_dq_tc_kernel<128, 64>,
                               dq_tc_smem<128, 64>(), &a, &smem)
        : tier == 2 ? tc_attrs(flash_bwd_dq_tc_kernel<192, 32>,
                               dq_tc_smem<192, 32>(), &a, &smem)
                    : tc_attrs(flash_bwd_dq_tc_kernel<256, 32>,
                               dq_tc_smem<256, 32>(), &a, &smem);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  return 0;
}

}  // extern "C"

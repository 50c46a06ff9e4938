// Block-scaled codec kernels for Hopper (sm_90a): kernels B4-B7 of the
// port.
//
// Replace the Pallas kernels of horovod_tpu/ops/quantization.py:
//   hvd_quantize    <- _quantize_pallas_call   (:210) / _quant_kernel   (:165)
//   hvd_dequantize  <- _dequantize_pallas_call (:232) / _dequant_kernel (:176)
//   hvd_pack4       <- _pack4_pallas_call      (:496) / _pack4_kernel   (:469)
//   hvd_unpack4     <- _unpack4_pallas_call    (:519) / _unpack4_kernel (:481)
//
// Contract: bit-exact against the plain versions in ops/quantization.py
// (which follow _quantize_jnp, _dequantize_jnp, _quantize_pack4_jnp and
// _unpack_dequantize4_jnp operation by operation):
//   B4  inv = s > 0 ? 1/s : 0 (correctly rounded), q = clip(rint(x*inv),
//       -qmax, qmax) as int8.  rintf rounds half to even, as jnp.round and
//       torch.round do (roundf would move every .5 tie away from zero).
//   B5  x = float(q) * s, q int8 or int32 partial sums.
//   B6  B4's grid value, then byte = 16*q[half+i] + q[i] in int32,
//       narrowed to int8 (|16*7 + 7| <= 119 fits).
//   B7  lo = ((p + 8) & 15) - 8 (the floor-mod; C's % would break on
//       negative partial sums), hi = (p - lo) / 16 (exact), out
//       [lo*s | hi*s].
// Every float operation is an explicit round-to-nearest intrinsic, so
// nvcc cannot contract or approximate it.
//
// Bound: each is one pass over its block rows, so device-memory bandwidth
// bounds it.  B4 and B5 move 5 B per element (4 B float + 1 B int8) plus
// one 4 B scale per block: about 128.2 MB for ResNet-50's 25,557,032
// gradients in 99,833 blocks of 256, some 38 us at the H100 SXM's
// 3.35 TB/s; B6 and B7 move 4.5 B per element.  What the design does
// about it: one warp per block row (a grid-stride loop over rows, eight
// warps per CTA), the row's scale read once into a register, and 16-byte
// float4 loads or stores across the warp so every access is coalesced;
// each element is read and written exactly once, with no padding (the
// Pallas 32-row tile and the lane-replicated scales are TPU layout and
// are not carried over).  A row whose width is not a multiple of 4 (8
// for the packed forms), or a pointer not aligned for the vector width,
// takes a scalar loop.  Offsets are 64-bit: the
// transformer's 110,906,112 gradients are 433,227 rows of 256.
//
// Interface: plain C, one entry per kernel, loaded with ctypes.  Each
// returns cudaGetLastError() after the launch on the caller's stream;
// nothing is allocated and nothing is synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float inv_scale(float s) {
  return s > 0.0f ? __fdiv_rn(1.0f, s) : 0.0f;
}

__device__ __forceinline__ int quant(float x, float inv, float qmax) {
  float r = rintf(__fmul_rn(x, inv));
  r = fminf(fmaxf(r, -qmax), qmax);
  return __float2int_rn(r);
}

__device__ __forceinline__ float deq(int q, float s) {
  return __fmul_rn(__int2float_rn(q), s);
}

__device__ __forceinline__ int lo_nibble(int p) {
  return ((p + 8) & 15) - 8;
}

__device__ __forceinline__ int hi_nibble(int p, int lo) {
  return (p - lo) / 16;
}

// Rows are walked one warp each; `lane` strides the row.
#define FOR_EACH_ROW(nb)                                                  \
  const int lane = threadIdx.x & 31;                                      \
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);   \
       row < (nb); row += (int64_t)gridDim.x * kWarps)

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ s,
                                int8_t* __restrict__ q, int64_t nb,
                                int block, float qmax, bool vec) {
  FOR_EACH_ROW(nb) {
    const float inv = inv_scale(s[row]);
    const float* xr = x + row * block;
    int8_t* qr = q + row * block;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      char4* q4 = reinterpret_cast<char4*>(qr);
      for (int j = lane; j < (block >> 2); j += 32) {
        float4 v = x4[j];
        q4[j] = make_char4(quant(v.x, inv, qmax), quant(v.y, inv, qmax),
                           quant(v.z, inv, qmax), quant(v.w, inv, qmax));
      }
    } else {
      for (int j = lane; j < block; j += 32)
        qr[j] = (int8_t)quant(xr[j], inv, qmax);
    }
  }
}

template <typename Q>
__global__ void dequantize_kernel(const Q* __restrict__ q,
                                  const float* __restrict__ s,
                                  float* __restrict__ x, int64_t nb,
                                  int block, bool vec) {
  FOR_EACH_ROW(nb) {
    const float sc = s[row];
    const Q* qr = q + row * block;
    float* xr = x + row * block;
    if (vec) {
      float4* x4 = reinterpret_cast<float4*>(xr);
      for (int j = lane; j < (block >> 2); j += 32) {
        int a, b, c, d;
        if constexpr (sizeof(Q) == 1) {
          char4 v = reinterpret_cast<const char4*>(qr)[j];
          a = v.x; b = v.y; c = v.z; d = v.w;
        } else {
          int4 v = reinterpret_cast<const int4*>(qr)[j];
          a = v.x; b = v.y; c = v.z; d = v.w;
        }
        x4[j] = make_float4(deq(a, sc), deq(b, sc), deq(c, sc), deq(d, sc));
      }
    } else {
      for (int j = lane; j < block; j += 32) xr[j] = deq((int)qr[j], sc);
    }
  }
}

__device__ __forceinline__ int8_t pack(float lo, float hi, float inv,
                                       float qmax) {
  return (int8_t)(16 * quant(hi, inv, qmax) + quant(lo, inv, qmax));
}

__global__ void pack4_kernel(const float* __restrict__ x,
                             const float* __restrict__ s,
                             int8_t* __restrict__ p, int64_t nb, int block,
                             float qmax, bool vec) {
  const int half = block >> 1;
  FOR_EACH_ROW(nb) {
    const float inv = inv_scale(s[row]);
    const float* lo = x + row * block;
    const float* hi = lo + half;
    int8_t* pr = p + row * half;
    if (vec) {
      const float4* lo4 = reinterpret_cast<const float4*>(lo);
      const float4* hi4 = reinterpret_cast<const float4*>(hi);
      char4* p4 = reinterpret_cast<char4*>(pr);
      for (int j = lane; j < (half >> 2); j += 32) {
        float4 a = lo4[j], b = hi4[j];
        p4[j] = make_char4(pack(a.x, b.x, inv, qmax), pack(a.y, b.y, inv, qmax),
                           pack(a.z, b.z, inv, qmax), pack(a.w, b.w, inv, qmax));
      }
    } else {
      for (int j = lane; j < half; j += 32)
        pr[j] = pack(lo[j], hi[j], inv, qmax);
    }
  }
}

__global__ void unpack4_kernel(const int8_t* __restrict__ p,
                               const float* __restrict__ s,
                               float* __restrict__ x, int64_t nb,
                               int block, bool vec) {
  const int half = block >> 1;
  FOR_EACH_ROW(nb) {
    const float sc = s[row];
    const int8_t* pr = p + row * half;
    float* lo = x + row * block;
    float* hi = lo + half;
    if (vec) {
      const char4* p4 = reinterpret_cast<const char4*>(pr);
      float4* lo4 = reinterpret_cast<float4*>(lo);
      float4* hi4 = reinterpret_cast<float4*>(hi);
      for (int j = lane; j < (half >> 2); j += 32) {
        char4 v = p4[j];
        int a = lo_nibble(v.x), b = lo_nibble(v.y), c = lo_nibble(v.z),
            d = lo_nibble(v.w);
        lo4[j] = make_float4(deq(a, sc), deq(b, sc), deq(c, sc), deq(d, sc));
        hi4[j] = make_float4(deq(hi_nibble(v.x, a), sc),
                             deq(hi_nibble(v.y, b), sc),
                             deq(hi_nibble(v.z, c), sc),
                             deq(hi_nibble(v.w, d), sc));
      }
    } else {
      for (int j = lane; j < half; j += 32) {
        int v = pr[j], l = lo_nibble(v);
        lo[j] = deq(l, sc);
        hi[j] = deq(hi_nibble(v, l), sc);
      }
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

inline int blocks_for(int64_t nb) {
  int64_t b = (nb + kWarps - 1) / kWarps;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// 0 for an empty launch, an error code for a bad shape, else -1 (go on).
static int check_shape(int64_t nb, int block, bool even) {
  if (nb < 0 || block <= 0 || (even && block % 2))
    return (int)cudaErrorInvalidValue;
  return nb == 0 ? 0 : -1;
}

int hvd_quantize(const void* x, const void* s, void* q, int64_t nb,
                 int block, int qmax, void* stream) {
  int rc = check_shape(nb, block, false);
  if (rc >= 0) return rc;
  bool vec = block % 4 == 0 && aligned(x, 16) && aligned(q, 4);
  quantize_kernel<<<blocks_for(nb), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)s, (int8_t*)q, nb, block, (float)qmax,
      vec);
  return (int)cudaGetLastError();
}

// qdtype 0 = int8 values, 1 = int32 partial sums.
int hvd_dequantize(int qdtype, const void* q, const void* s, void* x,
                   int64_t nb, int block, void* stream) {
  int rc = check_shape(nb, block, false);
  if (rc >= 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (qdtype == 0) {
    bool vec = block % 4 == 0 && aligned(q, 4) && aligned(x, 16);
    dequantize_kernel<int8_t><<<blocks_for(nb), kThreads, 0, st>>>(
        (const int8_t*)q, (const float*)s, (float*)x, nb, block, vec);
  } else if (qdtype == 1) {
    bool vec = block % 4 == 0 && aligned(q, 16) && aligned(x, 16);
    dequantize_kernel<int32_t><<<blocks_for(nb), kThreads, 0, st>>>(
        (const int32_t*)q, (const float*)s, (float*)x, nb, block, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int hvd_pack4(const void* x, const void* s, void* p, int64_t nb, int block,
              int qmax, void* stream) {
  int rc = check_shape(nb, block, true);
  if (rc >= 0) return rc;
  bool vec = (block / 2) % 4 == 0 && aligned(x, 16) && aligned(p, 4);
  pack4_kernel<<<blocks_for(nb), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)s, (int8_t*)p, nb, block, (float)qmax,
      vec);
  return (int)cudaGetLastError();
}

int hvd_unpack4(const void* p, const void* s, void* x, int64_t nb,
                int block, void* stream) {
  int rc = check_shape(nb, block, true);
  if (rc >= 0) return rc;
  bool vec = (block / 2) % 4 == 0 && aligned(p, 4) && aligned(x, 16);
  unpack4_kernel<<<blocks_for(nb), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)p, (const float*)s, (float*)x, nb, block, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"

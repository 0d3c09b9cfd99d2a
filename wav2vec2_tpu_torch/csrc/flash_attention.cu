// Fused attention with the Transformer-XL relative-position term (K5) for
// Hopper (sm_90a).
//
// Replaces wav2vec2_tpu/ops/flash_attention.py::_attn_kernel, the TPU
// kernel that the conformer rel-pos encoder launches once per layer. For one
// (batch, head) it computes, with f32 scores, softmax and accumulation,
//
//   s[i, k] = (q[i]·k[k] + q_pos[i]·R[h, T_pad - i + k]) * scale + mask[k]
//   out[i]  = Σ_k round_v(softmax_k(s[i, :])) · v[k]
//
// where R is the reversed projected-sinusoid table of `rel_table_rev`
// ([NH, 2·T_pad, hd]) and the bd term (q_pos·R) is present only when the
// caller passes R ("rel" mode); mask is an optional [B, T_pad] additive key
// mask (0 / -inf). Both modes, with and without the mask, share one kernel.
//
// The TPU kernel needs a shear (eight masked rolls, a Mosaic limit) to turn
// its [BLOCK_Q, T_pad + BLOCK_Q] position product into bd[i, k]. Here the
// shear is an index: score (i, k) reads row m = T_pad - i + k of R[h]. For a
// 64-row query tile starting at i0 and a 64-key tile starting at k0 those
// rows are one contiguous window of 127 rows starting at
// T_pad - i0 - 63 + k0, staged in shared memory beside the K and V tiles;
// row (63 - ii + kk) of the window serves local query ii and key kk. Every
// row read lies in [1, 2·T_pad).
//
// What bounds it on this card: 6·T_pad²·hd FLOPs per (batch, head) (q·kᵀ,
// the bd term, P·V) against about 10·T_pad·hd bytes per (batch, head), so
// on the tensor cores it would be bound by operations. This first version
// is simple and exact instead: every product is an f32 FMA on the CUDA
// cores (no TF32, no tensor cores, no fast-math, `expf`), so it is bound by
// the CUDA cores' f32 rate and the shared-memory reads that feed them,
// far above the tensor-core bound.
//
// Design, kept simple:
// - one block of 256 threads per (64-row query tile, head, batch); the
//   block streams 64-key tiles with an online softmax: a running max and sum
//   per query row in f32;
// - q and q_pos are staged once, K, V and the R window once per key tile,
//   all in the input dtype with a padded row stride (no bank conflicts);
//   head dims below the template width are zero-filled;
// - each thread owns a 4 x 4 block of the score tile (rows ty + 16a,
//   columns tx + 16c) and a 4 x HD/16 block of the output accumulator
//   (rows ty + 16a, columns tx + 16c), both in registers;
// - softmax: four lanes per row, shuffles for the row max and sum; the
//   probabilities are rounded to v's dtype before P·V, as the TPU kernel
//   rounds `attn` (here relative to the running max; the row sum stays f32
//   and unrounded, and the output is divided by it once at the end).
// Later work (PERF.md ranks it): wgmma tiles fed by TMA, warp
// specialization, and bf16 scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per streamed tile
constexpr int WIN = BQ + BK - 1;     // rows of the R window per key tile
constexpr int THREADS = 256;
constexpr int LDS = BK + 4;          // row stride of the score tile (floats)

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row stride of the staged tiles, in elements: an odd number of 32-bit
// words, so the 16 rows a warp reads at one column fall in 16 banks.
template <typename T, int HD>
__host__ __device__ constexpr int tile_ld() { return HD + (sizeof(T) == 4 ? 1 : 2); }

__host__ __device__ constexpr size_t round_up16(size_t x) { return (x + 15) / 16 * 16; }

template <typename T, int HD>
size_t smem_bytes_t(bool rel) {
  const size_t rows = BQ + 2 * BK + (rel ? BQ + WIN : 0);  // q, k, v[, q_pos, R]
  return round_up16(rows * tile_ld<T, HD>() * sizeof(T)) +
         static_cast<size_t>(BQ) * LDS * sizeof(float) +   // scores, then P
         3 * BQ * sizeof(float);                           // row max, sum, rescale
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ q_pos,
                       const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ rel_r,
                       const float* __restrict__ mask, T* __restrict__ out,
                       int nh, int t_pad, int hd, float scale) {
  constexpr int LD = tile_ld<T, HD>();
  constexpr int NC = HD / 16;  // output columns per thread
  const bool rel = rel_r != nullptr;
  const float neg = -CUDART_INF_F;
  const T zero = from_f32<T>(0.0f);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BQ * LD;
  T* vs = ks + BK * LD;
  T* qps = vs + BK * LD;  // rel only
  T* rs = qps + BQ * LD;  // rel only: the WIN-row window of R[h]
  const size_t rows = BQ + 2 * BK + (rel ? BQ + WIN : 0);
  float* ss = reinterpret_cast<float*>(smem_raw + round_up16(rows * LD * sizeof(T)));
  float* row_max = ss + BQ * LDS;
  float* row_sum = row_max + BQ;
  float* row_scale = row_sum + BQ;

  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * nh + h) * t_pad * hd;
  const T* r_h = rel ? rel_r + static_cast<size_t>(h) * 2 * t_pad * hd : nullptr;
  const float* mask_b = mask ? mask + static_cast<size_t>(b) * t_pad : nullptr;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    const size_t g = head + static_cast<size_t>(i0 + r) * hd + c;
    qs[r * LD + c] = c < hd ? q[g] : zero;
    if (rel) qps[r * LD + c] = c < hd ? q_pos[g] : zero;
  }
  if (tid < BQ) {
    row_max[tid] = neg;
    row_sum[tid] = 0.0f;
  }

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;
  }

  for (int k0 = 0; k0 < t_pad; k0 += BK) {
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      const size_t g = head + static_cast<size_t>(k0 + r) * hd + c;
      ks[r * LD + c] = c < hd ? k[g] : zero;
      vs[r * LD + c] = c < hd ? v[g] : zero;
    }
    if (rel) {
      const int m_base = t_pad - i0 - (BQ - 1) + k0;  // >= 1
      for (int e = tid; e < WIN * HD; e += THREADS) {
        const int r = e / HD, c = e % HD;
        rs[r * LD + c] = c < hd ? r_h[static_cast<size_t>(m_base + r) * hd + c] : zero;
      }
    }
    __syncthreads();

    // scores of this thread's 4 x 4 block: rows ty + 16a, keys tx + 16c
    float ac[4][4], bd[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) ac[a][c] = bd[a][c] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = to_f32(qs[(ty + 16 * a) * LD + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = to_f32(ks[(tx + 16 * c) * LD + d]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) ac[a][c] = fmaf(qv[a], kv[c], ac[a][c]);
      }
    }
    if (rel) {
      // window row of (ty + 16a, tx + 16c) is 63 - ty + tx + 16(c - a):
      // seven distinct rows per thread and column
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[4], rv[7];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = to_f32(qps[(ty + 16 * a) * LD + d]);
#pragma unroll
        for (int u = 0; u < 7; ++u) {
          rv[u] = to_f32(rs[((BQ - 1) - ty + tx + 16 * (u - 3)) * LD + d]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) bd[a][c] = fmaf(qv[a], rv[c - a + 3], bd[a][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kk = tx + 16 * c;
      const float m = mask_b ? mask_b[k0 + kk] : 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        // the TPU kernel's op order: (ac + bd) * scale, then the mask
        float s = __fmul_rn(__fadd_rn(ac[a][c], bd[a][c]), scale);
        if (mask_b) s = __fadd_rn(s, m);
        ss[(ty + 16 * a) * LDS + kk] = s;
      }
    }
    __syncthreads();

    // online softmax: four lanes per row, lane `part` takes keys part + 4j
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* srow = ss + r * LDS;
      const float m_old = row_max[r];
      float mx = neg;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) mx = fmaxf(mx, srow[part + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == neg ? 0.0f : m_new;  // a row masked so far
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float p = expf(srow[part + 4 * j] - m_use);
        sum += p;
        srow[part + 4 * j] = to_f32(from_f32<T>(p));  // rounded as v
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_use);
        row_scale[r] = alpha;
        row_sum[r] = fmaf(row_sum[r], alpha, sum);
        row_max[r] = m_new;
      }
    }
    __syncthreads();

    // P · V into this thread's rows ty + 16a, columns tx + 16c
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = row_scale[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = ss[(ty + 16 * a) * LDS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = to_f32(vs[j * LD + tx + 16 * c]);
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pv[a], vv, acc[a][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float l = row_sum[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) {
        out[head + static_cast<size_t>(i0 + r) * hd + col] = from_f32<T>(acc[a][c] / l);
      }
    }
  }
}

template <typename T, int HD>
int launch_t(const void* q, const void* q_pos, const void* k, const void* v,
             const void* rel_r, const void* mask, void* out, int batch, int nh,
             int t_pad, int hd, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_t<T, HD>(rel_r != nullptr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(t_pad / BQ, nh, batch);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(q_pos),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(rel_r), static_cast<const float*>(mask),
      static_cast<T*>(out), nh, t_pad, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// The template width that serves head dim `hd` (0 when none does).
int template_width(int hd) {
  if (hd < 1) return 0;
  if (hd <= 16) return 16;
  if (hd <= 32) return 32;
  if (hd <= 64) return 64;
  if (hd <= 128) return 128;
  return 0;
}

template <typename T>
size_t smem_for(int hd, bool rel) {
  switch (template_width(hd)) {
    case 16: return smem_bytes_t<T, 16>(rel);
    case 32: return smem_bytes_t<T, 32>(rel);
    case 64: return smem_bytes_t<T, 64>(rel);
    case 128: return smem_bytes_t<T, 128>(rel);
    default: return 0;
  }
}

template <typename T>
int launch_for(const void* q, const void* q_pos, const void* k, const void* v,
               const void* rel_r, const void* mask, void* out, int batch, int nh,
               int t_pad, int hd, float scale, cudaStream_t stream) {
  switch (template_width(hd)) {
    case 16: return launch_t<T, 16>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 32: return launch_t<T, 32>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 64: return launch_t<T, 64>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 128: return launch_t<T, 128>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one block needs for head dim `hd`, element size
// `elem_bytes` (4 = f32, 2 = bf16) and rel mode; 0 if no template serves
// that head dim (hd outside [1, 128]) or the element size.
extern "C" size_t flash_attention_smem_bytes(int hd, int elem_bytes, int rel) {
  if (elem_bytes == 4) return smem_for<float>(hd, rel != 0);
  if (elem_bytes == 2) return smem_for<__nv_bfloat16>(hd, rel != 0);
  return 0;
}

// Launches K5 on `stream`. All pointers are device pointers to contiguous
// tensors of the element type `elem_bytes` gives (4 = f32, 2 = bf16):
// q, k, v [B, NH, T_pad, hd] and out (same shape, written); q_pos (same
// shape) and rel_r [NH, 2·T_pad, hd] both null, or both set (rel mode);
// mask [B, T_pad] f32, or null. T_pad must be a multiple of 64. Returns
// cudaGetLastError() after the launch (0 = launched); does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* q_pos,
                                      const void* k, const void* v,
                                      const void* rel_r, const void* mask,
                                      void* out, int batch, int nh, int t_pad,
                                      int hd, int elem_bytes, float scale,
                                      void* stream) {
  if (batch <= 0 || nh <= 0 || t_pad <= 0) return 0;
  if (t_pad % BQ != 0 || (q_pos == nullptr) != (rel_r == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return launch_for<float>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, s);
  }
  if (elem_bytes == 2) {
    return launch_for<__nv_bfloat16>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd,
                                     scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Fused attention with the Transformer-XL relative-position term (K5) for
// Hopper (sm_90a).
//
// Replaces wav2vec2_tpu/ops/flash_attention.py::_attn_kernel, the TPU
// kernel that the conformer rel-pos encoder launches once per layer. For one
// (batch, head) it computes, with f32 scores, softmax and accumulation,
//
//   s[i, k] = (q[i]·k[k] + q_pos[i]·R[h, T_pad - i + k]) * scale + mask[k]
//   out[i]  = Σ_k round_v(p[i, k]) · v[k] / Σ_k p[i, k]   (online softmax)
//
// where R is the reversed projected-sinusoid table of `rel_table_rev`
// ([NH, 2·T_pad, hd]) and the bd term (q_pos·R) is present only when the
// caller passes R ("rel" mode); mask is an optional [B, T_pad] additive key
// mask (0 / -inf). A row masked so far uses 0 as its running max, so it
// gives no NaN.
//
// What bounds it on this card: 6·T_pad²·hd operations per (batch, head)
// (q·kᵀ, the bd term, P·V) against about 10·T_pad·hd bytes, so on the
// tensor cores it is bound by operations (989 TFLOP/s dense bf16).
//
// Two kernels, picked by dtype (the wrapper, ops/flash_attention.py):
//
// bf16 — `flash_attention_mma_kernel`, on the tensor cores, as the TPU's
//   bf16 path multiplies bf16 operands into f32 on the MXU at
//   Precision.DEFAULT:
//   - mma.sync.m16n8k16 (bf16 operands, f32 accumulators) for all three
//     products, operands loaded with ldmatrix from shared memory tiles with
//     a padded row stride (no bank conflicts); warps of 16 query rows, 8
//     of them (128 rows a block) up to head dim 64 and 4 (64 rows) at 128;
//     grid T_pad/rows x NH x B;
//   - K, V and the R window of key tile j+1 stream in with cp.async into
//     the second of two stages while tile j computes; q and q_pos are
//     loaded once; columns past hd are zero-filled once;
//   - the Transformer-XL term as matmul-then-shear, the TPU kernel's own
//     shape: for a warp's 16 rows from i_w and the key tile from k0, the
//     rows of R read form one window of 16 + 64 rows from
//     T_pad - i_w - 15 + k0 (>= 1); P2 = q_pos[16, hd] · R_win[80, hd]ᵀ is
//     one mma chain into f32, stored sheared into a per-warp [16, 64]
//     shared-memory tile (bd[ii, kk] = P2[ii, 15 - ii + kk]), from which
//     each thread reads bd at its own accumulator positions. It costs
//     80/64 of the bd term's per-diagonal operations, on tensor cores; the
//     block stages its warps' windows as one window of rows + 64 rows;
//   - the key tile's f32 mask streams in with K and V;
//   - online softmax in registers, exponentials by ex2.approx (__expf):
//     each thread holds two rows of the score tile and reduces max and sum
//     over the four lanes that share a row;
//     p is rounded to bf16 and goes to P·V from registers (the score
//     accumulator's layout is the A operand's), V is read with
//     ldmatrix.trans. The f32 row sum is of the unrounded p, and the
//     output is divided by it once at the end.
//   This is the mma.sync form of the design; wgmma tiles fed by TMA with
//   warp specialization are the next step (ROADMAP.md).
//
// f32 — `flash_attention_fma_kernel`, exact: every product is an f32 FMA on
//   the CUDA cores (no TF32, no tensor cores, no fast-math, `expf`), for
//   the TPU's Precision.HIGHEST path that the f32 parity forward uses. One
//   block of 256 threads per (64-row query tile, head, batch) streams
//   64-key tiles; q, k, v, q_pos and the 127-row R window are staged in
//   shared memory; each thread owns a 4 x 4 block of the score tile and a
//   4 x HD/16 block of the output, in registers; the window row of
//   (ty + 16a, tx + 16c) is 63 - ty + tx + 16(c - a), seven distinct rows
//   per thread and column; softmax with four lanes per row.
//
// Both serve head dims 16, 32, 64 and 128 by template, zero-filling the
// columns past hd (hd = 80 goes through the 128 template).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ---- f32: exact FMAs on the CUDA cores (the TPU's HIGHEST path) --------

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per streamed tile
constexpr int WIN = BQ + BK - 1;     // rows of the R window per key tile
constexpr int THREADS = 256;
constexpr int LDS = BK + 4;          // row stride of the score tile (floats)

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
flash_attention_fma_kernel(const T* __restrict__ q, const T* __restrict__ q_pos,
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
        flash_attention_fma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(t_pad / BQ, nh, batch);
  flash_attention_fma_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
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



// ---- bf16: tensor cores (mma.sync m16n8k16, f32 accumulation) ----------

namespace mma_k5 {

constexpr int BK = 64;            // keys per streamed tile
constexpr int WROWS = 16 + BK;    // R rows one warp multiplies (79 read)
constexpr int BD_LD = BK + 8;     // row stride of a warp's sheared bd tile

// Warps of 16 query rows a block: 8 (128 rows) up to head dim 64, which
// halves the K, V and R-window loads per query row against 64-row blocks;
// 4 (64 rows) at 128, where two stages of 128-row blocks would not fit.
template <int HD>
__host__ __device__ constexpr int warps() { return HD <= 64 ? 8 : 4; }
template <int HD>
__host__ __device__ constexpr int block_q() { return 16 * warps<HD>(); }
template <int HD>
__host__ __device__ constexpr int threads() { return 32 * warps<HD>(); }
// R rows staged per tile (block_q + 63 read)
template <int HD>
__host__ __device__ constexpr int r_win() { return block_q<HD>() + BK; }

// Row stride of the bf16 tiles, in elements: 16 bytes past a multiple of
// 128, so the eight 16-byte rows an ldmatrix phase reads fall in distinct
// bank groups.
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }

// q[, q_pos], then two stages of K, V[, R window], then the bd tiles, then
// two stages of the key tile's f32 mask.
template <int HD>
size_t smem_bytes(bool rel) {
  const size_t rows = static_cast<size_t>(block_q<HD>()) * (rel ? 2 : 1) +
                      2 * (2 * BK + (rel ? r_win<HD>() : 0));
  return rows * ld<HD>() * sizeof(__nv_bfloat16) +
         (rel ? static_cast<size_t>(warps<HD>()) * 16 * BD_LD * sizeof(float) : 0) +
         2 * BK * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a · b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + n) of a [rows_total, hd] bf16 tensor into `dst`
// (row stride LD), the first ceil(hd / 8) 16-byte chunks of each row; rows
// at or past `rows_total` become zeros. Thread `tid` takes chunk tid % (HD
// / 8) of every (threads / (HD / 8))-th row: no division in the loop.
// `vec`: hd % 8 == 0 and the tensor 16-byte aligned, so each chunk is one
// cp.async; otherwise element loads.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n, int rows_total, int hd, bool vec) {
  constexpr int LD = ld<HD>();
  constexpr int CH = HD / 8;
  constexpr int ROW_STEP = threads<HD>() / CH;
  const int c = (threadIdx.x % CH) * 8;
  if (c >= hd) return;  // a chunk wholly past hd: zero-filled once
  for (int r = threadIdx.x / CH; r < n; r += ROW_STEP) {
    __nv_bfloat16* d = dst + r * LD + c;
    const int row = row0 + r;
    if (row >= rows_total) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (vec) {
      __pipeline_memcpy_async(d, src + static_cast<size_t>(row) * hd + c, 16);
    } else {
      const __nv_bfloat16* g = src + static_cast<size_t>(row) * hd;
#pragma unroll
      for (int u = 0; u < 8; ++u) d[u] = c + u < hd ? g[c + u] : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(threads<HD>())
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ q_pos,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ rel_r,
                           const float* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                           int nh, int t_pad, int hd, float scale) {
  constexpr int LD = ld<HD>();
  constexpr int WARPS = warps<HD>();
  constexpr int BQ = block_q<HD>();
  constexpr int THREADS = threads<HD>();
  constexpr int RWIN = r_win<HD>();
  constexpr int KT = HD / 16;  // k-steps of the q·kᵀ and bd products
  constexpr int NO = HD / 8;   // n-tiles of the output
  const bool rel = rel_r != nullptr;
  const float neg = -CUDART_INF_F;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qps = qs + BQ * LD;                       // rel only
  __nv_bfloat16* stage0 = qps + (rel ? BQ * LD : 0);
  const int stage_rows = 2 * BK + (rel ? RWIN : 0);        // K, V[, R]
  const int all_rows = BQ * (rel ? 2 : 1) + 2 * stage_rows;
  float* bd_all = reinterpret_cast<float*>(qs + all_rows * LD);
  float* mask_s = bd_all + (rel ? WARPS * 16 * BD_LD : 0);  // [2][BK]

  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * nh + h) * t_pad * hd;
  const __nv_bfloat16* r_h = rel ? rel_r + static_cast<size_t>(h) * 2 * t_pad * hd : nullptr;
  const float* mask_b = mask ? mask + static_cast<size_t>(b) * t_pad : nullptr;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;  // accumulator row, column pair
  const bool mask_vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const bool vec = (hd & 7) == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(q_pos) |
                     reinterpret_cast<uintptr_t>(rel_r)) & 15) == 0;

  // columns past hd: zeros, once, in every tile of every stage
  {
    const int c0 = (hd + 7) >> 3, per_row = HD / 8 - c0;
    for (int e = tid; e < all_rows * per_row; e += THREADS) {
      const int r = e / per_row, c = (c0 + e - r * per_row) << 3;
      *reinterpret_cast<uint4*>(qs + r * LD + c) = make_uint4(0, 0, 0, 0);
    }
  }
  load_rows<HD>(qs, q + head, i0, BQ, t_pad, hd, vec);
  if (rel) load_rows<HD>(qps, q_pos + head, i0, BQ, t_pad, hd, vec);

  auto start_tile_loads = [&](int j) {
    __nv_bfloat16* ks = stage0 + (j & 1) * stage_rows * LD;
    const int k0 = j * BK;
    load_rows<HD>(ks, k + head, k0, BK, t_pad, hd, vec);
    load_rows<HD>(ks + BK * LD, v + head, k0, BK, t_pad, hd, vec);
    // the block's window: rows T_pad - i0 - (BQ - 1) + k0 + [0, BQ + 64);
    // the last one (never read) may lie past the table, and is zeroed
    if (rel) load_rows<HD>(ks + 2 * BK * LD, r_h, t_pad - i0 - (BQ - 1) + k0, RWIN, 2 * t_pad,
                           hd, vec);
    if (mask_b) {
      float* ms = mask_s + (j & 1) * BK;
      if (mask_vec) {
        if (tid < BK / 4) __pipeline_memcpy_async(ms + 4 * tid, mask_b + k0 + 4 * tid, 16);
      } else if (tid < BK) {
        ms[tid] = mask_b[k0 + tid];
      }
    }
    __pipeline_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_run[2] = {neg, neg}, l_run[2] = {0.0f, 0.0f};
  float* bd = bd_all + warp * 16 * BD_LD;
  const __nv_bfloat16* q_w = qs + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8;
  const __nv_bfloat16* qp_w = qps + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8;
  // B-operand rows of an ldmatrix.x4 over 16 rows (n) x 16 columns (k)
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_col = ((lane >> 3) & 1) * 8;
  // V with .trans: 16 keys (k) x 16 columns (n)
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  const int n_tiles = t_pad / BK;
  start_tile_loads(0);  // one group with q and q_pos
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      start_tile_loads(j + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const __nv_bfloat16* ks = stage0 + (j & 1) * stage_rows * LD;
    const __nv_bfloat16* vs = ks + BK * LD;
    const float* ms = mask_s + (j & 1) * BK;

    float s[8][4];
    if (rel) {
      // P2 = q_pos[16 rows of this warp] · R_win[80 rows]ᵀ; this warp's 80
      // rows start 16 * (WARPS - 1 - warp) rows into the block's window
      const __nv_bfloat16* rw = ks + 2 * BK * LD + 16 * (WARPS - 1 - warp) * LD;
      float p2[WROWS / 8][4];
#pragma unroll
      for (int n = 0; n < WROWS / 8; ++n) p2[n][0] = p2[n][1] = p2[n][2] = p2[n][3] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t a[4];
        ldmatrix_x4(a, qp_w + kt * 16);
#pragma unroll
        for (int np = 0; np < WROWS / 16; ++np) {
          uint32_t bb[4];
          ldmatrix_x4(bb, rw + (np * 16 + b_row) * LD + kt * 16 + b_col);
          mma_bf16(p2[2 * np], a, bb[0], bb[1]);
          mma_bf16(p2[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // shear on the way to shared memory: P2[ii, jj] is bd[ii, jj - 15 + ii]
#pragma unroll
      for (int n = 0; n < WROWS / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = g + (e >> 1) * 8;
          const int kk = n * 8 + 2 * q4 + (e & 1) - 15 + ii;
          if (kk >= 0 && kk < BK) bd[ii * BD_LD + kk] = p2[n][e];
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t a[4];
      ldmatrix_x4(a, q_w + kt * 16);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4(bb, ks + (np * 16 + b_row) * LD + kt * 16 + b_col);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // the TPU kernel's op order: (ac + bd) * scale, then the mask
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int kk = n * 8 + 2 * q4;
      float2 m = make_float2(0.0f, 0.0f);
      if (mask_b) m = *reinterpret_cast<const float2*>(ms + kk);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float b0 = 0.0f, b1 = 0.0f;
        if (rel) {
          const float2 bv = *reinterpret_cast<const float2*>(bd + (g + 8 * hh) * BD_LD + kk);
          b0 = bv.x;
          b1 = bv.y;
        }
        float x0 = __fmul_rn(__fadd_rn(s[n][2 * hh], b0), scale);
        float x1 = __fmul_rn(__fadd_rn(s[n][2 * hh + 1], b1), scale);
        if (mask_b) {
          x0 = __fadd_rn(x0, m.x);
          x1 = __fadd_rn(x1, m.y);
        }
        s[n][2 * hh] = x0;
        s[n][2 * hh + 1] = x1;
      }
    }
    if (rel) __syncwarp();  // bd read before the next tile writes it

    // online softmax; rows g (hh = 0) and g + 8 (hh = 1), each spread over
    // the four lanes 4g..4g+3
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = neg;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      const float m_use = m_new == neg ? 0.0f : m_new;  // a row masked so far
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __expf(s[n][2 * hh + e] - m_use);
          sum += p;
          s[n][2 * hh + e] = p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = __expf(m_run[hh] - m_use);
      l_run[hh] = fmaf(l_run[hh], alpha, sum);
      m_run[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // P · V: p rounded to bf16 as the A operand, from the score registers
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      a[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      a[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      a[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vs + (kt * 16 + v_row) * LD + np * 16 + v_col);
        mma_bf16(o[2 * np], a, bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is free for tile j + 2
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = i0 + 16 * warp + g + 8 * hh;
    const float l = l_run[hh];
    __nv_bfloat16* row = out + head + static_cast<size_t>(r) * hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * q4 + e;
        if (col < hd) row[col] = __float2bfloat16_rn(o[n][2 * hh + e] / l);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* q_pos, const void* k, const void* v, const void* rel_r,
           const void* mask, void* out, int batch, int nh, int t_pad, int hd, float scale,
           cudaStream_t stream) {
  if (t_pad % block_q<HD>() != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<HD>(rel_r != nullptr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_mma_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(t_pad / block_q<HD>(), nh, batch);
  flash_attention_mma_kernel<HD><<<grid, threads<HD>(), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(q_pos),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(rel_r), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), nh, t_pad, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

size_t smem_for(int hd, bool rel) {
  switch (template_width(hd)) {
    case 16: return smem_bytes<16>(rel);
    case 32: return smem_bytes<32>(rel);
    case 64: return smem_bytes<64>(rel);
    case 128: return smem_bytes<128>(rel);
    default: return 0;
  }
}

int launch_for(const void* q, const void* q_pos, const void* k, const void* v,
               const void* rel_r, const void* mask, void* out, int batch, int nh, int t_pad,
               int hd, float scale, cudaStream_t stream) {
  switch (template_width(hd)) {
    case 16: return launch<16>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 32: return launch<32>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 64: return launch<64>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 128: return launch<128>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mma_k5

}  // namespace

// Shared memory one block needs for head dim `hd` and rel mode, in the
// kernel the element size routes to (4 = f32: the FMA kernel; 2 = bf16:
// the tensor-core kernel); 0 if no template serves that head dim (hd
// outside [1, 128]) or the element size.
extern "C" size_t flash_attention_smem_bytes(int hd, int elem_bytes, int rel) {
  if (elem_bytes == 4) return smem_for<float>(hd, rel != 0);
  if (elem_bytes == 2) return mma_k5::smem_for(hd, rel != 0);
  return 0;
}

static int check_args(int t_pad, const void* q_pos, const void* rel_r) {
  if (t_pad % BQ != 0 || (q_pos == nullptr) != (rel_r == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Launchers of K5 on `stream`. All pointers are device pointers to
// contiguous tensors, f32 for the FMA kernel and bf16 for the tensor-core
// kernel: q, k, v [B, NH, T_pad, hd] and out (same shape, written); q_pos
// (same shape) and rel_r [NH, 2·T_pad, hd] both null, or both set (rel
// mode); mask [B, T_pad] f32, or null. T_pad must be a multiple of 64 (of
// 128 for the tensor-core kernel at head dims up to 64). Each
// returns cudaGetLastError() after the launch (0 = launched) and does not
// synchronise.
extern "C" int flash_attention_fma_launch(const void* q, const void* q_pos, const void* k,
                                          const void* v, const void* rel_r, const void* mask,
                                          void* out, int batch, int nh, int t_pad, int hd,
                                          float scale, void* stream) {
  if (batch <= 0 || nh <= 0 || t_pad <= 0) return 0;
  if (int err = check_args(t_pad, q_pos, rel_r)) return err;
  return launch_for<float>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_mma_launch(const void* q, const void* q_pos, const void* k,
                                          const void* v, const void* rel_r, const void* mask,
                                          void* out, int batch, int nh, int t_pad, int hd,
                                          float scale, void* stream) {
  if (batch <= 0 || nh <= 0 || t_pad <= 0) return 0;
  if (int err = check_args(t_pad, q_pos, rel_r)) return err;
  return mma_k5::launch_for(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale,
                            static_cast<cudaStream_t>(stream));
}

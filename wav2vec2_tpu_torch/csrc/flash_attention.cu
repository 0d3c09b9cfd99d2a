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
// bf16 — `flash_attention_wgmma_kernel`, on the tensor cores through wgmma,
//   as the TPU's bf16 path multiplies bf16 operands into f32 on the MXU at
//   Precision.DEFAULT. A block of 384 threads takes 128 query rows of one
//   (batch, head); grid T_pad/128 x NH x B:
//   - warp specialisation: warpgroup 2 is the producer (setmaxnreg down to
//     24 registers; one thread issues every copy), warpgroups 0 and 1 are
//     the consumers (setmaxnreg up to 240), 64 query rows each;
//   - a two-stage ring in shared memory, each stage one key tile of K, V,
//     with rel the R window, and the tile's f32 mask, loaded by TMA
//     (cp.async.bulk.tensor, 3-d maps over [B·NH, T_pad, hd] and
//     [NH, 2·T_pad, hd] built on the host per launch) and a bulk copy for
//     the mask; a full and an empty mbarrier per stage: the producer waits
//     on empty, the consumers on full, and each consumer warp arrives on
//     empty once its last wgmma on the stage has retired (wgmma.wait_group)
//     and its mask reads are done. q and q_pos are loaded once;
//   - no zero-filled head dims: hd 16, 32 and 64 are one column chunk, 80
//     is 64 + 16 and 128 is 64 + 64; each chunk is its own TMA box, swizzled
//     by its row span (128, 64 or 32 bytes), with its own wgmma descriptors;
//     k-steps of 16 columns run over the chunks (5 at hd 80);
//   - S = q·Kᵀ is wgmma m64nBKk16 with both operands in shared memory
//     (K-major); P·V takes A = p rounded to bf16 from the score registers
//     (the accumulator's layout is the A fragment's) and B = V from shared
//     memory through the descriptor's transpose bit (MN-major), one wgmma
//     per column chunk; f32 accumulators throughout;
//   - the Transformer-XL term as matmul-then-shear on the tensor cores: for
//     a warpgroup's 64 rows from i_w and the key tile from k0, the rows of R
//     read form one window of 64 + BK rows from T_pad - i_w - 63 + k0 (>= 1);
//     P2 = q_pos[64, hd] · R_win[64 + BK, hd]ᵀ is one wgmma chain, issued
//     before S's, and sheared (bd[ii, kk] = P2[ii, 63 - ii + kk]) through a
//     per-warp [16, BK + 8] f32 slab, from which each thread reads bd at
//     its own score positions. The block stages both warpgroups' windows
//     as one of 128 + BK rows. BK = 64 keys with rel (the window costs
//     (64 + 64) / 64 = 2x the bd term's per-diagonal operations; 128 keys
//     would cost 1.5x but hold S, P2 and O in 192 registers a thread and
//     spill), 32 at hd 128 (3x), where two stages would not fit in shared
//     memory; 128 for plain attention;
//   - online softmax in registers, p = ex2.approx(s·log2 e − m·log2 e)
//     (one FMA and the SFU a score): each thread holds two rows of the
//     score tile and reduces max and sum over the four lanes that share a
//     row; the f32 row sum is of the unrounded p, and the output is
//     divided by it once at the end;
//   - one key tile at a time: each consumer warpgroup waits for its scores,
//     softmaxes them, then runs P·V; the two warpgroups drift apart, so one
//     computes on the tensor cores while the other works on the CUDA cores.
//     (Issuing the next tile's scores before P·V, as FlashAttention-3 does,
//     made ptxas serialise the wgmma chain (C7514) and ran 11-65% slower
//     on an H100.)
//
// f32 — `flash_attention_fma_kernel`, exact: every product is an f32 FMA on
//   the CUDA cores (no TF32, no tensor cores, no fast-math, `expf`), for
//   the TPU's Precision.HIGHEST path that the f32 parity forward uses. One
//   block of 256 threads per (64-row query tile, head, batch) streams
//   64-key tiles; q, k, v, q_pos and the 127-row R window are staged in
//   shared memory; each thread owns a 4 x 4 block of the score tile and a
//   4 x HD/16 block of the output, in registers; the window row of
//   (ty + 16a, tx + 16c) is 63 - ty + tx + 16(c - a), seven distinct rows
//   per thread and column; softmax with four lanes per row. It serves head
//   dims 1..128 by templates of width 16, 32, 64 and 128, zero-filling the
//   columns past hd.

#include <cuda.h>
#include <cuda_bf16.h>
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



// ---- bf16: wgmma fed by TMA, warp-specialised (Hopper) -----------------

namespace wg_k5 {

constexpr int BQ = 128;           // query rows a block: two consumer warpgroups of 64
constexpr int STAGES = 2;         // the K, V[, R window] ring
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2

// The head dims served (16, 32, 64, 80, 128), each cut into column chunks
// of at most 64 bf16 (128 bytes: one TMA box and one swizzle atom wide):
// 16, 32 and 64 are one chunk; 80 is 64 + 16 and 128 is 64 + 64. No column
// past hd is stored or multiplied.
template <int HD>
struct Cols {
  static constexpr int W0 = HD < 64 ? HD : 64;
  static constexpr int W1 = HD - W0;  // 0, 16 or 64
  static constexpr int N = W1 ? 2 : 1;
  __host__ __device__ static constexpr int width(int c) { return c == 0 ? W0 : W1; }
  // byte offset of chunk c in a tile of `rows` rows (chunk 0 first)
  __host__ __device__ static constexpr uint32_t off(int rows, int c) {
    return c == 0 ? 0u : static_cast<uint32_t>(rows * W0 * 2);
  }
  // registers of the output accumulator before chunk c's
  __host__ __device__ static constexpr int reg(int c) { return c == 0 ? 0 : W0 / 2; }
};

// Shared memory of one block, from its 1024-aligned base: q[, q_pos]; the
// ring's stages of K, V[, the R window]; with rel, one [16, BK + 8] f32
// shear slab a consumer warp; the stages' f32 key masks; the mbarriers.
// Every tile and chunk starts on 1024 bytes (the 128-byte swizzle's atom).
template <int HD, bool REL>
struct Layout {
  // keys a stage holds: 128 for plain attention; with rel 64 (the R window
  // costs (64 + 64) / 64 = 2x the bd term's per-diagonal work: at 128 keys
  // it would cost 1.5x, but S, P2 and O would need 192 f32 registers a
  // thread and spill past setmaxnreg's 240), and 32 at hd 128 (3x), where
  // two stages of a 64-key window would not fit in shared memory
  static constexpr int BK = !REL ? 128 : (HD <= 80 ? 64 : 32);
  static constexpr int RW = BQ + BK;             // R rows staged (BQ + BK - 1 read)
  static constexpr int PN = 64 + BK;             // P2 columns a warpgroup (63 + BK read)
  static constexpr int SH_LD = BK + 8;           // row stride of a shear slab
  static constexpr size_t ROW = static_cast<size_t>(HD) * 2;
  static constexpr size_t Q = 0;
  static constexpr size_t QPOS = Q + BQ * ROW;
  static constexpr size_t STAGE0 = QPOS + (REL ? BQ * ROW : 0);
  static constexpr size_t K_OFF = 0;
  static constexpr size_t V_OFF = BK * ROW;
  static constexpr size_t R_OFF = 2 * BK * ROW;
  static constexpr size_t STAGE = R_OFF + (REL ? RW * ROW : 0);
  static constexpr size_t BD = STAGE0 + STAGES * STAGE;
  static constexpr size_t MASK =
      BD + (REL ? static_cast<size_t>(CONSUMER_WARPS) * 16 * SH_LD * 4 : 0);
  static constexpr size_t BARS = MASK + static_cast<size_t>(STAGES) * BK * 4;
  static constexpr size_t SMEM = BARS + (2 * STAGES + 1) * 8 + 1024;  // + the base's alignment
};

struct Params {
  CUtensorMap q[2], qp[2], k[2], v[2], r[2];  // one map a column chunk
  const float* mask;
  __nv_bfloat16* out;
  int nh, t_pad;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete. A wait of 10 s means
// a broken ring: trap (the launch then fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer() - t0 > 10000000000ull) __trap();
  }
}

// One TMA box of a 3-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The wgmma descriptor of a tile whose rows are `span` bytes (32, 64 or 128)
// under TMA's swizzle of the same span: 8-row groups `8 * span` bytes apart
// (SBO); LBO unused, since no operand is wider than one swizzle atom along
// its contiguous dimension.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int span) {
  const uint64_t layout = span == 128 ? 1 : (span == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>((8 * span) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// issue or wait (the hardware owns these registers in between).
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (what __expf runs after its multiply by log2 e)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D (+)= A·B for one k16 step, bf16 operands, f32 accumulators, on the
// warpgroup: A and B from shared memory, both K-major (`acc` 0 overwrites D).
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D += A·B for one k16 step: A from registers (the m64k16 fragment), B
// from shared memory MN-major (the descriptor's transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD, bool REL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ Params p) {
  using L = Layout<HD, REL>;
  using C = Cols<HD>;
  constexpr int BK = L::BK;

  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = wg_smem + (base - raw);
  const uint32_t full0 = base + static_cast<uint32_t>(L::BARS);
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t q_bar = empty0 + 8 * STAGES;

  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * p.nh + h;
  const int n_tiles = p.t_pad / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMER_WARPS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so the compiler sees one role per
  // warp (setmaxnreg takes effect only then)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full through TMA ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_bar, static_cast<uint32_t>(BQ * L::ROW * (REL ? 2 : 1)));
#pragma unroll
      for (int c = 0; c < C::N; ++c) {
        tma_load(base + L::Q + C::off(BQ, c), &p.q[c], q_bar, 64 * c, i0, bh);
        if (REL) tma_load(base + L::QPOS + C::off(BQ, c), &p.qp[c], q_bar, 64 * c, i0, bh);
      }
      const float* mask_b = p.mask ? p.mask + static_cast<size_t>(b) * p.t_pad : nullptr;
      const uint32_t tile_tx = static_cast<uint32_t>(L::STAGE) + (mask_b ? BK * 4 : 0);
      // the block's R window for key tile k0: rows T_pad - i0 - (BQ - 1) + k0
      // + [0, BQ + BK); the last (never read) may lie past the table: zeros
      const int r_row0 = p.t_pad - i0 - (BQ - 1);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * st, ((j / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t sb = base + static_cast<uint32_t>(L::STAGE0 + st * L::STAGE);
        const int k0 = j * BK;
        mbar_expect_tx(full, tile_tx);
#pragma unroll
        for (int c = 0; c < C::N; ++c) {
          tma_load(sb + L::K_OFF + C::off(BK, c), &p.k[c], full, 64 * c, k0, bh);
          tma_load(sb + L::V_OFF + C::off(BK, c), &p.v[c], full, 64 * c, k0, bh);
          if (REL) {
            tma_load(sb + L::R_OFF + C::off(L::RW, c), &p.r[c], full, 64 * c, r_row0 + k0, h);
          }
        }
        if (mask_b) {
          bulk_load(base + static_cast<uint32_t>(L::MASK) + st * BK * 4, mask_b + k0, BK * 4,
                    full);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows i0 + 64 wg + [0, 64) ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = threadIdx.x >> 5;  // 0..7
    const int w = warp & 3;             // warp within the warpgroup: rows 16 w + [0, 16)
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q4 = lane & 3;  // accumulator rows g, g + 8; column pair 2 q4
    const float neg = -CUDART_INF_F;
    const float scale = p.scale;
    const bool masked = p.mask != nullptr;
    const float* mask_s = reinterpret_cast<const float*>(gbase + L::MASK);
    float* slab = reinterpret_cast<float*>(gbase + L::BD) + warp * 16 * L::SH_LD;

    float o[HD / 2], s[BK / 2], p2[REL ? L::PN / 2 : 1];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (REL ? L::PN / 2 : 1); ++i) p2[i] = 0.0f;
    float m_run[2] = {neg, neg}, l_run[2] = {0.0f, 0.0f};

    mbar_wait(q_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      mbar_wait(full0 + 8 * st, (j / STAGES) & 1);
      const uint32_t sb = base + static_cast<uint32_t>(L::STAGE0 + st * L::STAGE);

#pragma unroll
      for (int i = 0; i < BK / 2; ++i) reg_fence(s[i]);
      wgmma_fence();
      if constexpr (REL) {
        // P2 = q_pos[this warpgroup's 64 rows] · R_win[PN rows]ᵀ: its window
        // starts 64 (wg 0) or 0 (wg 1) rows into the block's
#pragma unroll
        for (int i = 0; i < L::PN / 2; ++i) reg_fence(p2[i]);
#pragma unroll
        for (int c = 0; c < C::N; ++c) {
          const int span = 2 * C::width(c);
#pragma unroll
          for (int ks = 0; ks < C::width(c) / 16; ++ks) {
            const uint64_t da =
                desc(base + L::QPOS + C::off(BQ, c) + wg * 64 * span + 32 * ks, span);
            const uint64_t db =
                desc(sb + L::R_OFF + C::off(L::RW, c) + (64 - 64 * wg) * span + 32 * ks, span);
            wgmma_ss<L::PN>(p2, da, db, (c | ks) != 0);
          }
        }
        wgmma_commit();
      }
      // S = q · Kᵀ
#pragma unroll
      for (int c = 0; c < C::N; ++c) {
        const int span = 2 * C::width(c);
#pragma unroll
        for (int ks = 0; ks < C::width(c) / 16; ++ks) {
          const uint64_t da = desc(base + L::Q + C::off(BQ, c) + wg * 64 * span + 32 * ks, span);
          const uint64_t db = desc(sb + L::K_OFF + C::off(BK, c) + 32 * ks, span);
          wgmma_ss<BK>(s, da, db, (c | ks) != 0);
        }
      }
      wgmma_commit();

      if constexpr (REL) {
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < L::PN / 2; ++i) reg_fence(p2[i]);
      } else {
        wgmma_wait<0>();
      }
      if constexpr (REL) {
        // the shear, through this warp's slab: bd[ii, kk] = P2[ii, 63 - ii + kk]
        // (ii: row in the warpgroup), written while S computes
#pragma unroll
        for (int i = 0; i < L::PN / 2; ++i) {
          const int lr = g + 8 * ((i >> 1) & 1);
          const int kk = 8 * (i >> 2) + 2 * q4 + (i & 1) - 63 + 16 * w + lr;
          if (kk >= 0 && kk < BK) slab[lr * L::SH_LD + kk] = p2[i];
        }
        __syncwarp();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) reg_fence(s[i]);
#pragma unroll
        for (int jb = 0; jb < BK / 8; ++jb) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 bv = *reinterpret_cast<const float2*>(
                slab + (g + 8 * hh) * L::SH_LD + 8 * jb + 2 * q4);
            s[4 * jb + 2 * hh] = __fadd_rn(s[4 * jb + 2 * hh], bv.x);
            s[4 * jb + 2 * hh + 1] = __fadd_rn(s[4 * jb + 2 * hh + 1], bv.y);
          }
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) reg_fence(s[i]);
      }

      // the TPU kernel's op order: (ac + bd) * scale, then the mask
      const float* ms = mask_s + st * BK;
#pragma unroll
      for (int jb = 0; jb < BK / 8; ++jb) {
        float2 m = make_float2(0.0f, 0.0f);
        if (masked) m = *reinterpret_cast<const float2*>(ms + 8 * jb + 2 * q4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float x0 = __fmul_rn(s[4 * jb + 2 * hh], scale);
          float x1 = __fmul_rn(s[4 * jb + 2 * hh + 1], scale);
          if (masked) {
            x0 = __fadd_rn(x0, m.x);
            x1 = __fadd_rn(x1, m.y);
          }
          s[4 * jb + 2 * hh] = x0;
          s[4 * jb + 2 * hh + 1] = x1;
        }
      }

      // online softmax; rows g (hh = 0) and g + 8 (hh = 1), each spread over
      // the four lanes 4g..4g+3
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = neg;
#pragma unroll
        for (int jb = 0; jb < BK / 8; ++jb) {
          mx = fmaxf(mx, fmaxf(s[4 * jb + 2 * hh], s[4 * jb + 2 * hh + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hh], mx);
        const float m_use = m_new == neg ? 0.0f : m_new;  // a row masked so far
        float sum = 0.0f;
#pragma unroll
        for (int jb = 0; jb < BK / 8; ++jb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2_approx(fmaf(s[4 * jb + 2 * hh + e], kLog2e, -m_use * kLog2e));
            sum += pe;
            s[4 * jb + 2 * hh + e] = pe;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[hh] = __expf(m_run[hh] - m_use);
        l_run[hh] = fmaf(l_run[hh], alpha[hh], sum);
        m_run[hh] = m_new;
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // P · V: p rounded to bf16 as the A operand, from the score registers
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        pa[kt][0] = pack_bf16(s[8 * kt + 0], s[8 * kt + 1]);
        pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
        pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
        pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) reg_fence(o[i]);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        wgmma_rs<C::W0>(o, pa[kt], desc(sb + L::V_OFF + 32 * kt * C::W0, 2 * C::W0));
        if constexpr (C::N == 2) {
          wgmma_rs<C::W1>(o + C::reg(1), pa[kt],
                          desc(sb + L::V_OFF + C::off(BK, 1) + 32 * kt * C::W1, 2 * C::W1));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) reg_fence(o[i]);
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(pa[kt][e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
    }

    __nv_bfloat16* row =
        p.out + (static_cast<size_t>(bh) * p.t_pad + i0 + 64 * wg + 16 * w + g) * HD;
#pragma unroll
    for (int c = 0; c < C::N; ++c) {
#pragma unroll
      for (int jb = 0; jb < C::width(c) / 8; ++jb) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = C::reg(c) + 4 * jb + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * hh * HD + 64 * c + 8 * jb + 2 * q4) =
              __floats2bfloat162_rn(o[i] / l_run[hh], o[i + 1] / l_run[hh]);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; null if the driver does not have it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// The map of a [planes, rows, hd] bf16 tensor whose TMA box is `width`
// columns (swizzled by their span) of `box_rows` rows of one plane.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base, int hd, int rows, int planes,
            int width, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool REL>
int launch(const void* q, const void* q_pos, const void* k, const void* v, const void* rel_r,
           const void* mask, void* out, int batch, int nh, int t_pad, float scale,
           cudaStream_t stream) {
  using L = Layout<HD, REL>;
  using C = Cols<HD>;
  if (t_pad % BQ != 0 || t_pad % L::BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p{};
  const int planes = batch * nh;
  for (int c = 0; c < C::N; ++c) {
    const int wd = C::width(c);
    bool ok = encode(enc, &p.q[c], q, HD, t_pad, planes, wd, BQ) &&
              encode(enc, &p.k[c], k, HD, t_pad, planes, wd, L::BK) &&
              encode(enc, &p.v[c], v, HD, t_pad, planes, wd, L::BK);
    if (REL) {
      ok = ok && encode(enc, &p.qp[c], q_pos, HD, t_pad, planes, wd, BQ) &&
           encode(enc, &p.r[c], rel_r, HD, 2 * t_pad, nh, wd, L::RW);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mask = static_cast<const float*>(mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.nh = nh;
  p.t_pad = t_pad;
  p.scale = scale;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD, REL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(t_pad / BQ, nh, batch);
  flash_attention_wgmma_kernel<HD, REL><<<grid, THREADS, L::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool REL>
size_t smem_rel(int hd) {
  switch (hd) {
    case 16: return Layout<16, REL>::SMEM;
    case 32: return Layout<32, REL>::SMEM;
    case 64: return Layout<64, REL>::SMEM;
    case 80: return Layout<80, REL>::SMEM;
    case 128: return Layout<128, REL>::SMEM;
    default: return 0;
  }
}

size_t smem_for(int hd, bool rel) { return rel ? smem_rel<true>(hd) : smem_rel<false>(hd); }

template <bool REL>
int launch_rel(const void* q, const void* q_pos, const void* k, const void* v, const void* rel_r,
               const void* mask, void* out, int batch, int nh, int t_pad, int hd, float scale,
               cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, scale, stream);
    case 32: return launch<32, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, scale, stream);
    case 64: return launch<64, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, scale, stream);
    case 80: return launch<80, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, scale, stream);
    case 128: return launch<128, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_for(const void* q, const void* q_pos, const void* k, const void* v, const void* rel_r,
               const void* mask, void* out, int batch, int nh, int t_pad, int hd, float scale,
               cudaStream_t stream) {
  // TMA takes 16-byte aligned bases (the rows are hd * 2 bytes, a multiple
  // of 16 at every served hd); the mask tile is one 16-byte aligned copy
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(q_pos) |
                          reinterpret_cast<uintptr_t>(rel_r) | reinterpret_cast<uintptr_t>(mask) |
                          reinterpret_cast<uintptr_t>(out);
  if (bases & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  if (rel_r) {
    return launch_rel<true>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale,
                            stream);
  }
  return launch_rel<false>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale,
                           stream);
}

}  // namespace wg_k5

}  // namespace

// Shared memory one block needs for head dim `hd` and rel mode, in the
// kernel the element size routes to (4 = f32: the FMA kernel, hd 1..128;
// 2 = bf16: the wgmma kernel, hd 16, 32, 64, 80 or 128); 0 if that kernel
// does not serve the head dim, or for another element size.
extern "C" size_t flash_attention_smem_bytes(int hd, int elem_bytes, int rel) {
  if (elem_bytes == 4) return smem_for<float>(hd, rel != 0);
  if (elem_bytes == 2) return wg_k5::smem_for(hd, rel != 0);
  return 0;
}

static int check_args(int t_pad, const void* q_pos, const void* rel_r) {
  if (t_pad % BQ != 0 || (q_pos == nullptr) != (rel_r == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Launchers of K5 on `stream`. All pointers are device pointers to
// contiguous tensors, f32 for the FMA kernel and bf16 for the wgmma
// kernel: q, k, v [B, NH, T_pad, hd] and out (same shape, written); q_pos
// (same shape) and rel_r [NH, 2·T_pad, hd] both null, or both set (rel
// mode); mask [B, T_pad] f32, or null. T_pad must be a multiple of 64 (of
// 128 for the wgmma kernel, whose pointers must also be 16-byte aligned).
// Each returns cudaGetLastError() after the launch (0 = launched), or the
// error that kept it from launching, and does not synchronise.
extern "C" int flash_attention_fma_launch(const void* q, const void* q_pos, const void* k,
                                          const void* v, const void* rel_r, const void* mask,
                                          void* out, int batch, int nh, int t_pad, int hd,
                                          float scale, void* stream) {
  if (batch <= 0 || nh <= 0 || t_pad <= 0) return 0;
  if (int err = check_args(t_pad, q_pos, rel_r)) return err;
  return launch_for<float>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_wgmma_launch(const void* q, const void* q_pos, const void* k,
                                            const void* v, const void* rel_r, const void* mask,
                                            void* out, int batch, int nh, int t_pad, int hd,
                                            float scale, void* stream) {
  if (batch <= 0 || nh <= 0 || t_pad <= 0) return 0;
  if (int err = check_args(t_pad, q_pos, rel_r)) return err;
  return wg_k5::launch_for(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale,
                           static_cast<cudaStream_t>(stream));
}

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
// (q·kᵀ, the bd term, P·V) against about 10·T_pad·hd bytes, so it is bound
// by operations: on the tensor cores at 989 TFLOP/s dense bf16, on the CUDA
// cores at 67 TFLOP/s f32.
//
// Two kernels, picked by dtype (the wrapper, ops/flash_attention.py), both
// fed by the same TMA ring (one producer thread, full and empty mbarriers):
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
// f32 — `flash_attention_f32_kernel`, exact: every product is an f32 FMA
//   (fmaf) on the CUDA cores, no TF32, no tensor cores, no fast-math, `expf`,
//   for the TPU's Precision.HIGHEST path that the f32 forwards (the
//   runtime's, long-form's, online's and the CLI's default) use. Its bound
//   is the 6·T_pad²·hd operations at 67 TFLOP/s (0.7692 ms at B=32, NH=16,
//   T_pad 512, hd 64, rel), so the design keeps the FMA pipe fed:
//   - the bf16 kernel's ring as it stands (producer warpgroup at 24
//     registers, consumers at 240, full/empty mbarriers, the 10 s trap)
//     over f32 3-d maps. A column chunk is 32 f32 (a 128-byte box row,
//     128-byte swizzle) or 16 (64-byte swizzle): hd 64 is 32 + 32, 80 is
//     32 + 32 + 16, 128 is four chunks; nothing past hd is stored or
//     multiplied. A head dim that is no width of {16, 32, 64, 80, 96, 128}
//     runs the next one, TMA filling the columns past hd with zeros (every
//     chunk starts below hd); the wrapper pads one that is not a multiple
//     of 4 (TMA's 16-byte row stride);
//   - register tiles: consumer thread (warp w, lane = 8 rg + kl) owns TR x
//     TK scores, rows rb + 8a (rb = 8 TR (w / 2) + 4 (w % 2) + rg) and keys
//     kl + 8c; the eight lanes of a row group share its rows. Operands are
//     read 16 bytes along d a load: q·kᵀ takes TR + TK loads per 4·TR·TK
//     FMAs (12 per 128 at 4 x 8). Rows and keys both step by 8, so the
//     position term of (a, c) reads window row xb + 8 (c - a + TR - 1): the
//     thread's TR + TK - 1 window rows and TR q_pos rows per 16 bytes of d
//     (15 per 128). The swizzle puts the 8 key rows (or 4 query rows, or
//     the 11 window rows in two passes) of a warp's load in distinct banks;
//   - the R window as a ring of `RING` rows: tile j reads rows
//     T_pad - i0 - (BQ - 1) + BK j + [0, BQ + BK - 1), which overlap tile
//     j + 1's in all but BK rows, so the stage of tile j brings only chunk
//     j + BQ/BK of BK rows (the first BQ/BK come with q) into ring slot
//     (j + BQ/BK) mod RING/BK; the slot it overwrites was last read by tile
//     j - 2, whose stage the producer has seen released;
//   - scores, p and O stay in registers: max and sum reduce over the row
//     group's eight lanes (xor shuffles 1, 2, 4), the sum of the unrounded
//     p with one divide at the end; P·V broadcasts each p within its row
//     group by a shuffle and each lane accumulates its own hd/8 columns of
//     the TR rows (16 bytes of a V row a load). No shared score tile and no
//     block barrier inside a key tile;
//   - shared memory decides the tiles (q[, q_pos] + two stages of K, V +
//     the ring): 128 query rows (4 x 8 a thread), 64 keys and a ring of 256
//     rows, 192 KB at hd 64 with rel; with rel at hd 80, 32-key tiles (4 x
//     4; 64 would need 240 KB); at hd 96 and 128, 64 query rows as well (2 x
//     4; q and q_pos alone would be 128 KB at hd 128); plain attention 4 x 8
//     at every width.
//   On an H100 (700 W) this runs the conformer's shape (B=32, NH=16, T_pad
//   512, hd 64, rel) at about half its bound, 34 TFLOP/s. Measured and not
//   kept: the whole window in each stage instead of the ring (no faster,
//   32 KB more), p through a per-warp shared slab instead of shuffles (1-3%
//   faster, 32 KB more).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ---- the TMA ring's machinery, shared by both kernels -------------------

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

// The map of a [planes, rows, hd] tensor of bf16 (elem_bytes 2) or f32 (4)
// whose TMA box is `width` columns of `box_rows` rows of one plane,
// swizzled by the box row's span (128, 64 or 32 bytes); columns past hd
// read as zeros.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base, int elem_bytes, int hd,
            int rows, int planes, int width, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * elem_bytes,
                                 static_cast<cuuint64_t>(rows) * hd * elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const int span = width * elem_bytes;
  const CUtensorMapSwizzle swizzle = span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type =
      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
    bool ok = encode(enc, &p.q[c], q, 2, HD, t_pad, planes, wd, BQ) &&
              encode(enc, &p.k[c], k, 2, HD, t_pad, planes, wd, L::BK) &&
              encode(enc, &p.v[c], v, 2, HD, t_pad, planes, wd, L::BK);
    if (REL) {
      ok = ok && encode(enc, &p.qp[c], q_pos, 2, HD, t_pad, planes, wd, BQ) &&
           encode(enc, &p.r[c], rel_r, 2, HD, 2 * t_pad, nh, wd, L::RW);
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

// ---- f32: exact FMAs on the CUDA cores, fed by a TMA ring (Hopper) ------

namespace f32_k5 {

constexpr int STAGES = 2;          // the K, V ring (the R window has its own ring)
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 384;       // consumer warpgroups 0 and 1, producer warpgroup 2

// The widths served (16, 32, 64, 80, 96, 128), each cut into column chunks
// of 32 f32 (128-byte box rows) and, where the width is an odd multiple of
// 16, a last chunk of 16 (64-byte rows). Chunk c starts at column 32 c.
template <int HD>
struct Cols {
  static constexpr int N32 = HD / 32;
  static constexpr bool TAIL = HD % 32 != 0;  // 16 columns
  static constexpr int N = N32 + (TAIL ? 1 : 0);
  // columns of P·V's output a lane holds: 4 a 32-column chunk, 2 of the tail
  static constexpr int CPL = 4 * N32 + (TAIL ? 2 : 0);
  __host__ __device__ static constexpr int width(int c) { return c < N32 ? 32 : 16; }
  // byte offset of chunk c in a tile of `rows` rows (every chunk before it is 32 wide)
  __host__ __device__ static constexpr uint32_t off(int rows, int c) {
    return static_cast<uint32_t>(rows * 128 * c);
  }
};

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// The tiles and shared memory of one block, from its 1024-aligned base:
// q[, q_pos]; the stages of K, V; with rel the R ring; the stages' f32 key
// masks; the mbarriers. Every tile, chunk and ring slot starts on a
// multiple of 1024 bytes (the 128-byte swizzle's atom).
template <int HD, bool REL>
struct Layout {
  // TR x TK scores a consumer thread: 4 x 8, with rel 4 x 4 past hd 64 and
  // 2 x 4 past hd 80, where 4 x 8 would not fit (see the note at the top)
  static constexpr int TR = REL && HD > 80 ? 2 : 4;
  static constexpr int TK = REL && HD > 64 ? 4 : 8;
  static constexpr int BQ = 32 * TR;  // query rows a block: 8 warps of 4 TR rows
  static constexpr int BK = 8 * TK;   // keys a tile: 8 lanes of TK keys a row group
  // window rows a tile reads (BQ + BK - 1) and one tile ahead, a power of 2
  static constexpr int RING = pow2_at_least(BQ + 2 * BK);
  static constexpr size_t ROW = static_cast<size_t>(HD) * 4;
  static constexpr size_t Q = 0;
  static constexpr size_t QPOS = Q + BQ * ROW;
  static constexpr size_t STAGE0 = QPOS + (REL ? BQ * ROW : 0);
  static constexpr size_t K_OFF = 0;
  static constexpr size_t V_OFF = BK * ROW;
  static constexpr size_t STAGE = 2 * BK * ROW;
  static constexpr size_t R = STAGE0 + STAGES * STAGE;
  static constexpr size_t MASK = R + (REL ? RING * ROW : 0);
  static constexpr size_t BARS = MASK + static_cast<size_t>(STAGES) * BK * 4;
  static constexpr size_t SMEM = BARS + (2 * STAGES + 1) * 8 + 1024;  // + the base's alignment
};

struct Params {
  CUtensorMap q[4], qp[4], k[4], v[4], r[4];  // one map a column chunk
  const float* mask;
  float* out;
  int nh, t_pad, hd;
  float scale;
};

__device__ __forceinline__ float4 ld4(const unsigned char* s, uint32_t off) {
  return *reinterpret_cast<const float4*>(s + off);
}

__device__ __forceinline__ float2 ld2(const unsigned char* s, uint32_t off) {
  return *reinterpret_cast<const float2*>(s + off);
}

// acc += x·y over the four columns, in column order
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// The 16-byte unit `u` of a row whose swizzle key is `key8` (row & 7, for
// 128-byte rows) or `key4` ((row >> 1) & 3, for 64-byte rows), as a byte
// offset in the row.
__device__ __forceinline__ uint32_t unit(int width, int u, uint32_t key8, uint32_t key4) {
  return static_cast<uint32_t>(u ^ (width == 32 ? key8 : key4)) << 4;
}

template <int HD, bool REL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(const __grid_constant__ Params p) {
  using L = Layout<HD, REL>;
  using C = Cols<HD>;
  constexpr int TR = L::TR, TK = L::TK, BQ = L::BQ, BK = L::BK;

  extern __shared__ __align__(1024) unsigned char f32_smem[];
  const uint32_t raw = smem_u32(f32_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sm = f32_smem + (base - raw);
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
    // ---- producer: one thread keeps the rings full through TMA ---------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      // R chunk m: rows T_pad - i0 - (BQ - 1) + BK m + [0, BK) into ring
      // slot m mod RING/BK; rows past the table (never read) are zeros
      const int r_row0 = p.t_pad - i0 - (BQ - 1);
      auto load_r = [&](int m, uint32_t bar) {
        const uint32_t slot = static_cast<uint32_t>((BK * m) & (L::RING - 1));
#pragma unroll
        for (int c = 0; c < C::N; ++c) {
          tma_load(base + static_cast<uint32_t>(L::R) + C::off(L::RING, c) + slot * C::width(c) * 4,
                   &p.r[c], bar, 32 * c, r_row0 + BK * m, h);
        }
      };
      mbar_expect_tx(q_bar, static_cast<uint32_t>(BQ * L::ROW * (REL ? 2 : 1) +
                                                  (REL ? BQ * L::ROW : 0)));
#pragma unroll
      for (int c = 0; c < C::N; ++c) {
        tma_load(base + static_cast<uint32_t>(L::Q) + C::off(BQ, c), &p.q[c], q_bar, 32 * c, i0,
                 bh);
        if (REL) {
          tma_load(base + static_cast<uint32_t>(L::QPOS) + C::off(BQ, c), &p.qp[c], q_bar, 32 * c,
                   i0, bh);
        }
      }
      if (REL) {
        for (int m = 0; m < BQ / BK; ++m) load_r(m, q_bar);
      }
      const float* mask_b = p.mask ? p.mask + static_cast<size_t>(b) * p.t_pad : nullptr;
      const uint32_t tile_tx = static_cast<uint32_t>(L::STAGE + (REL ? BK * L::ROW : 0)) +
                               (mask_b ? BK * 4 : 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * st, ((j / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t sb = base + static_cast<uint32_t>(L::STAGE0 + st * L::STAGE);
        const int k0 = j * BK;
        mbar_expect_tx(full, tile_tx);
#pragma unroll
        for (int c = 0; c < C::N; ++c) {
          tma_load(sb + static_cast<uint32_t>(L::K_OFF) + C::off(BK, c), &p.k[c], full, 32 * c, k0,
                   bh);
          tma_load(sb + static_cast<uint32_t>(L::V_OFF) + C::off(BK, c), &p.v[c], full, 32 * c, k0,
                   bh);
        }
        if (REL) load_r(j + BQ / BK, full);
        if (mask_b) {
          bulk_load(base + static_cast<uint32_t>(L::MASK) + st * BK * 4, mask_b + k0, BK * 4,
                    full);
        }
      }
    }
  } else {
    // ---- consumers: TR x TK scores a thread, O in registers -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = threadIdx.x >> 5;  // 0..7
    const int lane = threadIdx.x & 31;
    const int rg = lane >> 3, kl = lane & 7;  // row group, lane within it
    const int src0 = lane & 24;               // the row group's first lane
    const int rb = 8 * TR * (warp >> 1) + 4 * (warp & 1) + rg;  // rows rb + 8a of the block
    // window row of (a, c) is xb + 8 (c - a + TR - 1)
    const int xb = BQ - 1 - rb + kl - 8 * (TR - 1);
    // swizzle keys: q and q_pos rows rb + 8a, key rows kl + 8c, window rows
    // xb + 8u (rows step by 8, so one key serves all of a thread's rows)
    const uint32_t xq8 = rb & 7, xq4 = (rb >> 1) & 3;
    const uint32_t xk8 = kl, xk4 = (kl >> 1) & 3;
    const uint32_t xr8 = xb & 7, xr4 = (xb >> 1) & 3;
    const float neg = -CUDART_INF_F;
    const float scale = p.scale;
    const bool masked = p.mask != nullptr;

    float o[TR][C::CPL], m_run[TR], l_run[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      m_run[a] = neg;
      l_run[a] = 0.0f;
#pragma unroll
      for (int e = 0; e < C::CPL; ++e) o[a][e] = 0.0f;
    }

    mbar_wait(q_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      mbar_wait(full0 + 8 * st, (j / STAGES) & 1);
      const uint32_t sb = static_cast<uint32_t>(L::STAGE0 + st * L::STAGE);

      // S = q · Kᵀ, 16 bytes of d a load
      float s[TR][TK];
#pragma unroll
      for (int a = 0; a < TR; ++a) {
#pragma unroll
        for (int c = 0; c < TK; ++c) s[a][c] = 0.0f;
      }
#pragma unroll
      for (int ch = 0; ch < C::N; ++ch) {
        const int w = C::width(ch);
        const uint32_t rowb = w * 4;
        const uint32_t q_at = static_cast<uint32_t>(L::Q) + C::off(BQ, ch) + rb * rowb;
        const uint32_t k_at = sb + static_cast<uint32_t>(L::K_OFF) + C::off(BK, ch) + kl * rowb;
        // two 16-byte steps of d at a time: unrolled further, ptxas hoists
        // the loads of later steps and spills at widths 96 and 128
#pragma unroll 2
        for (int u = 0; u < w / 4; ++u) {
          float4 qv[TR], kv[TK];
#pragma unroll
          for (int a = 0; a < TR; ++a) qv[a] = ld4(sm, q_at + 8 * a * rowb + unit(w, u, xq8, xq4));
#pragma unroll
          for (int c = 0; c < TK; ++c) kv[c] = ld4(sm, k_at + 8 * c * rowb + unit(w, u, xk8, xk4));
#pragma unroll
          for (int a = 0; a < TR; ++a) {
#pragma unroll
            for (int c = 0; c < TK; ++c) s[a][c] = dot4(qv[a], kv[c], s[a][c]);
          }
        }
      }

      if constexpr (REL) {
        // bd = q_pos · R along the diagonals: (a, c) reads window row
        // xb + 8 (c - a + TR - 1), at ring row (BK j + that) mod RING
        float bd[TR][TK];
#pragma unroll
        for (int a = 0; a < TR; ++a) {
#pragma unroll
          for (int c = 0; c < TK; ++c) bd[a][c] = 0.0f;
        }
        constexpr int NU = TR + TK - 1;
        uint32_t rr[NU];
#pragma unroll
        for (int u = 0; u < NU; ++u) rr[u] = (BK * j + xb + 8 * u) & (L::RING - 1);
#pragma unroll
        for (int ch = 0; ch < C::N; ++ch) {
          const int w = C::width(ch);
          const uint32_t rowb = w * 4;
          const uint32_t qp_at = static_cast<uint32_t>(L::QPOS) + C::off(BQ, ch) + rb * rowb;
          const uint32_t r_at = static_cast<uint32_t>(L::R) + C::off(L::RING, ch);
          // one 16-byte step of d at a time (its TR + TK - 1 window rows and
          // TR q_pos rows): unrolled, ptxas hoisted later steps' loads and
          // spilled 380 bytes at hd 64, which ran 1.6x slower on an H100
#pragma unroll 1
          for (int u = 0; u < w / 4; ++u) {
            float4 qv[TR];
#pragma unroll
            for (int a = 0; a < TR; ++a) {
              qv[a] = ld4(sm, qp_at + 8 * a * rowb + unit(w, u, xq8, xq4));
            }
#pragma unroll
            for (int d = 0; d < NU; ++d) {
              const float4 rv = ld4(sm, r_at + rr[d] * rowb + unit(w, u, xr8, xr4));
#pragma unroll
              for (int a = 0; a < TR; ++a) {
                const int c = d - (TR - 1) + a;
                if (c >= 0 && c < TK) bd[a][c] = dot4(qv[a], rv, bd[a][c]);
              }
            }
          }
        }
        // the TPU kernel's op order: (ac + bd) * scale, then the mask
#pragma unroll
        for (int a = 0; a < TR; ++a) {
#pragma unroll
          for (int c = 0; c < TK; ++c) s[a][c] = __fmul_rn(__fadd_rn(s[a][c], bd[a][c]), scale);
        }
      } else {
#pragma unroll
        for (int a = 0; a < TR; ++a) {
#pragma unroll
          for (int c = 0; c < TK; ++c) s[a][c] = __fmul_rn(s[a][c], scale);
        }
      }
      if (masked) {
        const float* ms = reinterpret_cast<const float*>(sm + L::MASK) + st * BK;
#pragma unroll
        for (int c = 0; c < TK; ++c) {
          const float m = ms[kl + 8 * c];
#pragma unroll
          for (int a = 0; a < TR; ++a) s[a][c] = __fadd_rn(s[a][c], m);
        }
      }

      // online softmax: row a's keys are spread over the row group's 8 lanes
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        float mx = neg;
#pragma unroll
        for (int c = 0; c < TK; ++c) mx = fmaxf(mx, s[a][c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m_run[a], mx);
        const float m_use = m_new == neg ? 0.0f : m_new;  // a row masked so far
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < TK; ++c) {
          const float pe = expf(s[a][c] - m_use);
          sum += pe;
          s[a][c] = pe;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        const float alpha = expf(m_run[a] - m_use);
        l_run[a] = fmaf(l_run[a], alpha, sum);
        m_run[a] = m_new;
#pragma unroll
        for (int e = 0; e < C::CPL; ++e) o[a][e] *= alpha;
      }

      // P · V: key kk + 8c's p comes from lane kk of the row group; this
      // lane takes columns 32 ch + 4 kl + [0, 4) of each 32-column chunk
      // and 32 N32 + 2 kl + [0, 2) of the tail
#pragma unroll
      for (int c = 0; c < TK; ++c) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t key = kk + 8 * c;
          float pv[TR];
#pragma unroll
          for (int a = 0; a < TR; ++a) pv[a] = __shfl_sync(0xffffffffu, s[a][c], src0 | kk);
#pragma unroll
          for (int ch = 0; ch < C::N; ++ch) {
            const int w = C::width(ch);
            const uint32_t v_at = sb + static_cast<uint32_t>(L::V_OFF) + C::off(BK, ch) +
                                  key * (w * 4);
            if (w == 32) {
              // row `key` has swizzle key kk
              const float4 vv = ld4(sm, v_at + (static_cast<uint32_t>(kl ^ kk) << 4));
#pragma unroll
              for (int a = 0; a < TR; ++a) {
                o[a][4 * ch] = fmaf(pv[a], vv.x, o[a][4 * ch]);
                o[a][4 * ch + 1] = fmaf(pv[a], vv.y, o[a][4 * ch + 1]);
                o[a][4 * ch + 2] = fmaf(pv[a], vv.z, o[a][4 * ch + 2]);
                o[a][4 * ch + 3] = fmaf(pv[a], vv.w, o[a][4 * ch + 3]);
              }
            } else {
              const float2 vv =
                  ld2(sm, v_at + (static_cast<uint32_t>((kl >> 1) ^ ((kk >> 1) & 3)) << 4) +
                              8 * (kl & 1));
#pragma unroll
              for (int a = 0; a < TR; ++a) {
                o[a][4 * C::N32] = fmaf(pv[a], vv.x, o[a][4 * C::N32]);
                o[a][4 * C::N32 + 1] = fmaf(pv[a], vv.y, o[a][4 * C::N32 + 1]);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
    }

#pragma unroll
    for (int a = 0; a < TR; ++a) {
      float* row = p.out + (static_cast<size_t>(bh) * p.t_pad + i0 + rb + 8 * a) * p.hd;
      const float l = l_run[a];
#pragma unroll
      for (int ch = 0; ch < C::N32; ++ch) {
        const int col = 32 * ch + 4 * kl;
        if (col < p.hd) {
          *reinterpret_cast<float4*>(row + col) =
              make_float4(o[a][4 * ch] / l, o[a][4 * ch + 1] / l, o[a][4 * ch + 2] / l,
                          o[a][4 * ch + 3] / l);
        }
      }
      if constexpr (C::TAIL) {
        const int col = 32 * C::N32 + 2 * kl;
        if (col < p.hd) {
          *reinterpret_cast<float2*>(row + col) =
              make_float2(o[a][4 * C::N32] / l, o[a][4 * C::N32 + 1] / l);
        }
      }
    }
  }
}

template <int HD, bool REL>
int launch(const void* q, const void* q_pos, const void* k, const void* v, const void* rel_r,
           const void* mask, void* out, int batch, int nh, int t_pad, int hd, float scale,
           cudaStream_t stream) {
  using L = Layout<HD, REL>;
  using C = Cols<HD>;
  if (t_pad % L::BQ != 0 || t_pad % L::BK != 0 || hd % 4 != 0 || hd > HD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p{};
  const int planes = batch * nh;
  for (int c = 0; c < C::N; ++c) {
    const int wd = C::width(c);
    bool ok = encode(enc, &p.q[c], q, 4, hd, t_pad, planes, wd, L::BQ) &&
              encode(enc, &p.k[c], k, 4, hd, t_pad, planes, wd, L::BK) &&
              encode(enc, &p.v[c], v, 4, hd, t_pad, planes, wd, L::BK);
    if (REL) {
      ok = ok && encode(enc, &p.qp[c], q_pos, 4, hd, t_pad, planes, wd, L::BQ) &&
           encode(enc, &p.r[c], rel_r, 4, hd, 2 * t_pad, nh, wd, L::BK);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mask = static_cast<const float*>(mask);
  p.out = static_cast<float*>(out);
  p.nh = nh;
  p.t_pad = t_pad;
  p.hd = hd;
  p.scale = scale;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_f32_kernel<HD, REL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(t_pad / L::BQ, nh, batch);
  flash_attention_f32_kernel<HD, REL><<<grid, THREADS, L::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The width that serves head dim `hd` (0 when none does): every chunk of
// it starts below hd.
int template_width(int hd) {
  constexpr int widths[] = {16, 32, 64, 80, 96, 128};
  for (int w : widths) {
    if (hd >= 1 && hd <= w) return w;
  }
  return 0;
}

template <bool REL>
size_t smem_rel(int hd) {
  switch (template_width(hd)) {
    case 16: return Layout<16, REL>::SMEM;
    case 32: return Layout<32, REL>::SMEM;
    case 64: return Layout<64, REL>::SMEM;
    case 80: return Layout<80, REL>::SMEM;
    case 96: return Layout<96, REL>::SMEM;
    case 128: return Layout<128, REL>::SMEM;
    default: return 0;
  }
}

size_t smem_for(int hd, bool rel) { return rel ? smem_rel<true>(hd) : smem_rel<false>(hd); }

template <bool REL>
int launch_rel(const void* q, const void* q_pos, const void* k, const void* v, const void* rel_r,
               const void* mask, void* out, int batch, int nh, int t_pad, int hd, float scale,
               cudaStream_t stream) {
  switch (template_width(hd)) {
    case 16: return launch<16, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 32: return launch<32, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 64: return launch<64, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 80: return launch<80, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 96: return launch<96, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    case 128: return launch<128, REL>(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_for(const void* q, const void* q_pos, const void* k, const void* v, const void* rel_r,
               const void* mask, void* out, int batch, int nh, int t_pad, int hd, float scale,
               cudaStream_t stream) {
  // TMA takes 16-byte aligned bases (rows of hd * 4 bytes, hd a multiple of
  // 4); the mask tile is one 16-byte aligned copy
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

}  // namespace f32_k5

}  // namespace

// Shared memory one block needs for head dim `hd` and rel mode, in the
// kernel the element size routes to (4 = f32: the exact FMA kernel, hd
// 1..128 by the widths 16, 32, 64, 80, 96, 128; 2 = bf16: the wgmma kernel,
// hd 16, 32, 64, 80 or 128); 0 if that kernel does not serve the head dim,
// or for another element size.
extern "C" size_t flash_attention_smem_bytes(int hd, int elem_bytes, int rel) {
  if (elem_bytes == 4) return f32_k5::smem_for(hd, rel != 0);
  if (elem_bytes == 2) return wg_k5::smem_for(hd, rel != 0);
  return 0;
}

static int check_args(const void* q_pos, const void* rel_r) {
  return (q_pos == nullptr) != (rel_r == nullptr) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// Launchers of K5 on `stream`. All pointers are 16-byte aligned device
// pointers to contiguous tensors, f32 for the FMA kernel and bf16 for the
// wgmma kernel: q, k, v [B, NH, T_pad, hd] and out (same shape, written);
// q_pos (same shape) and rel_r [NH, 2·T_pad, hd] both null, or both set
// (rel mode); mask [B, T_pad] f32, or null. T_pad must be a multiple of
// 128, and the f32 kernel's hd a multiple of 4. Each returns
// cudaGetLastError() after the launch (0 = launched), or the error that
// kept it from launching, and does not synchronise.
extern "C" int flash_attention_fma_launch(const void* q, const void* q_pos, const void* k,
                                          const void* v, const void* rel_r, const void* mask,
                                          void* out, int batch, int nh, int t_pad, int hd,
                                          float scale, void* stream) {
  if (batch <= 0 || nh <= 0 || t_pad <= 0) return 0;
  if (int err = check_args(q_pos, rel_r)) return err;
  return f32_k5::launch_for(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_wgmma_launch(const void* q, const void* q_pos, const void* k,
                                            const void* v, const void* rel_r, const void* mask,
                                            void* out, int batch, int nh, int t_pad, int hd,
                                            float scale, void* stream) {
  if (batch <= 0 || nh <= 0 || t_pad <= 0) return 0;
  if (int err = check_args(q_pos, rel_r)) return err;
  return wg_k5::launch_for(q, q_pos, k, v, rel_r, mask, out, batch, nh, t_pad, hd, scale,
                           static_cast<cudaStream_t>(stream));
}

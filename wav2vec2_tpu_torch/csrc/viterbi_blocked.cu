// Blocked banded CTC Viterbi (K2, K3, K4) for Hopper (sm_90a).
//
// Replaces the three kernels that wav2vec2_tpu/ops/viterbi_pallas.py builds
// from one factory, `_make_blocked_kernel`, and mirrors it with one
// template, `viterbi_blocked_kernel<BP_IN_SMEM, RAW_GATHER, R>`:
//
//   K2 <true,  false>  `_KERNEL_BP_VMEM` / `_KERNEL_BP_VMEM_BATCH`
//                      pre-gathered emissions, backpointers on chip;
//   K3 <false, false>  `_KERNEL_BP_HBM` / `_KERNEL_BP_HBM_BATCH`
//                      pre-gathered emissions, backpointers in device memory;
//   K4 <false, true>   `_KERNEL_BP_HBM_GATHER` / `_KERNEL_BP_HBM_GATHER_BATCH`
//                      raw log-probs, backpointers in device memory.
//
// The DP gives K1's (csrc/viterbi.cu) paths bit for bit: strict `>` in the
// order stay, s-1, s-2, the tokens[s] != tokens[s-2] skip rule, one
// __fadd_rn(best, emit) per cell, frozen frames past t_len and the same
// final-state rule, over the same band. Build without fast-math.
//
// What bounds them on this card: each utterance is a chain of T dependent
// frames with one block barrier between frames, on one SM, so the
// instructions a frame takes (S_pad cells on one SM's four schedulers,
// about ten instructions a cell) and the latency of one frame's chain, not
// bandwidth or arithmetic, are the limit.
//
// What the design does about it:
// - one block per utterance (grid = B); a loop over 8-frame blocks inside
//   the block replaces the TPU's sequential grid;
// - the emission rows of block b+1 stream into a double-buffered [2, 8, W]
//   shared-memory window with cp.async while block b computes (16-byte
//   copies when rows and addresses allow, 4-byte ones otherwise); K4 keeps
//   raw [8, V] log-prob rows there and reads win[i][tok[s]], the
//   indexed-load counterpart of the TPU's exact one-hot MXU product;
// - each thread owns a strip of R contiguous states (R in {4, 8, 16, 32}:
//   the least that at most 512 threads cover) and keeps in registers, for
//   the whole DP, the strip's previous-frame scores, its s-2 penalties (0,
//   or -inf where the skip rule forbids s-2; computed once) and, for K4,
//   its tokens as byte offsets into a window row. No DP row lives in shared
//   memory: the new row is computed in place from the old registers, from
//   the strip's top state down, in one unrolled, branch-free pass;
// - no per-cell band test: a strip is computed when it meets the band and
//   skipped otherwise, and its cells outside the band are computed like the
//   others. That leaves every path unchanged: a cell above 2t + 1 is -inf
//   by induction, as in the reference; cells at or past s_len and cells
//   below the band's lower edge feed only cells that are themselves outside
//   the band (a cell reads s, s-1, s-2 of the frame before, and the lower
//   edge rises by 2 a frame), and neither the final-state rule nor the
//   backtrace reads one (a path that no finite score reaches may leave
//   the band above 2t + 1; there the backtrace stays, as in the reference);
// - the s-1 and s-2 scores left of a strip come from the lane below by
//   __shfl_up_sync; across warps, lane 31 publishes its last two scores in
//   a 2-float-per-warp halo, double-buffered by frame parity, so one
//   __syncthreads per frame remains;
// - backpointers are 2 bits a cell in the layout [T_pad][W / 4] bytes, for
//   all three tiers: a strip keeps two R-bit planes (s-1 beat the stay;
//   s-2 won), each set by one predicated instruction, and writes them as
//   its R/4 bytes with one store (8, 16, 32 or 64 bits where aligned; the
//   last strip, cut at W, as its n/4 bytes);
//   K2 keeps them in shared memory for the whole utterance, K3/K4 write
//   them to device memory ([B, T_pad, W / 4], allocated by the caller,
//   a quarter of a byte a cell) and walk them by blocks: in 8 frames the
//   state falls by at most 14, so one warp loads the 8 x 16-byte window of
//   rows t0..t0+7 below the state in one round trip and lane 0 walks the
//   8 frames from shared memory.
// Later work: several utterances per block, and a thread-block cluster for
// S_pad beyond one block's strips.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockFrames = 8;   // frames per streamed block
constexpr int kBtBytes = 16;      // backtrace window width in bytes
constexpr int kMaxThreads = 512;  // threads a block takes at most
constexpr int kMaxStrip = 32;     // largest R
constexpr int kHaloBytes = 2 * 32 * 2 * sizeof(float);  // [parity][warp][2]
constexpr int kFinalBytes = 16;                         // final-state scores

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

// Shared-memory layout, in this order (the window first, 16-byte aligned):
//   window [2][8][win_ld] f32   win_ld = round_up4(S_pad) or round_up4(V)
//   halo   [2][32][2] f32       lane 31's last two scores, by frame parity
//   final  [2] f32 (16 bytes)   the last row's scores at s_len-2, s_len-1
//   bp     K2: [T_pad][W / 4] packed bytes; K3/K4: [8][16] bytes (backtrace)
// (A strip that runs past W reads up to 28 floats past its window row;
// they lie inside the layout and feed no cell of the band.)
template <bool BP_IN_SMEM, bool RAW_GATHER>
__host__ __device__ inline size_t smem_bytes(int t_pad, int s_pad, int vocab) {
  const size_t w = static_cast<size_t>(round_up4(s_pad));
  const size_t win_ld = RAW_GATHER ? round_up4(vocab) : w;
  size_t bytes = 2 * kBlockFrames * win_ld * sizeof(float) + kHaloBytes + kFinalBytes;
  bytes += BP_IN_SMEM ? static_cast<size_t>(t_pad) * (w / 4)
                      : static_cast<size_t>(kBlockFrames) * kBtBytes;
  return bytes;
}

// Strip width R and thread count for W states: the least R in {4, 8, 16,
// 32} with ceil(W / R) <= 512, and threads = round32(ceil(W / R)). R = 0
// when W exceeds 512 * 32.
__host__ inline void strip_shape(int w, int* r, int* threads) {
  *r = 0;
  *threads = 0;
  for (int rr = 4; rr <= kMaxStrip; rr *= 2) {
    const int t = (((w + rr - 1) / rr + 31) / 32) * 32;
    if (t <= kMaxThreads) {
      *r = rr;
      *threads = t < 32 ? 32 : t;
      return;
    }
  }
}

// Start this thread's share of the copies of `rows` rows of `row_elems`
// floats (source rows contiguous) into the window slot `dst` (row stride
// `ld`), and commit them as one cp.async group.
__device__ inline void fill_window(float* dst, const float* src, int rows,
                                   int row_elems, int ld, bool vec) {
  if (vec) {
    const int per_row = row_elems >> 2;
    const int total = rows * per_row;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k / per_row;
      const int c = (k - r * per_row) << 2;
      __pipeline_memcpy_async(dst + r * ld + c,
                              src + static_cast<size_t>(r) * row_elems + c, 16);
    }
  } else {
    const int total = rows * row_elems;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k / row_elems;
      const int c = k - r * row_elems;
      __pipeline_memcpy_async(dst + r * ld + c,
                              src + static_cast<size_t>(r) * row_elems + c, 4);
    }
  }
  __pipeline_commit();
}

// Store a strip's packed 2-bit steps (R/4 bytes, little-endian in `bits`)
// at `at`, `n` bytes of them (the last strip may run past W): one store
// where `at` is aligned for it, else byte by byte.
template <int R>
__device__ inline void store_bits(uint8_t* at, uint64_t bits, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(at);
  if (n == R / 4 && (a & (R / 4 - 1)) == 0) {
    if (R == 4) *at = static_cast<uint8_t>(bits);
    if (R == 8) *reinterpret_cast<uint16_t*>(at) = static_cast<uint16_t>(bits);
    if (R == 16) *reinterpret_cast<uint32_t*>(at) = static_cast<uint32_t>(bits);
    if (R == 32) *reinterpret_cast<uint64_t*>(at) = bits;
    return;
  }
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    if (j < n) at[j] = static_cast<uint8_t>(bits >> (8 * j));
  }
}

// One candidate of a cell: if `cand` > `best` (strict), take it and set
// `bit` in `plane`. Three ALU instructions (setp, selp, predicated or),
// which is what bounds the DP's instruction rate.
__device__ __forceinline__ void take_if_greater(float& best, uint32_t& plane, float cand,
                                                uint32_t bit) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.gt.f32 p, %2, %0;\n\t"
      "selp.f32 %0, %2, %0, p;\n\t"
      "@p or.b32 %1, %1, %3;\n\t}"
      : "+f"(best), "+r"(plane)
      : "f"(cand), "r"(bit));
}

// The step of state `s` in a backpointer row of W states laid out by
// strips of R: a strip of n = min(R, W - its first state) states takes n/4
// bytes, the little-endian word m1 | m2 << n, where bit k of m1 says s-1
// beat the stay and bit k of m2 says s-2 won (step 2 whatever m1 says).
// `byte(i)` reads byte i of the row.
template <int R, typename ByteAt>
__device__ __forceinline__ int strip_step(int s, int w, ByteAt byte) {
  const int q = s / R;
  const int n = min(R, w - q * R);
  const int base = q * (R / 4);
  const int k = s % R;
  const int m1 = (byte(base + (k >> 3)) >> (k & 7)) & 1;
  const int m2 = (byte(base + ((n + k) >> 3)) >> ((n + k) & 7)) & 1;
  return m2 ? 2 : m1;
}

// src: RAW_GATHER ? log_probs [B, T_pad, V] : emissions [B, T_pad, S_pad]
template <bool BP_IN_SMEM, bool RAW_GATHER, int R>
__global__ void __launch_bounds__(kMaxThreads)
viterbi_blocked_kernel(const float* __restrict__ src, const int32_t* __restrict__ tokens,
                       const int32_t* __restrict__ t_lens,
                       const int32_t* __restrict__ s_lens,
                       uint8_t* __restrict__ bp_global, int32_t* __restrict__ paths,
                       int t_pad, int vocab, int s_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = round_up4(s_pad);
  const int n_quads = w >> 2;
  const int row_elems = RAW_GATHER ? vocab : s_pad;
  const int win_ld = round_up4(row_elems);
  float* window = reinterpret_cast<float*>(smem);
  float* halo = window + 2 * kBlockFrames * win_ld;  // [2][32][2]
  float* final_sc = halo + 2 * 32 * 2;               // [2]
  uint8_t* bp_smem = reinterpret_cast<uint8_t*>(final_sc + kFinalBytes / sizeof(float));

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* src_b = src + static_cast<size_t>(b) * t_pad * row_elems;
  uint8_t* bp_b = BP_IN_SMEM ? bp_smem
                             : bp_global + static_cast<size_t>(b) * t_pad * n_quads;
  int32_t* path = paths + static_cast<size_t>(b) * t_pad;
  const int t_len = t_lens[b];
  const int s_len = min(s_lens[b], s_pad);
  const float neg = -CUDART_INF_F;
  const bool vec = (row_elems & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(src_b) & 15) == 0;

  const int t_end = max(min(t_len, t_pad), 0);  // frames >= t_len stay frozen
  const int t_run = max(t_end, 1);      // frame 0 (the init row) always runs
  const int n_blocks = (t_run + kBlockFrames - 1) / kBlockFrames;
  fill_window(window, src_b, min(kBlockFrames, t_run), row_elems, win_ld, vec);

  // this thread's strip [s0, s0 + R), once: the s-2 penalties and, for K4,
  // the tokens as byte offsets into a window row (added to the row's
  // shared-memory address, which is the same for the whole block)
  const int s0 = threadIdx.x * R;
  const int32_t* tok_b = tokens + static_cast<size_t>(b) * s_pad;
  constexpr int kOffRegs = RAW_GATHER ? R : 1;
  uint32_t tok_off[kOffRegs];
  float pen[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int s = s0 + k;
    const int tk = s < s_pad ? tok_b[s] : 0;
    const int tok2 = (s >= 2 && s - 2 < s_pad) ? tok_b[s - 2] : 0;
    pen[k] = (s >= 2 && tk != tok2) ? 0.0f : neg;
    if (RAW_GATHER) tok_off[k % kOffRegs] = static_cast<uint32_t>(tk) * sizeof(float);
  }
  uint8_t* bp_strip = bp_b + (s0 >> 2);
  const int bp_n = s0 < w ? min(R, w - s0) >> 2 : 0;  // bytes this strip stores
  float sc[R];  // the strip's scores of the last computed frame
#pragma unroll
  for (int k = 0; k < R; ++k) sc[k] = neg;

  const int final_floor = max(s_len - 2, 0);
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int t0 = blk * kBlockFrames;
    const int rows = min(kBlockFrames, t_run - t0);
    if (blk + 1 < n_blocks) {
      const int t1 = t0 + kBlockFrames;
      fill_window(window + ((blk + 1) & 1) * kBlockFrames * win_ld,
                  src_b + static_cast<size_t>(t1) * row_elems,
                  min(kBlockFrames, t_run - t1), row_elems, win_ld, vec);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // this block's rows landed
    const float* win = window + (blk & 1) * kBlockFrames * win_ld;

    for (int i = 0; i < rows; ++i) {
      const int t = t0 + i;
      const float* e_row = win + i * win_ld;
      const uint32_t e_row_addr = static_cast<uint32_t>(__cvta_generic_to_shared(e_row));
      // the strip's emissions of this frame (a strip that meets the band
      // starts inside W, so its reads stay inside the layout)
      float emit[R];
      auto load_emissions = [&]() {
        if (RAW_GATHER) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            asm volatile("ld.shared.f32 %0, [%1];"
                         : "=f"(emit[k]) : "r"(e_row_addr + tok_off[k % kOffRegs]) : "memory");
          }
        } else {
#pragma unroll
          for (int k = 0; k < R; k += 4) {
            const float4 e4 = *reinterpret_cast<const float4*>(e_row + s0 + k);
            emit[k] = e4.x;
            emit[k + 1] = e4.y;
            emit[k + 2] = e4.z;
            emit[k + 3] = e4.w;
          }
        }
      };
      if (t == 0) {
        // the DP init, folded into block 0 row 0
        if (s0 == 0) {
          load_emissions();
          sc[0] = emit[0];
          if (s_len > 1 && s_pad > 1) sc[1] = emit[1];
        }
      } else {
        // the previous frame's scores at s0 - 1 and s0 - 2: from the lane
        // below, or for lane 0 from the warp below's halo
        float left1 = __shfl_up_sync(0xffffffffu, sc[R - 1], 1);
        float left2 = __shfl_up_sync(0xffffffffu, sc[R - 2], 1);
        if (lane == 0) {
          const float* h = halo + ((t - 1) & 1) * 64 + 2 * max(warp - 1, 0);
          left1 = warp > 0 ? h[1] : neg;
          left2 = warp > 0 ? h[0] : neg;
        }
        const int band_lo = max(final_floor - 2 * (t_len - 1 - t), 0);
        const int band_hi = min(2 * t + 1, s_len - 1);
        if (s0 <= band_hi && s0 + R - 1 >= band_lo) {
          load_emissions();
          // from the top state down, so sc[k-1] and sc[k-2] still hold
          // frame t-1; strict > in the order stay, s-1, s-2
          uint32_t m1 = 0, m2 = 0;  // the strip's two bit planes
#pragma unroll
          for (int k = R - 1; k >= 0; --k) {
            float best = sc[k];
            take_if_greater(best, m1, k >= 1 ? sc[k >= 1 ? k - 1 : 0] : left1, 1u << k);
            const float c2 = __fadd_rn(
                k >= 2 ? sc[k >= 2 ? k - 2 : 0] : (k == 1 ? left1 : left2), pen[k]);
            take_if_greater(best, m2, c2, 1u << k);
            sc[k] = __fadd_rn(best, emit[k]);
          }
          store_bits<R>(bp_strip + static_cast<size_t>(t) * n_quads,
                        (static_cast<uint64_t>(m1) & ((uint64_t(1) << (4 * bp_n)) - 1)) |
                            (static_cast<uint64_t>(m2) << (4 * bp_n)),
                        bp_n);
        }
      }
      // publish this frame's last two scores of the warp for the next frame
      if (lane == 31) {
        float* h = halo + (t & 1) * 64 + 2 * warp;
        h[0] = sc[R - 2];
        h[1] = sc[R - 1];
      }
      __syncthreads();
    }
  }

  // final-state rule on the last computed row (or the init row)
  const int idx_last = max(s_len - 1, 0);
  const int idx_prev = max(s_len - 2, 0);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (s0 + k == idx_prev) final_sc[0] = sc[k];
    if (s0 + k == idx_last) final_sc[1] = sc[k];
  }
  __syncthreads();
  const int final_s = (s_len >= 2 && final_sc[0] > final_sc[1]) ? idx_prev : idx_last;

  // The backtrace runs on warp 0. A path that leaves the band does so only
  // above 2t + 1, when no path reaches the final states with a finite
  // score; there it stays (step 0), as it reads the reference's unwritten
  // backpointers, without reading the strips' (which may be unwritten).
  if (threadIdx.x >= 32) return;
  for (int t = t_end + lane; t < t_pad; t += 32) path[t] = final_s;

  if (BP_IN_SMEM) {
    if (lane == 0) {
      int s = final_s;
      for (int t = t_end - 1; t >= 0; --t) {
        path[t] = s;
        if (t >= 1 && s <= 2 * t + 1) {
          const uint8_t* row = bp_smem + static_cast<size_t>(t) * n_quads;
          s -= strip_step<R>(s, w, [&](int i) { return row[i]; });
        }
      }
    }
    return;
  }

  // K3/K4: blocked backtrace over device memory; rows hi..lo read states
  // in [s - 14, s], whose strips lie in the 16 bytes from the strip of
  // max(s - 14, 0)
  uint8_t* bt = bp_smem;  // [8][16]
  int s = final_s;
  for (int hi = t_end - 1; hi >= 0; hi -= kBlockFrames) {
    const int lo = max(hi - (kBlockFrames - 1), 0);
    const int c0 = (max(s - 14, 0) / R) * (R / 4);
    for (int k = lane; k < kBlockFrames * kBtBytes; k += 32) {
      const int r = k / kBtBytes;
      const int col = c0 + (k - r * kBtBytes);
      const int t = hi - r;
      bt[k] = (t >= lo && t >= 1 && col < n_quads)
                  ? bp_b[static_cast<size_t>(t) * n_quads + col] : 0;
    }
    __syncwarp();
    if (lane == 0) {
      for (int t = hi; t >= lo; --t) {
        path[t] = s;
        if (t >= 1 && s <= 2 * t + 1) {
          const uint8_t* row = bt + (hi - t) * kBtBytes;
          s -= strip_step<R>(s, w, [&](int i) { return row[i - c0]; });
        }
      }
    }
    s = __shfl_sync(0xffffffffu, s, 0);
    __syncwarp();
  }
}

template <bool BP_IN_SMEM, bool RAW_GATHER, int R>
int launch_r(const void* src, const void* tokens, const void* t_lens,
             const void* s_lens, void* bp, void* paths, int batch, int t_pad,
             int vocab, int s_pad, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = viterbi_blocked_kernel<BP_IN_SMEM, RAW_GATHER, R>;
  static size_t opted_in = 48 * 1024;  // per instantiation: raised once per new size
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  kernel<<<batch, threads, smem, stream>>>(
      static_cast<const float*>(src), static_cast<const int32_t*>(tokens),
      static_cast<const int32_t*>(t_lens), static_cast<const int32_t*>(s_lens),
      static_cast<uint8_t*>(bp), static_cast<int32_t*>(paths), t_pad, vocab, s_pad);
  return static_cast<int>(cudaGetLastError());
}

template <bool BP_IN_SMEM, bool RAW_GATHER>
int launch(const void* src, const void* tokens, const void* t_lens,
           const void* s_lens, void* bp, void* paths, int batch, int t_pad,
           int vocab, int s_pad, void* stream) {
  if (batch <= 0 || t_pad <= 0) return 0;
  int r = 0, threads = 0;
  strip_shape(round_up4(s_pad), &r, &threads);
  const size_t smem = smem_bytes<BP_IN_SMEM, RAW_GATHER>(t_pad, s_pad, vocab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VITERBI_STRIP(RR)                                                            \
  case RR:                                                                           \
    return launch_r<BP_IN_SMEM, RAW_GATHER, RR>(src, tokens, t_lens, s_lens, bp, paths, \
                                                batch, t_pad, vocab, s_pad, threads,  \
                                                smem, s);
  switch (r) {
    VITERBI_STRIP(4)
    VITERBI_STRIP(8)
    VITERBI_STRIP(16)
    VITERBI_STRIP(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VITERBI_STRIP
}

}  // namespace

// Shared memory one block needs (bytes), for the wrapper's size check.
extern "C" size_t viterbi_k2_smem_bytes(int t_pad, int s_pad, int vocab) {
  return smem_bytes<true, false>(t_pad, s_pad, vocab);
}
extern "C" size_t viterbi_k3_smem_bytes(int t_pad, int s_pad, int vocab) {
  return smem_bytes<false, false>(t_pad, s_pad, vocab);
}
extern "C" size_t viterbi_k4_smem_bytes(int t_pad, int s_pad, int vocab) {
  return smem_bytes<false, true>(t_pad, s_pad, vocab);
}

// The strip width R and the thread count a launch at `s_pad` uses (R = 0:
// no strip serves it), for the wrapper's record.
extern "C" int viterbi_blocked_strip(int s_pad, int* threads) {
  int r = 0;
  strip_shape(round_up4(s_pad), &r, threads);
  return r;
}

// Launchers, on `stream`, for a batch of B utterances. All pointers are
// device pointers to contiguous tensors: src = emissions [B, T_pad, S_pad]
// f32 (K2, K3) or log_probs [B, T_pad, V] f32 (K4); tokens [B, S_pad] i32;
// t_lens/s_lens [B] i32; bp = [B, T_pad, ceil(S_pad / 4)] u8 scratch, 2
// bits a cell (K3, K4; unused by K2); paths [B, T_pad] i32 (output).
// `vocab` is read by K4 only. Each returns cudaGetLastError() after the
// launch (0 = launched) and does not synchronise.
extern "C" int viterbi_k2_launch(const void* emit, const void* tokens,
                                 const void* t_lens, const void* s_lens, void* bp,
                                 void* paths, int batch, int t_pad, int vocab,
                                 int s_pad, void* stream) {
  return launch<true, false>(emit, tokens, t_lens, s_lens, bp, paths, batch, t_pad,
                             vocab, s_pad, stream);
}
extern "C" int viterbi_k3_launch(const void* emit, const void* tokens,
                                 const void* t_lens, const void* s_lens, void* bp,
                                 void* paths, int batch, int t_pad, int vocab,
                                 int s_pad, void* stream) {
  return launch<false, false>(emit, tokens, t_lens, s_lens, bp, paths, batch, t_pad,
                              vocab, s_pad, stream);
}
extern "C" int viterbi_k4_launch(const void* log_probs, const void* tokens,
                                 const void* t_lens, const void* s_lens, void* bp,
                                 void* paths, int batch, int t_pad, int vocab,
                                 int s_pad, void* stream) {
  return launch<false, true>(log_probs, tokens, t_lens, s_lens, bp, paths, batch,
                             t_pad, vocab, s_pad, stream);
}

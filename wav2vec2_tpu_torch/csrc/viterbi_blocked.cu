// Blocked banded CTC Viterbi (K2, K3, K4) for Hopper (sm_90a).
//
// Replaces the three kernels that wav2vec2_tpu/ops/viterbi_pallas.py builds
// from one factory, `_make_blocked_kernel`, and mirrors it with one
// template, `viterbi_blocked_kernel<BP_IN_SMEM, RAW_GATHER>`:
//
//   K2 <true,  false>  `_KERNEL_BP_VMEM` / `_KERNEL_BP_VMEM_BATCH`
//                      pre-gathered emissions, backpointers on chip;
//   K3 <false, false>  `_KERNEL_BP_HBM` / `_KERNEL_BP_HBM_BATCH`
//                      pre-gathered emissions, backpointers in device memory;
//   K4 <false, true>   `_KERNEL_BP_HBM_GATHER` / `_KERNEL_BP_HBM_GATHER_BATCH`
//                      raw log-probs, backpointers in device memory.
//
// The DP is K1's (csrc/viterbi.cu), bit for bit: the band, strict `>` in
// the order stay, s-1, s-2, the tokens[s] != tokens[s-2] skip rule (computed
// here from the staged tokens), one __fadd_rn(best, emit) per cell, frozen
// frames past t_len and the same final-state rule. Build without fast-math.
//
// What bounds them on this card: as for K1, each utterance is a chain of T
// dependent frames separated by block barriers, so latency per frame
// (barrier plus the shared-memory work of S states spread over at most
// 1024 threads), not bandwidth or arithmetic, is the limit. At hour scale
// (T = 180 000, S up to 12 672) two more costs appear: the emission traffic
// of each frame, and the backtrace, which in K1 is one dependent
// device-memory load per frame on one thread.
//
// What the design does about it:
// - one block per utterance (grid = B); a loop over 8-frame blocks inside
//   the block replaces the TPU's sequential grid;
// - the emission rows of block b+1 stream into a double-buffered [2, 8, W]
//   shared-memory window with cp.async while block b computes (16-byte
//   copies when rows and addresses allow, 4-byte ones otherwise);
// - K4 keeps raw [8, V] log-prob rows in the window and reads
//   win[i][tok[s]] from shared memory: the indexed-load counterpart of the
//   TPU's exact one-hot MXU product, so neither a [T, S] emission array nor
//   a one-hot matrix exists;
// - one state per thread per pass, as in K1 (neighbouring threads on
//   neighbouring states: no shared-memory bank conflicts); K2 packs the
//   backpointers of 4 neighbouring lanes into one byte (2 bits a cell) with
//   two warp shuffles, so one lane writes each byte and no write races;
//   K3/K4 store one uint8 a cell;
// - K2 keeps the whole utterance's packed backpointers in shared memory and
//   walks them there; K3/K4 keep uint8 backpointers in device memory
//   ([B, T_pad, 4 * ceil(S_pad / 4)], allocated by the caller) and walk
//   them by blocks: in 8 frames the state falls by at most 14, so one warp
//   loads the 8 x 16-byte window bp[t0..t0+7, s-15..s] in one round trip,
//   and lane 0 walks the 8 frames from shared memory — one dependent
//   device-memory round trip per 8 frames instead of one per frame.
// Later work: warp-shuffle shifts, several utterances per block, 2-bit
// backpointers in device memory, and a thread-block cluster that splits the
// rows of an S_pad beyond one SM's shared memory over distributed shared
// memory.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockFrames = 8;   // frames per streamed block
constexpr int kBtCols = 16;       // backtrace window width (states)

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

// Shared-memory layout, in this order (the window first, 16-byte aligned):
//   window [2][8][win_ld] f32   win_ld = round_up4(S_pad) or round_up4(V)
//   rows   [2][W] f32           W = 4 * ceil(S_pad / 4)
//   tok    [W] i32
//   bp     K2: [T_pad][W / 4] packed bytes; K3/K4: [8][16] bytes (backtrace)
template <bool BP_IN_SMEM, bool RAW_GATHER>
__host__ __device__ inline size_t smem_bytes(int t_pad, int s_pad, int vocab) {
  const size_t w = static_cast<size_t>(round_up4(s_pad));
  const size_t win_ld = RAW_GATHER ? round_up4(vocab) : w;
  size_t bytes = 2 * kBlockFrames * win_ld * sizeof(float) + 2 * w * sizeof(float) +
                 w * sizeof(int32_t);
  bytes += BP_IN_SMEM ? static_cast<size_t>(t_pad) * (w / 4)
                      : static_cast<size_t>(kBlockFrames) * kBtCols;
  return bytes;
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

// src: RAW_GATHER ? log_probs [B, T_pad, V] : emissions [B, T_pad, S_pad]
template <bool BP_IN_SMEM, bool RAW_GATHER>
__global__ void viterbi_blocked_kernel(const float* __restrict__ src,
                                       const int32_t* __restrict__ tokens,
                                       const int32_t* __restrict__ t_lens,
                                       const int32_t* __restrict__ s_lens,
                                       uint8_t* __restrict__ bp_global,
                                       int32_t* __restrict__ paths, int t_pad,
                                       int vocab, int s_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = round_up4(s_pad);
  const int n_quads = w >> 2;
  const int w32 = (w + 31) & ~31;
  const int row_elems = RAW_GATHER ? vocab : s_pad;
  const int win_ld = round_up4(row_elems);
  float* window = reinterpret_cast<float*>(smem);
  float* row_a = window + 2 * kBlockFrames * win_ld;
  float* row_b = row_a + w;
  int32_t* tok = reinterpret_cast<int32_t*>(row_b + w);
  uint8_t* bp_smem = reinterpret_cast<uint8_t*>(tok + w);

  const int b = blockIdx.x;
  const float* src_b = src + static_cast<size_t>(b) * t_pad * row_elems;
  // K3/K4: one row of 4 * n_quads bytes per frame
  uint8_t* bp_b = BP_IN_SMEM ? nullptr
                             : bp_global + static_cast<size_t>(b) * t_pad * w;
  int32_t* path = paths + static_cast<size_t>(b) * t_pad;
  const int t_len = t_lens[b];
  const int s_len = min(s_lens[b], s_pad);
  const float neg = -CUDART_INF_F;
  const bool vec = (row_elems & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(src_b) & 15) == 0;

  for (int s = threadIdx.x; s < w; s += blockDim.x) {
    tok[s] = s < s_pad ? tokens[static_cast<size_t>(b) * s_pad + s] : 0;
  }

  const int t_end = max(min(t_len, t_pad), 0);  // frames >= t_len stay frozen
  const int t_run = max(t_end, 1);      // frame 0 (the init row) always runs
  const int n_blocks = (t_run + kBlockFrames - 1) / kBlockFrames;
  fill_window(window, src_b, min(kBlockFrames, t_run), row_elems, win_ld, vec);

  float* prev = row_a;
  float* curr = row_b;
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
    __syncthreads();  // this block's rows (and, at blk 0, the tokens) landed
    const float* win = window + (blk & 1) * kBlockFrames * win_ld;

    for (int i = 0; i < rows; ++i) {
      const int t = t0 + i;
      const float* e_row = win + i * win_ld;
      if (t == 0) {
        // the DP init, folded into block 0 row 0
        for (int s = threadIdx.x; s < w; s += blockDim.x) {
          const bool live = s == 0 || (s == 1 && s_len > 1);
          prev[s] = (live && s < s_pad) ? e_row[RAW_GATHER ? tok[s] : s] : neg;
        }
        __syncthreads();
        continue;
      }
      const int curr_start = max(final_floor - 2 * (t_len - 1 - t), 0);
      const int curr_end = min(2 * t + 1, s_len - 1);
      // one state per thread, neighbouring threads on neighbouring states
      // (no shared-memory bank conflicts); every lane of a warp runs the
      // same iterations, so the K2 packing can shuffle across each group
      // of 4 lanes
      for (int s = threadIdx.x; s < w32; s += blockDim.x) {
        float val = neg;
        uint32_t step = 0;
        if (s >= curr_start && s <= curr_end) {
          float best = prev[s];
          if (s >= 1) {
            const float c1 = prev[s - 1];
            if (c1 > best) { best = c1; step = 1; }
          }
          if (s >= 2 && tok[s] != tok[s - 2]) {
            const float c2 = prev[s - 2];
            if (c2 > best) { best = c2; step = 2; }
          }
          val = __fadd_rn(best, e_row[RAW_GATHER ? tok[s] : s]);
        }
        if (s < w) curr[s] = val;
        if (BP_IN_SMEM) {
          // 2 bits a cell: lanes 4j..4j+3 OR their steps into one byte
          uint32_t bits = step << (2 * (s & 3));
          bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
          bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
          if ((s & 3) == 0 && s < w) {
            bp_smem[static_cast<size_t>(t) * n_quads + (s >> 2)] = static_cast<uint8_t>(bits);
          }
        } else if (s < w) {
          bp_b[static_cast<size_t>(t) * w + s] = static_cast<uint8_t>(step);
        }
      }
      __syncthreads();
      float* tmp = prev;
      prev = curr;
      curr = tmp;
    }
  }

  // final-state rule; prev is the last computed row (or the init row)
  const int idx_last = max(s_len - 1, 0);
  const int idx_prev = max(s_len - 2, 0);
  const int final_s =
      (s_len >= 2 && prev[idx_prev] > prev[idx_last]) ? idx_prev : idx_last;

  if (threadIdx.x >= 32) return;  // the backtrace runs on warp 0
  const int lane = threadIdx.x;
  for (int t = t_end + lane; t < t_pad; t += 32) path[t] = final_s;

  if (BP_IN_SMEM) {
    if (lane == 0) {
      int s = final_s;
      for (int t = t_end - 1; t >= 0; --t) {
        path[t] = s;
        if (t >= 1) {
          const uint8_t byte = bp_smem[static_cast<size_t>(t) * n_quads + (s >> 2)];
          s -= (byte >> (2 * (s & 3))) & 3;
        }
      }
    }
    return;
  }

  // K3/K4: blocked backtrace over device memory
  uint8_t* bt = bp_smem;  // [8][16]
  int s = final_s;
  for (int hi = t_end - 1; hi >= 0; hi -= kBlockFrames) {
    const int lo = max(hi - (kBlockFrames - 1), 0);
    const int c0 = s - (kBtCols - 1);
    for (int k = lane; k < kBlockFrames * kBtCols; k += 32) {
      const int r = k / kBtCols;
      const int col = c0 + (k - r * kBtCols);
      const int t = hi - r;
      bt[k] = (t >= lo && t >= 1 && col >= 0) ? bp_b[static_cast<size_t>(t) * w + col] : 0;
    }
    __syncwarp();
    if (lane == 0) {
      for (int t = hi; t >= lo; --t) {
        path[t] = s;
        if (t >= 1) s -= bt[(hi - t) * kBtCols + (s - c0)];
      }
    }
    s = __shfl_sync(0xffffffffu, s, 0);
    __syncwarp();
  }
}

template <bool BP_IN_SMEM, bool RAW_GATHER>
int launch(const void* src, const void* tokens, const void* t_lens,
           const void* s_lens, void* bp, void* paths, int batch, int t_pad,
           int vocab, int s_pad, void* stream) {
  if (batch <= 0 || t_pad <= 0) return 0;
  int threads = ((round_up4(s_pad) + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  const size_t smem = smem_bytes<BP_IN_SMEM, RAW_GATHER>(t_pad, s_pad, vocab);
  auto kernel = viterbi_blocked_kernel<BP_IN_SMEM, RAW_GATHER>;
  static size_t opted_in = 48 * 1024;  // per instantiation: raised once per new size
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int32_t*>(tokens),
      static_cast<const int32_t*>(t_lens), static_cast<const int32_t*>(s_lens),
      static_cast<uint8_t*>(bp), static_cast<int32_t*>(paths), t_pad, vocab, s_pad);
  return static_cast<int>(cudaGetLastError());
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

// Launchers, on `stream`, for a batch of B utterances. All pointers are
// device pointers to contiguous tensors: src = emissions [B, T_pad, S_pad]
// f32 (K2, K3) or log_probs [B, T_pad, V] f32 (K4); tokens [B, S_pad] i32;
// t_lens/s_lens [B] i32; bp = [B, T_pad, 4 * ceil(S_pad / 4)] u8 scratch
// (K3, K4; unused by K2); paths [B, T_pad] i32 (output). `vocab` is read by
// K4 only. Each returns cudaGetLastError() after the launch (0 = launched)
// and does not synchronise.
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

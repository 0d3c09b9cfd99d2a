// Banded CTC Viterbi with in-kernel backtrace (K1) for Hopper (sm_90a).
//
// Replaces wav2vec2_tpu/ops/viterbi_pallas.py::_viterbi_kernel_resident,
// the TPU kernel that `viterbi_pallas_single` launches and
// `viterbi_pallas_batch` vmaps at the serving shape. It computes the same
// DP as wav2vec2_tpu/ops/viterbi_ref.py (band, strict `>` tie order
// stay > s-1 > s-2, the tokens[s] != tokens[s-2] skip rule, frozen frames
// past t_len, the final-state rule) for a whole padded batch, one block per
// utterance, and writes only the int32 state path of each utterance.
//
// What bounds it on this card: each utterance is a sequential chain of T
// frames, and frame t needs all of frame t-1. The bytes (the log-prob rows
// once, the path once) and the arithmetic (a few operations a band cell)
// are far below the card's limits; the latency of one frame's chain, and
// then of the backtrace's T dependent steps, is what sets the time. In the
// resident mode a frame is each warp's short in-order sequence (a halo
// load, the cells, shuffles, the plane stores, a barrier) whose latencies
// add up: removing any one piece measured to save 30-80 of the frame's
// ~420 cycles at the serving shape (PERF.md).
//
// Two modes, chosen by shape (`viterbi_k1_resident`; the wrapper launches
// the mode the shape takes and never retries in the other):
//
// Resident mode, where the ring and the backpointers fit in shared memory
// (the TPU kernel's VMEM residency, on the SM). The frame loop and the
// backtrace touch no device memory:
// - the utterance's log-prob rows, [t_len, V] f32 and contiguous, stream
//   into a ring of 16-frame chunks in shared memory before and during the
//   DP, each chunk completing on its own mbarrier: one TMA bulk copy
//   (cp.async.bulk) issued by one thread where V * 4 and the rows' address
//   are multiples of 16, else 4-byte cp.async copies by every thread
//   tracked by the same mbarrier (cp.async.mbarrier.arrive.noinc). The
//   ring has 4 slots: the first 4 chunks are issued before the DP, and a
//   slot takes the chunk 4 further on as soon as the frame loop has read
//   its last frame, so copies run 3-4 chunks (48-64 frames) ahead;
// - each thread owns a strip of R states (R in {1, 2, 4, 8}; 2 by the
//   launcher's rule where 512 threads cover S_pad) and keeps in registers,
//   for the whole DP, the strip's scores of the last frame, its s-2
//   penalties (0, or -inf where the skip rule forbids s-2) and its tokens
//   as byte offsets into a ring row; frame t+1's emissions are read from
//   the ring while frame t computes, so their latency is hidden;
// - a cell's score is max(stay, s-1, s-2) + emit (two max operations and
//   one add), and its two step bits come from two compares beside that
//   chain;
// - the s-1 and s-2 scores left of a strip come from the lane below by
//   __shfl_up_sync; across warps a halo double-buffered by frame parity
//   keeps one __syncthreads a frame, and an utterance that one warp covers
//   runs with no barrier a frame at all (a __syncwarp before each refill);
// - no per-cell band test: a strip is computed when it meets the band and
//   skipped otherwise, and its cells outside the band are computed like the
//   others (the argument of csrc/viterbi_blocked.cu: cells above 2t + 1 are
//   -inf by induction; cells below the band or at or past s_len feed only
//   cells outside it; neither the final-state rule nor the backtrace reads
//   one);
// - backpointers are 2 bits a cell in shared memory, rows of W / 4 bytes
//   (W = S_pad rounded up to 4; the row stride rounded up to 8 bytes): byte
//   i holds states 4i..4i+3, bit k of its low nibble set where s-1 beat the
//   stay, bit k of its high nibble where s-2 won. Every byte below W is
//   written every frame (0 for a strip outside the band): at R = 1 a
//   warp's 32 states go in with two __ballot_sync and one 8-byte store, at
//   R = 2 two lanes form a byte (two shuffles), at R = 4 and 8 a thread
//   stores its 1 or 2 bytes;
// - the final-state rule and the backtrace run from the resident bit
//   planes: a step is one byte load and four ALU operations on one thread,
//   with no band test, writing the path into a [T_pad] int32 row in shared
//   memory; one coalesced block-wide copy stores it. A cell above 2t + 1
//   has no finite candidate, so its bits are 0: where no finite path
//   reaches the final states the backtrace stays (step 0) there, as it
//   does over the reference's zero-filled backpointers.
//
// Device mode, for the shapes whose backpointers do not fit (wide S_pad at
// T_pad <= 512, hour-scale checks, S_pad past K2-K4's strips): the first
// version of this kernel. The DP rows ping-pong in shared memory, threads
// stride over the states, emissions are read from log_probs[b, t,
// tokens[s]] in device memory, backpointers are one byte a cell in device
// memory ([B, T_pad, S_pad], allocated by the caller) and one thread walks
// them at the end.
//
// Bit-identity: every cell is one IEEE f32 add best + emit (__fadd_rn, so
// no contraction), -inf + x stays -inf, and comparisons are strict. Build
// without fast-math.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kChunkFrames = 16;  // frames in one ring slot
constexpr int kMaxSlots = 4;      // ring slots at most
constexpr int kMaxThreads = 512;  // threads a resident block takes at most
constexpr int kMaxStrip = 8;      // widest resident strip
constexpr int kMaxResidentStates = kMaxThreads * kMaxStrip;
// The least R the launcher takes. At the serving shape R = 1 and R = 2
// measured alike and R = 4, 8 slower (chip_smoke.py's strip sweep,
// PERF.md); R = 2 keeps half the warps, and one warp up to S_pad = 64.
constexpr int kPreferredStrip = 2;
constexpr size_t kMaxSmemBytes = 232448;  // per block on H100, opt-in
constexpr size_t kBarBytes = kMaxSlots * sizeof(uint64_t);
constexpr size_t kHaloBytes = 2 * 32 * 2 * sizeof(float);  // [parity][warp][2]
constexpr size_t kFinalBytes = 16;                         // final-state scores

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline size_t round_up16(size_t x) { return (x + 15) & ~size_t(15); }
// bytes from one backpointer row to the next: W / 4 rounded up to 8
__host__ __device__ inline int plane_stride(int s_pad) { return ((round_up4(s_pad) >> 2) + 7) & ~7; }

// Shared-memory layout of the resident mode, in this order: the ring's
// mbarriers [4] u64; the ring [slots][16][V] f32 (each slot rounded up to
// 16 bytes); the halo [2][32][2] f32; the final scores [2] f32; the path
// row [T_pad] i32; the bit planes [T_pad][plane_stride] bytes. `slots` is
// the most chunks (at most 4, at most the chunks of T_pad) that fit beside
// the rest, and 0 when fewer than two (one where T_pad is one chunk) fit or
// W exceeds the strips: then the shape takes the device mode.
struct ResidentLayout {
  int slots;
  size_t chunk_bytes, ring, halo, final_sc, path, planes, total;
};

__host__ __device__ inline ResidentLayout resident_layout(int t_pad, int s_pad, int vocab) {
  ResidentLayout l{};
  const size_t w = static_cast<size_t>(round_up4(s_pad));
  const size_t path_bytes = round_up16(static_cast<size_t>(t_pad) * sizeof(int32_t));
  const size_t plane_bytes = round_up16(static_cast<size_t>(t_pad) * plane_stride(s_pad));
  const size_t fixed = kBarBytes + kHaloBytes + kFinalBytes + path_bytes + plane_bytes;
  l.chunk_bytes = round_up16(static_cast<size_t>(kChunkFrames) * (vocab > 0 ? vocab : 1) *
                             sizeof(float));
  const int n_chunks = (t_pad + kChunkFrames - 1) / kChunkFrames;
  if (t_pad > 0 && w <= kMaxResidentStates && fixed < kMaxSmemBytes) {
    const size_t fit = (kMaxSmemBytes - fixed) / l.chunk_bytes;
    const int want = n_chunks < kMaxSlots ? n_chunks : kMaxSlots;
    l.slots = fit < static_cast<size_t>(want) ? static_cast<int>(fit) : want;
    if (l.slots < (n_chunks < 2 ? n_chunks : 2)) l.slots = 0;
  }
  l.ring = kBarBytes;
  l.halo = l.ring + static_cast<size_t>(l.slots) * l.chunk_bytes;
  l.final_sc = l.halo + kHaloBytes;
  l.path = l.final_sc + kFinalBytes;
  l.planes = l.path + path_bytes;
  l.total = l.planes + plane_bytes;
  return l;
}

__host__ __device__ inline size_t device_smem_bytes(int s_pad) {
  return static_cast<size_t>(s_pad) * (2 * sizeof(float) + sizeof(int32_t));
}

// Strip width R and thread count of a resident launch over W states: the
// least R >= `least` in {1, 2, 4, 8} with round32(ceil(W / R)) <= 512.
// R = 0 when none.
__host__ inline int resident_strip(int w, int least, int* threads) {
  for (int r = least; r <= kMaxStrip; r *= 2) {
    const int t = (((w + r - 1) / r + 31) / 32) * 32;
    if (t <= kMaxThreads) {
      *threads = t < 32 ? 32 : t;
      return r;
    }
  }
  *threads = 0;
  return 0;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Start the copy of chunk `c` (frames [16c, min(16c + 16, t_run))) of the
// utterance's rows `src_b` into ring slot c % slots, completing on that
// slot's mbarrier: one bulk copy by thread 0, or every thread's 4-byte
// copies and one arrive tracking them. Called by every thread.
__device__ inline void issue_chunk(unsigned char* ring, const uint64_t* bars,
                                   const float* src_b, int c, int slots,
                                   size_t chunk_bytes, int t_run, int vocab, bool bulk) {
  const int slot = c % slots;
  const int f0 = c * kChunkFrames;
  const int n = min(kChunkFrames, t_run - f0) * vocab;
  float* dst = reinterpret_cast<float*>(ring + static_cast<size_t>(slot) * chunk_bytes);
  const float* src = src_b + static_cast<size_t>(f0) * vocab;
  const uint32_t bar = shared_addr(bars + slot);
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(n) * sizeof(float);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                   "[%0], [%1], %2, [%3];"
                   :: "r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
    }
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      __pipeline_memcpy_async(dst + k, src + k, sizeof(float));
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" :: "r"(bar) : "memory");
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
viterbi_k1_resident_kernel(const float* __restrict__ log_probs,
                           const int32_t* __restrict__ tokens,
                           const int32_t* __restrict__ t_lens,
                           const int32_t* __restrict__ s_lens,
                           int32_t* __restrict__ paths, int t_pad, int vocab, int s_pad) {
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  const ResidentLayout lay = resident_layout(t_pad, s_pad, vocab);
  const uint64_t* bars = reinterpret_cast<const uint64_t*>(smem);
  unsigned char* ring = smem + lay.ring;
  float* halo = reinterpret_cast<float*>(smem + lay.halo);
  float* final_sc = reinterpret_cast<float*>(smem + lay.final_sc);
  int32_t* path_s = reinterpret_cast<int32_t*>(smem + lay.path);
  uint8_t* planes = smem + lay.planes;
  const int slots = lay.slots;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool one_warp = blockDim.x == 32;
  const float* src_b = log_probs + static_cast<size_t>(b) * t_pad * vocab;
  const int t_len = t_lens[b];
  const int s_len = min(s_lens[b], s_pad);  // the final-state rule indexes rows
  const int w = round_up4(s_pad);
  const int stride = plane_stride(s_pad);
  const float neg = -CUDART_INF_F;
  const int t_end = max(min(t_len, t_pad), 0);  // frames >= t_len stay frozen
  const int t_run = max(t_end, 1);              // frame 0 (the init row) always runs
  const int n_chunks = (t_run + kChunkFrames - 1) / kChunkFrames;
  const int first = min(slots, n_chunks);
  const bool bulk = (vocab & 3) == 0 && (reinterpret_cast<uintptr_t>(src_b) & 15) == 0;

  if (tid == 0) {
    for (int i = 0; i < first; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(shared_addr(bars + i)), "r"(bulk ? 1u : blockDim.x) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the init row is -inf past s = 1, and so is every warp's halo for frame 0
  for (int i = tid; i < 2 * 32 * 2; i += blockDim.x) halo[i] = neg;
  __syncthreads();
  for (int c = 0; c < first; ++c) {
    issue_chunk(ring, bars, src_b, c, slots, lay.chunk_bytes, t_run, vocab, bulk);
  }

  // this thread's strip [s0, s0 + R), once: the s-2 penalties and the
  // tokens as byte offsets into a ring row
  const int s0 = tid * R;
  const int32_t* tok_b = tokens + static_cast<size_t>(b) * s_pad;
  uint32_t tok_off[R];
  float pen[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int s = s0 + k;
    const int tk = s < s_pad ? tok_b[s] : 0;
    const int tok2 = (s >= 2 && s - 2 < s_pad) ? tok_b[s - 2] : 0;
    pen[k] = (s >= 2 && tk != tok2) ? 0.0f : neg;
    tok_off[k] = static_cast<uint32_t>(tk) * sizeof(float);
  }

  // the ring reader: frames are read in order 0, 1, 2, ...; a frame that
  // opens a chunk waits for that chunk's copy (the slot's k-th use
  // completes its barrier's phase k)
  const uint32_t bars_addr = shared_addr(bars);
  int rd_slot = 0;
  uint32_t rd_parity = 0;
  const unsigned char* rd_row = ring;
  // plain shared-memory loads (no asm), which the compiler may schedule
  // among the frame's other work; the mbarrier waits order them after the
  // copies
  auto load_row = [&](float (&e)[R]) {
#pragma unroll
    for (int k = 0; k < R; ++k) e[k] = *reinterpret_cast<const float*>(rd_row + tok_off[k]);
  };
  auto next_frame = [&](int f) {
    if ((f & (kChunkFrames - 1)) == 0) {
      if (++rd_slot == slots) {
        rd_slot = 0;
        rd_parity ^= 1u;
      }
      rd_row = ring + static_cast<size_t>(rd_slot) * lay.chunk_bytes;
      mbar_wait(bars_addr + 8u * rd_slot, rd_parity);
    } else {
      rd_row += vocab * sizeof(float);
    }
  };

  // the DP init: s = 0, and s = 1 when s_len > 1
  float sc[R];
  float en[R];  // the emissions of the next frame
  mbar_wait(bars_addr, 0);
  load_row(en);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int s = s0 + k;
    sc[k] = (s == 0 || (s == 1 && s_len > 1)) ? en[k] : neg;
  }
  if (t_end > 1) {
    next_frame(1);
    load_row(en);
  }

  // Per frame, the chain that sets the time runs barrier -> halo load ->
  // the strip's cells -> halo store -> barrier. The rest is kept off it
  // where it can be: the shuffles for frame t+1 and the bit-plane stores
  // overlap the halo store before the barrier, and frame t+1's emissions
  // are read before frame t computes. The lane-dependent addresses and
  // flags are made once, and opaque, so the loop does not recompute them
  // from %tid.
  uint32_t halo_rd = 2u * static_cast<uint32_t>(max(warp - 1, 0));  // float index
  uint32_t halo_wr = 2u * static_cast<uint32_t>(warp);
  uint32_t lane_flags = (lane == 0 ? 1u : 0u) | (R == 1 && lane == 1 ? 2u : 0u) |
                        (!one_warp && warp > 0 && lane < (R == 1 ? 2 : 1) ? 4u : 0u) |
                        (one_warp ? 8u : 0u) |
                        (!one_warp && lane >= (R == 1 ? 30 : 31) ? 16u : 0u);
  asm("" : "+r"(halo_rd), "+r"(halo_wr), "+r"(lane_flags));
  const bool is_lane0 = lane_flags & 1u, is_lane1 = lane_flags & 2u;
  const bool reads_halo = lane_flags & 4u, no_barrier = lane_flags & 8u;
  const bool writes_halo = lane_flags & 16u;
  // the band in terms of 2t: a strip meets it where s0 - 1 <= 2t <= hi2
  const int final_floor = max(s_len - 2, 0);
  const int hi2 = s0 + R - 1 - (final_floor - 2 * (t_len - 1));
  const bool below_s_len = s0 <= s_len - 1;
  // the scores at s0 - 1 and s0 - 2 of the frame before, from the lanes
  // below (lanes without one below take the halo's after the barrier)
  float left1 = __shfl_up_sync(kFull, sc[R - 1], 1);
  float left2 = R == 1 ? __shfl_up_sync(kFull, sc[0], 2)
                       : __shfl_up_sync(kFull, sc[R >= 2 ? R - 2 : 0], 1);
  uint32_t m1 = 0, m2 = 0;  // the strip's two bit planes of the frame
  // frame t's planes into its row, byte i holding states 4i..4i+3: m1 in
  // the low nibble, m2 in the high one
  auto store_planes = [&](int t) {
    uint8_t* row = planes + t * stride;
    if constexpr (R == 1) {
      const uint32_t p1 = __ballot_sync(kFull, m1 != 0);
      const uint32_t p2 = __ballot_sync(kFull, m2 != 0);
      if (is_lane0 && warp * 32 < w) {
        // nibbles 0, 2, 4, 6 and 1, 3, 5, 7 of both planes, then bytes
        // interleaved (the 8 bytes stay inside the row's stride)
        const uint32_t even = (p1 & 0x0f0f0f0fu) | ((p2 << 4) & 0xf0f0f0f0u);
        const uint32_t odd = ((p1 >> 4) & 0x0f0f0f0fu) | (p2 & 0xf0f0f0f0u);
        *reinterpret_cast<uint2*>(row + warp * 8) =
            make_uint2(__byte_perm(even, odd, 0x5140), __byte_perm(even, odd, 0x7362));
      }
    } else if constexpr (R == 2) {
      // lanes 2i and 2i+1 form one byte
      const uint32_t o1 = __shfl_down_sync(kFull, m1, 1);
      const uint32_t o2 = __shfl_down_sync(kFull, m2, 1);
      if ((lane & 1) == 0 && s0 < w) {
        row[s0 >> 2] = static_cast<uint8_t>((m1 | (o1 << 2)) | ((m2 | (o2 << 2)) << 4));
      }
    } else if (s0 < w) {
      uint32_t bits = 0;  // R / 4 bytes (the last may fall in the row's padding)
#pragma unroll
      for (int j = 0; j < R / 4; ++j) {
        bits |= (((m1 >> (4 * j)) & 0xfu) | (((m2 >> (4 * j)) & 0xfu) << 4)) << (8 * j);
      }
      if constexpr (R == 4) {
        row[s0 >> 2] = static_cast<uint8_t>(bits);
      } else {
        *reinterpret_cast<uint16_t*>(row + (s0 >> 2)) = static_cast<uint16_t>(bits);
      }
    }
  };

  for (int t = 1; t < t_end; ++t) {
    const uint32_t parity_off = static_cast<uint32_t>((t & 1) * 64);
    float h0 = neg, h1 = neg;  // the warp below's last two scores of frame t-1
    if (reads_halo) {
      const float2 h = *reinterpret_cast<const float2*>(halo + halo_rd + (64u - parity_off));
      h0 = h.x;
      h1 = h.y;
    }
    float ec[R];
#pragma unroll
    for (int k = 0; k < R; ++k) ec[k] = en[k];
    if (t + 1 < t_end) {  // frame t+1's reads overlap frame t
      next_frame(t + 1);
      load_row(en);
    }
    if (is_lane0) {
      left1 = h1;
      left2 = h0;
    } else if (is_lane1) {
      left2 = h1;
    }
    m1 = 0;
    m2 = 0;
    if (below_s_len && s0 - 1 <= 2 * t && 2 * t <= hi2) {
      // from the top state down, so sc[k-1] and sc[k-2] still hold frame
      // t-1. The score is max(stay, s-1, s-2) + emit: the scores hold no
      // NaN, so a max picks the value the strict-> selection in the order
      // stay, s-1, s-2 picks (up to the sign of a zero, which no strict
      // comparison sees), in two max operations instead of a chain of
      // compare-selects; the steps' bits come off that chain: s-1 beat
      // the stay, s-2 beat both
#pragma unroll
      for (int k = R - 1; k >= 0; --k) {
        const float stay = sc[k];
        const float c1 = k >= 1 ? sc[k >= 1 ? k - 1 : 0] : left1;
        const float c2 = __fadd_rn(
            k >= 2 ? sc[k >= 2 ? k - 2 : 0] : (k == 1 ? left1 : left2), pen[k]);
        const float b1 = fmaxf(stay, c1);
        m1 |= c1 > stay ? 1u << k : 0u;
        m2 |= c2 > b1 ? 1u << k : 0u;
        sc[k] = __fadd_rn(fmaxf(b1, c2), ec[k]);
      }
    }
    // publish this frame's last two scores of the warp, and take the lanes
    // below's for the next frame
    if (writes_halo) {
      if constexpr (R == 1) {
        halo[halo_wr + parity_off + (lane - 30)] = sc[0];
      } else {
        *reinterpret_cast<float2*>(halo + halo_wr + parity_off) =
            make_float2(sc[R >= 2 ? R - 2 : 0], sc[R - 1]);
      }
    }
    left1 = __shfl_up_sync(kFull, sc[R - 1], 1);
    left2 = R == 1 ? __shfl_up_sync(kFull, sc[0], 2)
                   : __shfl_up_sync(kFull, sc[R >= 2 ? R - 2 : 0], 1);
    store_planes(t);
    // one warp needs no barrier a frame: its lanes share scores by shuffle,
    // and only a refill waits for all of them
    if (!no_barrier) __syncthreads();
    // frame t+1 was the last of its chunk: every thread has read it, so its
    // slot takes the chunk `slots` further on
    if (((t + 2) & (kChunkFrames - 1)) == 0) {
      const int c = (t + 2) / kChunkFrames - 1 + slots;
      if (c < n_chunks) {
        if (no_barrier) __syncwarp();
        issue_chunk(ring, bars, src_b, c, slots, lay.chunk_bytes, t_run, vocab, bulk);
      }
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

  // the backtrace from the resident planes into the shared path row; a
  // path that leaves the band does so only above 2t + 1 (no finite path
  // reaches the final states), and there it stays
  for (int t = t_end + tid; t < t_pad; t += blockDim.x) path_s[t] = final_s;
  if (tid == 0 && t_end > 0) {
    // every row's bytes below W were written, and a cell above 2t + 1 has
    // no finite candidate, so its bits are 0 and the walk stays there
    int s = final_s;
    for (int t = t_end - 1; t >= 1; --t) {
      path_s[t] = s;
      const int x = planes[t * stride + (s >> 2)] >> (s & 3);
      s -= (x & 0x10) ? 2 : (x & 1);
    }
    path_s[0] = s;
  }
  __syncthreads();
  int32_t* path = paths + static_cast<size_t>(b) * t_pad;
  for (int t = tid; t < t_pad; t += blockDim.x) path[t] = path_s[t];
}

__global__ void viterbi_k1_device_kernel(const float* __restrict__ log_probs,
                                         const int32_t* __restrict__ tokens,
                                         const int32_t* __restrict__ t_lens,
                                         const int32_t* __restrict__ s_lens,
                                         uint8_t* __restrict__ bp,
                                         int32_t* __restrict__ paths,
                                         int t_pad, int vocab, int s_pad) {
  extern __shared__ float smem_rows[];
  float* row_a = smem_rows;
  float* row_b = smem_rows + s_pad;
  int32_t* tok = reinterpret_cast<int32_t*>(smem_rows + 2 * s_pad);

  const int b = blockIdx.x;
  const float* lp = log_probs + static_cast<size_t>(b) * t_pad * vocab;
  uint8_t* bp_b = bp + static_cast<size_t>(b) * t_pad * s_pad;
  int32_t* path = paths + static_cast<size_t>(b) * t_pad;
  const int t_len = t_lens[b];
  const int s_len = min(s_lens[b], s_pad);  // the final-state rule indexes rows
  const float neg = -CUDART_INF_F;

  for (int s = threadIdx.x; s < s_pad; s += blockDim.x) {
    tok[s] = tokens[static_cast<size_t>(b) * s_pad + s];
  }
  __syncthreads();

  // init row: s = 0, and s = 1 when s_len > 1
  for (int s = threadIdx.x; s < s_pad; s += blockDim.x) {
    row_a[s] = (s == 0 || (s == 1 && s_len > 1)) ? lp[tok[s]] : neg;
  }
  __syncthreads();

  float* prev = row_a;
  float* curr = row_b;
  const int final_floor = max(s_len - 2, 0);
  const int t_end = min(t_len, t_pad);  // frames >= t_len stay frozen
  for (int t = 1; t < t_end; ++t) {
    const int curr_start = max(final_floor - 2 * (t_len - 1 - t), 0);
    const int curr_end = min(2 * t + 1, s_len - 1);
    const float* lp_t = lp + static_cast<size_t>(t) * vocab;
    uint8_t* bp_t = bp_b + static_cast<size_t>(t) * s_pad;
    for (int s = threadIdx.x; s < s_pad; s += blockDim.x) {
      if (s < curr_start || s > curr_end) {
        curr[s] = neg;
        bp_t[s] = 0;
        continue;
      }
      float best = prev[s];
      uint8_t step = 0;
      if (s >= 1) {
        const float c1 = prev[s - 1];
        if (c1 > best) { best = c1; step = 1; }
      }
      if (s >= 2 && tok[s] != tok[s - 2]) {
        const float c2 = prev[s - 2];
        if (c2 > best) { best = c2; step = 2; }
      }
      curr[s] = __fadd_rn(best, lp_t[tok[s]]);
      bp_t[s] = step;
    }
    __syncthreads();
    float* tmp = prev;
    prev = curr;
    curr = tmp;
  }

  if (threadIdx.x == 0) {
    const int idx_last = max(s_len - 1, 0);
    const int idx_prev = max(s_len - 2, 0);
    int s = (s_len >= 2 && prev[idx_prev] > prev[idx_last]) ? idx_prev : idx_last;
    for (int t = t_pad - 1; t >= 0; --t) {
      path[t] = s;
      if (t >= 1 && t < t_len) s -= bp_b[static_cast<size_t>(t) * s_pad + s];
    }
  }
}

template <int R>
int launch_resident_r(const void* log_probs, const void* tokens, const void* t_lens,
                      const void* s_lens, void* paths, int batch, int t_pad, int vocab,
                      int s_pad, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = viterbi_k1_resident_kernel<R>;
  static size_t opted_in = 48 * 1024;  // per instantiation: raised once per new size
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  kernel<<<batch, threads, smem, stream>>>(
      static_cast<const float*>(log_probs), static_cast<const int32_t*>(tokens),
      static_cast<const int32_t*>(t_lens), static_cast<const int32_t*>(s_lens),
      static_cast<int32_t*>(paths), t_pad, vocab, s_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Ring slots of the resident mode at this shape; 0 when the shape takes
// the device mode.
extern "C" int viterbi_k1_resident(int t_pad, int s_pad, int vocab) {
  return resident_layout(t_pad, s_pad, vocab).slots;
}

// Shared memory one block needs in the mode the shape takes (bytes).
extern "C" size_t viterbi_k1_smem_bytes(int t_pad, int s_pad, int vocab) {
  const ResidentLayout l = resident_layout(t_pad, s_pad, vocab);
  return l.slots > 0 ? l.total : device_smem_bytes(s_pad);
}

// The strip width R and thread count a resident launch at `s_pad` takes by
// the launcher's rule (R = 0: none), for the wrapper's record.
extern "C" int viterbi_k1_strip(int s_pad, int* threads) {
  return resident_strip(round_up4(s_pad), kPreferredStrip, threads);
}

// Launchers, on `stream`, for a batch of B utterances. All pointers are
// device pointers to contiguous tensors: log_probs [B, T_pad, V] f32,
// tokens [B, S_pad] i32, t_lens/s_lens [B] i32, bp [B, T_pad, S_pad] u8
// scratch (device mode; unused by the resident mode), paths [B, T_pad] i32
// (output). `strip` is the resident mode's R (1, 2, 4 or 8), or 0 for the
// launcher's rule. The resident launcher refuses a shape whose ring and
// planes do not fit (cudaErrorInvalidValue); the device launcher takes any
// shape whose rows fit, and the wrapper sends it only the device mode's.
// Each returns cudaGetLastError() after the launch (0 = launched) and does
// not synchronise.
extern "C" int viterbi_k1_resident_launch(const void* log_probs, const void* tokens,
                                          const void* t_lens, const void* s_lens, void* bp,
                                          void* paths, int batch, int t_pad, int vocab,
                                          int s_pad, int strip, void* stream) {
  (void)bp;
  if (batch <= 0 || t_pad <= 0) return 0;
  const ResidentLayout l = resident_layout(t_pad, s_pad, vocab);
  if (l.slots == 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = 0;
  const int r = strip == 0 ? resident_strip(round_up4(s_pad), kPreferredStrip, &threads)
                           : resident_strip(round_up4(s_pad), strip, &threads);
  if (r == 0 || (strip != 0 && r != strip)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch_resident_r<1>(log_probs, tokens, t_lens, s_lens, paths, batch,
                                        t_pad, vocab, s_pad, threads, l.total, s);
    case 2: return launch_resident_r<2>(log_probs, tokens, t_lens, s_lens, paths, batch,
                                        t_pad, vocab, s_pad, threads, l.total, s);
    case 4: return launch_resident_r<4>(log_probs, tokens, t_lens, s_lens, paths, batch,
                                        t_pad, vocab, s_pad, threads, l.total, s);
    case 8: return launch_resident_r<8>(log_probs, tokens, t_lens, s_lens, paths, batch,
                                        t_pad, vocab, s_pad, threads, l.total, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int viterbi_k1_device_launch(const void* log_probs, const void* tokens,
                                        const void* t_lens, const void* s_lens, void* bp,
                                        void* paths, int batch, int t_pad, int vocab,
                                        int s_pad, void* stream) {
  if (batch <= 0 || t_pad <= 0) return 0;
  int threads = ((s_pad + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  const size_t smem = device_smem_bytes(s_pad);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_k1_device_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_k1_device_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_probs), static_cast<const int32_t*>(tokens),
      static_cast<const int32_t*>(t_lens), static_cast<const int32_t*>(s_lens),
      static_cast<uint8_t*>(bp), static_cast<int32_t*>(paths), t_pad, vocab,
      s_pad);
  return static_cast<int>(cudaGetLastError());
}

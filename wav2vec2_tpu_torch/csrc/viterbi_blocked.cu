// Blocked banded CTC Viterbi (K2, K3, K4) for Hopper (sm_90a).
//
// Replaces the three kernels that wav2vec2_tpu/ops/viterbi_pallas.py builds
// from one factory, `_make_blocked_kernel`, and mirrors it with one
// template, `viterbi_blocked_kernel<BP_IN_SMEM, RAW_GATHER, R, CLUSTER>`:
//
//   K2 <true,  false>  `_KERNEL_BP_VMEM` / `_KERNEL_BP_VMEM_BATCH`
//                      pre-gathered emissions, backpointers on chip;
//   K3 <false, false>  `_KERNEL_BP_HBM` / `_KERNEL_BP_HBM_BATCH`
//                      pre-gathered emissions, backpointers in device memory;
//   K4 <false, true>   `_KERNEL_BP_HBM_GATHER` / `_KERNEL_BP_HBM_GATHER_BATCH`
//                      raw log-probs, backpointers in device memory; one
//                      block an utterance (CLUSTER = false) up to 16 384
//                      states, a cluster of blocks (true) beyond.
//
// The DP gives K1's (csrc/viterbi.cu) paths bit for bit: strict `>` in the
// order stay, s-1, s-2, the tokens[s] != tokens[s-2] skip rule, one
// __fadd_rn(best, emit) per cell, frozen frames past t_len and the same
// final-state rule, over the same band. Build without fast-math.
//
// What bounds them on this card: each utterance is a chain of T dependent
// frames with one block barrier between frames, so the instructions a
// frame takes (the block's cells on one SM's four schedulers, about ten
// instructions a cell) and the latency of one frame's chain, not bandwidth
// or arithmetic, are the limit. K2 and K3 run one block (one SM) an
// utterance; K4 runs one up to 16 384 states and a thread-block cluster of
// up to 8 blocks on neighbouring SMs beyond that (131 072 states), each
// block a contiguous slice of the states.
//
// What the design does about it:
// - one block per utterance (grid = B), or one cluster of n blocks per
//   utterance for K4 past 16 384 states (grid = n * B, cluster (n, 1, 1));
//   a loop over 8-frame blocks inside the block replaces the TPU's
//   sequential grid;
// - the emission rows of block b+1 stream into a double-buffered [2, 8, W]
//   shared-memory window with cp.async while block b computes (16-byte
//   copies when rows and addresses allow, 4-byte ones otherwise); K4 keeps
//   raw [8, V] log-prob rows there and reads win[i][tok[s]], the
//   indexed-load counterpart of the TPU's exact one-hot MXU product (each
//   block of a cluster fills its own window: it is V wide, not W);
// - each thread owns a strip of R contiguous states (R in {4, 8, 16, 32}:
//   the least for which no block takes more than 512 strips) and keeps in
//   registers, for the whole DP, the strip's previous-frame scores, its s-2
//   penalties (0, or -inf where the skip rule forbids s-2; computed once)
//   and, for K4, its tokens as byte offsets into a window row. No DP row
//   lives in shared memory: the new row is computed in place from the old
//   registers, from the strip's top state down, in one unrolled,
//   branch-free pass;
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
// - across the blocks of a cluster (`cluster_shape`: block k takes strips
//   [k N / n, (k + 1) N / n) of the N = ceil(W / R), so every slice but
//   the last is whole strips), the DP flows only from s to s+1 and s+2, so
//   block k needs for frame t just the last two scores of block k-1 at
//   frame t-1. The thread holding them sends them with st.async into a
//   16-frame ring in block k's shared memory, the store itself completing
//   the 8 bytes that slot's mbarrier there expects; block k's thread 0
//   arms the slot's phase with its arrival and those 8 bytes, waits on it
//   (acquire) where lane 0 of warp 0 would read the halo, and after each
//   8 slots arrives back on a credit mbarrier in block k-1, which waits on
//   it before it reuses those slots. No cluster-wide barrier runs per
//   frame: the blocks run as a wavefront, block k a frame or so behind
//   block k-1, and each block's path through its strips is the one-block
//   kernel's, so the partition changes no path. (A plain remote store then
//   an arrive with release, which orders the sender's fresh backpointer
//   stores before it, took 1.32 us a frame against 1.04 for this form on 2
//   blocks of 12 032 states, 20 min of long-form; tools/k4_compare.py,
//   NVIDIA H100 80GB HBM3 at 700 W);
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
//   8 frames from shared memory;
// - on a cluster, the blocks holding states s_len-2 and s_len-1 store
//   their last scores into rank 0's shared memory, one cluster barrier
//   (release / acquire) makes those and every block's backpointer stores
//   visible to rank 0, and rank 0's warp 0 walks the global backpointers
//   across the slices (read through L2) and writes the path.
// Later work: several utterances per block.

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
constexpr int kMaxCluster = 8;    // blocks a K4 cluster takes at most (portable size)
constexpr int kRing = 16;         // frames in flight from one cluster block to the next
// [16][2] f32 boundary scores, 16 full mbarriers (one a slot), 2 credit
// mbarriers (one a half ring: slots are handed back 8 at a time)
constexpr int kClusterBytes = kRing * 2 * sizeof(float) + (kRing + 2) * sizeof(uint64_t);

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

// Shared-memory layout, in this order (the window first, 16-byte aligned):
//   window [2][8][win_ld] f32   win_ld = round_up4(S_pad) or round_up4(V)
//   halo   [2][32][2] f32       lane 31's last two scores, by frame parity
//   final  [2] f32 (16 bytes)   the last row's scores at s_len-2, s_len-1
//   bp     K2: [T_pad][W / 4] packed bytes; K3/K4: [8][16] bytes (backtrace)
//   K4 on a cluster of n > 1 blocks only:
//   ring   [16][2] f32          block k-1's last two scores, by frame % 16
//   full   [16] mbarrier        ring slot written (block k-1's st.async)
//   credit [2] mbarrier         block k+1 read the half ring this block wrote
// (A strip that runs past W reads up to 28 floats past its window row;
// they lie inside the layout and feed no cell of the band.)
template <bool BP_IN_SMEM, bool RAW_GATHER>
__host__ __device__ inline size_t smem_bytes(int t_pad, int s_pad, int vocab, int cluster) {
  const size_t w = static_cast<size_t>(round_up4(s_pad));
  const size_t win_ld = RAW_GATHER ? round_up4(vocab) : w;
  size_t bytes = 2 * kBlockFrames * win_ld * sizeof(float) + kHaloBytes + kFinalBytes;
  bytes += BP_IN_SMEM ? static_cast<size_t>(t_pad) * (w / 4)
                      : static_cast<size_t>(kBlockFrames) * kBtBytes;
  return bytes + (cluster > 1 ? kClusterBytes : 0);
}

// The launch shape for W states on a cluster of n blocks (n = 0: the
// least, ceil(W / (512 * 32)); K2 and K3 always take n = 1): the strip
// width R, the least in {4, 8, 16, 32} for which the N = ceil(W / R)
// strips spread over n blocks give none more than 512, and threads =
// round32 of the most strips a block takes. Block k takes strips
// [k N / n, (k + 1) N / n) (`slice`). Returns n, or 0 when no launch
// serves (n above 8, or fewer strips than blocks); at n = 1 this is the
// one-block rule: the least R with ceil(W / R) <= 512.
__host__ inline int cluster_shape(int w, int n, int* r, int* threads) {
  *r = 0;
  *threads = 0;
  if (n == 0) n = (w + kMaxThreads * kMaxStrip - 1) / (kMaxThreads * kMaxStrip);
  if (n == 0) n = 1;
  if (n < 0 || n > kMaxCluster) return 0;
  for (int rr = 4; rr <= kMaxStrip; rr *= 2) {
    const int strips = (w + rr - 1) / rr;
    const int most = (strips + n - 1) / n;
    if (most <= kMaxThreads) {
      if (strips < n) return 0;
      *r = rr;
      *threads = most < 32 ? 32 : ((most + 31) / 32) * 32;
      return n;
    }
  }
  return 0;
}

// States [first, end) of block `rank` of n over W states in strips of R.
__host__ __device__ inline void slice(int w, int r, int n, int rank, int* first, int* end) {
  const int strips = (w + r - 1) / r;
  *first = (rank * strips / n) * r;
  const int last = ((rank + 1) * strips / n) * r;
  *end = last < w ? last : w;
}

// --- cluster primitives (sm_90): DSMEM stores and cluster-scope mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The shared::cluster address of `local` (this block's shared address) in
// block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

// Arrive on an mbarrier of any block of the cluster, releasing this
// thread's earlier stores (local and remote) at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(remote_bar) : "memory");
}

// Wait until the phase of parity `parity` of this block's mbarrier
// completed, acquiring at cluster scope what its arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}"
      :: "r"(bar), "r"(parity) : "memory");
}

// Store two floats into another block's shared memory asynchronously; the
// store, once done, completes 8 bytes of the transaction count of that
// block's mbarrier `remote_bar`. The sending thread does not wait for its
// earlier stores to become visible, as an arrive with release would.
__device__ __forceinline__ void st_async_f32x2(uint32_t remote, float a, float b,
                                               uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
      :: "r"(remote), "f"(a), "f"(b), "r"(remote_bar) : "memory");
}

// Arrive on this block's mbarrier and add `bytes` to the transactions its
// current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void st_cluster_f32(uint32_t remote, float a) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(remote), "f"(a) : "memory");
}

// Every thread of every block of the cluster: release what it stored
// before, acquire what the others stored before theirs.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
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

// src: RAW_GATHER ? log_probs [B, T_pad, V] : emissions [B, T_pad, S_pad].
// CLUSTER (K4 only): the grid is n_cluster * B blocks in clusters of
// n_cluster, block `rank` of cluster b taking its slice of the states.
template <bool BP_IN_SMEM, bool RAW_GATHER, int R, bool CLUSTER>
__global__ void __launch_bounds__(kMaxThreads)
viterbi_blocked_kernel(const float* __restrict__ src, const int32_t* __restrict__ tokens,
                       const int32_t* __restrict__ t_lens,
                       const int32_t* __restrict__ s_lens,
                       uint8_t* __restrict__ bp_global, int32_t* __restrict__ paths,
                       int t_pad, int vocab, int s_pad, int n_cluster) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = round_up4(s_pad);
  const int n_quads = w >> 2;
  const int row_elems = RAW_GATHER ? vocab : s_pad;
  const int win_ld = round_up4(row_elems);
  float* window = reinterpret_cast<float*>(smem);
  float* halo = window + 2 * kBlockFrames * win_ld;  // [2][32][2]
  float* final_sc = halo + 2 * 32 * 2;               // [2]
  uint8_t* bp_smem = reinterpret_cast<uint8_t*>(final_sc + kFinalBytes / sizeof(float));
  // cluster only: after the [8][16] backtrace window
  float* ring = reinterpret_cast<float*>(bp_smem + kBlockFrames * kBtBytes);  // [16][2]
  const uint32_t full_bar = smem_addr(ring + 2 * kRing);      // [16] mbarriers
  const uint32_t credit_bar = full_bar + kRing * sizeof(uint64_t);  // [2] mbarriers

  // this block's states [s_first, s_end): all W, or its slice of the cluster
  int b = blockIdx.x, rank = 0, s_first = 0, s_end = w;
  if constexpr (CLUSTER) {
    rank = static_cast<int>(cluster_rank());
    b = blockIdx.x / n_cluster;
    slice(w, R, n_cluster, rank, &s_first, &s_end);
    if (threadIdx.x == 0) {
      for (int i = 0; i < kRing; ++i) mbar_init(full_bar + i * sizeof(uint64_t), 1);
      for (int i = 0; i < 2; ++i) mbar_init(credit_bar + i * sizeof(uint64_t), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_sync();  // every block's barriers initialised before any arrives
  }
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
  const int s0 = s_first + threadIdx.x * R;
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
  const int bp_n = s0 < s_end ? min(R, w - s0) >> 2 : 0;  // bytes this strip stores
  // cluster: the thread whose strip ends this block's slice hands its last
  // two scores to the next block; thread 0 of every block but the first
  // takes them from the one before
  const bool hands_on = CLUSTER && rank + 1 < n_cluster && s0 + R == s_end;
  const bool takes = CLUSTER && rank > 0 && threadIdx.x == 0;
  const uint32_t next_ring = hands_on ? map_rank(smem_addr(ring), rank + 1) : 0;
  const uint32_t next_full = hands_on ? map_rank(full_bar, rank + 1) : 0;
  const uint32_t prev_credit = takes ? map_rank(credit_bar, rank - 1) : 0;
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
        // below, or for lane 0 from the warp below's halo (for warp 0 of a
        // cluster's later block, from the block below's ring slot)
        float left1 = __shfl_up_sync(0xffffffffu, sc[R - 1], 1);
        float left2 = __shfl_up_sync(0xffffffffu, sc[R - 2], 1);
        if (lane == 0) {
          const float* h = halo + ((t - 1) & 1) * 64 + 2 * max(warp - 1, 0);
          left1 = warp > 0 ? h[1] : neg;
          left2 = warp > 0 ? h[0] : neg;
          if (takes) {
            const int slot = (t - 1) % kRing;
            mbar_arrive_expect(full_bar + slot * sizeof(uint64_t), 2 * sizeof(float));
            mbar_wait_cluster(full_bar + slot * sizeof(uint64_t), ((t - 1) / kRing) & 1);
            left2 = ring[2 * slot];
            left1 = ring[2 * slot + 1];
            if ((slot & 7) == 7) {  // read a half ring: hand its 8 slots back
              mbar_arrive_cluster(prev_credit + (slot >> 3) * sizeof(uint64_t));
            }
          }
        }
        const int band_lo = max(final_floor - 2 * (t_len - 1 - t), 0);
        const int band_hi = min(2 * t + 1, s_len - 1);
        if (s0 <= band_hi && s0 + R - 1 >= band_lo && (!CLUSTER || s0 < s_end)) {
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
      // and of the slice, for the next block of the cluster, once it has
      // read the half ring this slot lies in, 16 frames ago
      if (hands_on && t + 1 < t_run) {
        const int slot = t % kRing;
        if (t >= kRing && (slot & 7) == 0) {
          mbar_wait_cluster(credit_bar + (slot >> 3) * sizeof(uint64_t), (t / kRing - 1) & 1);
        }
        st_async_f32x2(next_ring + 2 * slot * sizeof(float), sc[R - 2], sc[R - 1],
                       next_full + slot * sizeof(uint64_t));
      }
      __syncthreads();
    }
  }

  // final-state rule on the last computed row (or the init row); on a
  // cluster the owners store into rank 0's scores, and the cluster barrier
  // also publishes every block's backpointers to rank 0
  const int idx_last = max(s_len - 1, 0);
  const int idx_prev = max(s_len - 2, 0);
  if constexpr (CLUSTER) {
    if (s0 < s_end) {
      const uint32_t at = map_rank(smem_addr(final_sc), 0);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (s0 + k == idx_prev) st_cluster_f32(at, sc[k]);
        if (s0 + k == idx_last) st_cluster_f32(at + sizeof(float), sc[k]);
      }
    }
    cluster_sync();
    if (rank != 0) return;
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (s0 + k == idx_prev) final_sc[0] = sc[k];
      if (s0 + k == idx_last) final_sc[1] = sc[k];
    }
    __syncthreads();
  }
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
  // max(s - 14, 0) (on a cluster read through L2: other SMs wrote them)
  uint8_t* bt = bp_smem;  // [8][16]
  int s = final_s;
  for (int hi = t_end - 1; hi >= 0; hi -= kBlockFrames) {
    const int lo = max(hi - (kBlockFrames - 1), 0);
    const int c0 = (max(s - 14, 0) / R) * (R / 4);
    for (int k = lane; k < kBlockFrames * kBtBytes; k += 32) {
      const int r = k / kBtBytes;
      const int col = c0 + (k - r * kBtBytes);
      const int t = hi - r;
      const uint8_t* at = bp_b + static_cast<size_t>(t) * n_quads + col;
      bt[k] = (t >= lo && t >= 1 && col < n_quads) ? (CLUSTER ? __ldcg(at) : *at) : 0;
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

template <bool BP_IN_SMEM, bool RAW_GATHER, int R, bool CLUSTER>
int launch_r(const void* src, const void* tokens, const void* t_lens,
             const void* s_lens, void* bp, void* paths, int batch, int t_pad,
             int vocab, int s_pad, int n, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = viterbi_blocked_kernel<BP_IN_SMEM, RAW_GATHER, R, CLUSTER>;
  static size_t opted_in = 48 * 1024;  // per instantiation: raised once per new size
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const float* src_f = static_cast<const float*>(src);
  const int32_t* tok = static_cast<const int32_t*>(tokens);
  const int32_t* tl = static_cast<const int32_t*>(t_lens);
  const int32_t* sl = static_cast<const int32_t*>(s_lens);
  uint8_t* bp8 = static_cast<uint8_t*>(bp);
  int32_t* out = static_cast<int32_t*>(paths);
  if constexpr (!CLUSTER) {
    kernel<<<batch, threads, smem, stream>>>(src_f, tok, tl, sl, bp8, out, t_pad, vocab,
                                             s_pad, 1);
    return static_cast<int>(cudaGetLastError());
  } else {
    // n blocks a cluster, one cluster an utterance; a cluster the card
    // cannot place is refused here, and the caller raises
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(n) * static_cast<unsigned>(batch));
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&config, kernel, src_f, tok, tl, sl, bp8, out,
                                               t_pad, vocab, s_pad, n);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the wrapper reports this launch's error
      return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
  }
}

// K2, K3 and K4 on one block an utterance, or K4 (RAW_GATHER, bp in
// device memory) on a cluster of `cluster` blocks (0: the least that holds
// S_pad, `cluster_shape`; 1 is the one-block launch).
template <bool BP_IN_SMEM, bool RAW_GATHER>
int launch(const void* src, const void* tokens, const void* t_lens,
           const void* s_lens, void* bp, void* paths, int batch, int t_pad,
           int vocab, int s_pad, int cluster, void* stream) {
  if (batch <= 0 || t_pad <= 0) return 0;
  int r = 0, threads = 0;
  const int n = cluster_shape(round_up4(s_pad), cluster, &r, &threads);
  if (n == 0 || (n > 1 && (BP_IN_SMEM || !RAW_GATHER))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<BP_IN_SMEM, RAW_GATHER>(t_pad, s_pad, vocab, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kCluster = RAW_GATHER && !BP_IN_SMEM;  // K4 only
#define VITERBI_STRIP(RR)                                                                 \
  case RR:                                                                                \
    return n > 1 ? launch_r<BP_IN_SMEM, RAW_GATHER, RR, kCluster>(                        \
                       src, tokens, t_lens, s_lens, bp, paths, batch, t_pad, vocab, s_pad, \
                       n, threads, smem, s)                                               \
                 : launch_r<BP_IN_SMEM, RAW_GATHER, RR, false>(                           \
                       src, tokens, t_lens, s_lens, bp, paths, batch, t_pad, vocab, s_pad, \
                       1, threads, smem, s);
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

// Shared memory one block needs (bytes), for the wrapper's size check;
// K4's at the least cluster that holds S_pad.
extern "C" size_t viterbi_k2_smem_bytes(int t_pad, int s_pad, int vocab) {
  return smem_bytes<true, false>(t_pad, s_pad, vocab, 1);
}
extern "C" size_t viterbi_k3_smem_bytes(int t_pad, int s_pad, int vocab) {
  return smem_bytes<false, false>(t_pad, s_pad, vocab, 1);
}
extern "C" size_t viterbi_k4_smem_bytes(int t_pad, int s_pad, int vocab) {
  int r = 0, threads = 0;
  const int n = cluster_shape(round_up4(s_pad), 0, &r, &threads);
  return smem_bytes<false, true>(t_pad, s_pad, vocab, n);
}

// The strip width R and the thread count a one-block launch at `s_pad`
// uses (R = 0: no strip serves it), for the wrapper's record.
extern "C" int viterbi_blocked_strip(int s_pad, int* threads) {
  int r = 0;
  cluster_shape(round_up4(s_pad), 1, &r, threads);
  return r;
}

// K4's cluster at `s_pad`: returns the block count n of a launch asked for
// `cluster` blocks (0: the least that holds S_pad), or 0 if no launch
// serves; sets R, the thread count, and block `rank`'s states [first, end).
extern "C" int viterbi_k4_cluster(int s_pad, int cluster, int rank, int* r, int* threads,
                                  int* first, int* end) {
  const int w = round_up4(s_pad);
  const int n = cluster_shape(w, cluster, r, threads);
  *first = *end = 0;
  if (n > 0 && rank >= 0 && rank < n) slice(w, *r, n, rank, first, end);
  return n;
}

// Launchers, on `stream`, for a batch of B utterances. All pointers are
// device pointers to contiguous tensors: src = emissions [B, T_pad, S_pad]
// f32 (K2, K3) or log_probs [B, T_pad, V] f32 (K4); tokens [B, S_pad] i32;
// t_lens/s_lens [B] i32; bp = [B, T_pad, ceil(S_pad / 4)] u8 scratch, 2
// bits a cell (K3, K4; unused by K2); paths [B, T_pad] i32 (output).
// `vocab` is read by K4 only, as is `cluster` (0: the least cluster that
// holds S_pad; n > 0: n blocks an utterance). Each returns the launch's
// error (0 = launched; a cluster the card cannot place is an error) and
// does not synchronise.
extern "C" int viterbi_k2_launch(const void* emit, const void* tokens,
                                 const void* t_lens, const void* s_lens, void* bp,
                                 void* paths, int batch, int t_pad, int vocab,
                                 int s_pad, void* stream) {
  return launch<true, false>(emit, tokens, t_lens, s_lens, bp, paths, batch, t_pad,
                             vocab, s_pad, 1, stream);
}
extern "C" int viterbi_k3_launch(const void* emit, const void* tokens,
                                 const void* t_lens, const void* s_lens, void* bp,
                                 void* paths, int batch, int t_pad, int vocab,
                                 int s_pad, void* stream) {
  return launch<false, false>(emit, tokens, t_lens, s_lens, bp, paths, batch, t_pad,
                              vocab, s_pad, 1, stream);
}
extern "C" int viterbi_k4_launch(const void* log_probs, const void* tokens,
                                 const void* t_lens, const void* s_lens, void* bp,
                                 void* paths, int batch, int t_pad, int vocab,
                                 int s_pad, int cluster, void* stream) {
  return launch<false, true>(log_probs, tokens, t_lens, s_lens, bp, paths, batch,
                             t_pad, vocab, s_pad, cluster, stream);
}

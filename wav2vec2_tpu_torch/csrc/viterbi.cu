// Banded CTC Viterbi with in-kernel backtrace (K1) for Hopper (sm_90a).
//
// Replaces wav2vec2_tpu/ops/viterbi_pallas.py::_viterbi_kernel_resident,
// the TPU kernel that `viterbi_pallas_single` launches and
// `viterbi_pallas_batch` vmaps at the serving shape. It computes the same
// DP as wav2vec2_tpu/ops/viterbi_ref.py (band, strict `>` tie order
// stay > s-1 > s-2, the tokens[s] != tokens[s-2] skip rule, frozen frames
// past t_len, the final-state rule) for a whole padded batch, and writes
// only the int32 state path of each utterance.
//
// What bounds it on this card: each utterance is a sequential chain of T
// frames, and frame t needs all of frame t-1, so a block barrier separates
// every two frames. The parallelism is B blocks x S states; per frame a
// block reads S*4 bytes of emissions (scattered by token id inside one
// [V] row of log-probs, which stays in L1/L2) and writes S bytes of
// backpointers. Neither bandwidth nor arithmetic is near the card's limit:
// latency per frame (barrier + one dependent global load) is.
//
// What the design does about that, kept simple in this first version:
// - one block per utterance (grid = B), threads striding over the states;
// - the previous and current DP rows ping-pong in shared memory, so the
//   only global traffic inside the frame loop is the emission load and the
//   backpointer store;
// - the tokens are staged in shared memory once, and emissions are read
//   straight from log_probs[b, t, tokens[s]]: no [T, S] emission array
//   exists anywhere;
// - backpointers are uint8 in device memory ([B, T_pad, S_pad], allocated
//   by the caller); the final-state rule and the backtrace run on one
//   thread at the end.
// Later work: backpointers in shared memory where T_pad*S_pad fits, warp
// shuffles for the s-1/s-2 shifts, and several utterances per block.
//
// Bit-identity: every cell is one IEEE f32 add best + emit (__fadd_rn, so
// no contraction), -inf + x stays -inf, and comparisons are strict. Build
// without fast-math.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__global__ void viterbi_k1_kernel(const float* __restrict__ log_probs,
                                  const int32_t* __restrict__ tokens,
                                  const int32_t* __restrict__ t_lens,
                                  const int32_t* __restrict__ s_lens,
                                  uint8_t* __restrict__ bp,
                                  int32_t* __restrict__ paths,
                                  int t_pad, int vocab, int s_pad) {
  extern __shared__ float smem[];
  float* row_a = smem;
  float* row_b = smem + s_pad;
  int32_t* tok = reinterpret_cast<int32_t*>(smem + 2 * s_pad);

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

}  // namespace

// Shared memory the kernel needs for one utterance of s_pad states.
extern "C" size_t viterbi_k1_smem_bytes(int s_pad) {
  return static_cast<size_t>(s_pad) * (2 * sizeof(float) + sizeof(int32_t));
}

// Launches K1 on `stream` for a batch of B utterances. All pointers are
// device pointers to contiguous tensors: log_probs [B, T_pad, V] f32,
// tokens [B, S_pad] i32, t_lens/s_lens [B] i32, bp [B, T_pad, S_pad] u8
// (scratch), paths [B, T_pad] i32 (output). Returns cudaGetLastError()
// after the launch (0 = launched); does not synchronise.
extern "C" int viterbi_k1_launch(const void* log_probs, const void* tokens,
                                 const void* t_lens, const void* s_lens,
                                 void* bp, void* paths, int batch, int t_pad,
                                 int vocab, int s_pad, void* stream) {
  if (batch <= 0 || t_pad <= 0) return 0;
  int threads = ((s_pad + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  const size_t smem = viterbi_k1_smem_bytes(s_pad);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_k1_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_probs), static_cast<const int32_t*>(tokens),
      static_cast<const int32_t*>(t_lens), static_cast<const int32_t*>(s_lens),
      static_cast<uint8_t*>(bp), static_cast<int32_t*>(paths), t_pad, vocab,
      s_pad);
  return static_cast<int>(cudaGetLastError());
}

// Audio normalization (K7) for Hopper (sm_90a): each row of a batch
// normalized to zero mean and unit variance and laid out padded, from the
// raw samples of its rows packed back to back.
//
// Replaces no TPU kernel. The JAX package normalizes each utterance on the
// host (wav2vec2_tpu/pipeline/runtime.py: normalize_audio, numpy in f64)
// and pads the batch there; the port did the same, and on the H100 that
// host work and the synchronous upload of the padded buffer held the card
// idle. Here the host only packs the raw f32 samples into pinned memory
// (ops/normalize.py: pack_rows) and uploads them without a sync; this
// kernel computes the statistics on the card and writes the [rows, n_pad]
// f32 audio the forward takes.
//
// What it computes is normalize_audio's arithmetic, operation for
// operation in f64: mean = (sum of x) / n; d = x - mean; var = (sum of d*d)
// / n, the centred two-pass form; std = max(sqrt(var), 1e-7); out =
// (float)(d / std), a correctly rounded f64 division rounded to f32 once.
// Every multiply, add, subtract, divide and square root is the IEEE
// operation (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn, __dsqrt_rn: nvcc
// never contracts them into an FMA). Only the order of the two sums
// differs from numpy's pairwise summation, so an element differs from
// normalize_audio's by at most 1 f32 ulp, and only where the f64 value lies
// next to an f32 rounding boundary (or, near 0, where x - mean cancels).
// For int16-valued audio of up to 2^19 samples a row the sum is exact in
// any order, and so are the mean and every d.
//
// Layout. packed holds the rows' samples; row r's len[r] samples start at
// offsets[r] (the packer puts each at a multiple of 4 samples, so that a
// row reads as 16-byte vectors; a row elsewhere reads sample by sample).
// out is [rows, n_pad] f32: row r's normalized samples, then zeros to
// n_pad. Rows that fill a batch to its size point at their source row
// (its offset and length), so they come out bit for bit its copy: the
// same arithmetic in the same order.
//
// Design. One thread-block cluster of C blocks a row (C = 1, 2, 4 or 8 by
// the row's padded length, so that 32 rows of 32 s give 256 blocks over
// 132 SMs): block k of the cluster takes the k-th slice of the row's
// 16-byte vectors. Three walks over the slice: the f64 sum, the f64 sum of
// the centred squares, then the output. Each block's partial sum goes to
// its own shared memory; after a cluster barrier every thread reads the C
// partials through distributed shared memory (DSMEM) in rank order, so
// every block holds the same total without a trip through device memory
// or a second launch. The first walk reads the row from device memory; the
// second and third find it in L2 (a row is at most 2 MB at 32 s). Loads
// and stores are 16-byte vectors (4 samples), the row's last partial
// vector sample by sample.
//
// Bound: bytes, the packed samples read once and the padded f32 written
// once, over 3.35 TB/s. The per-element f64 divide (a Newton sequence of
// about 20 f64 instructions on a card with 64 f64 units an SM) comes close
// behind it.
//
// The launcher takes device pointers and PyTorch's stream, returns
// cudaGetLastError() after the launch (0 = launched) or the error that kept
// it from launching, and does not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kVecsPerThread = 4;   // a cluster grows until a block's slice fits this
constexpr double kStdFloor = 1e-7;  // normalize_audio's σ floor

// The f64 sum of v over the block, in an order fixed by the block's shape;
// valid on thread 0.
__device__ __forceinline__ double block_sum(double v, double* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, part[w]);
  }
  return s;
}

// The cluster's total of the blocks' `slot`s, read in rank order through
// DSMEM: the same value on every thread of every block. Each block's
// thread 0 has written its slot before the barrier.
__device__ __forceinline__ double cluster_total(cg::cluster_group& cluster, double* slot) {
  cluster.sync();
  double s = 0.0;
  const unsigned n = cluster.num_blocks();
  for (unsigned r = 0; r < n; ++r) s = __dadd_rn(s, *cluster.map_shared_rank(slot, r));
  return s;
}

// Samples 4v .. 4v+3 of a row of `len` at x, 0 past len; one 16-byte load
// where x is 16-byte aligned and all four are in the row.
__device__ __forceinline__ float4 load4(const float* x, int v, int len, bool vec) {
  const int i = 4 * v;
  if (vec && i + 4 <= len) return __ldg(reinterpret_cast<const float4*>(x) + v);
  float4 q;
  q.x = i < len ? x[i] : 0.0f;
  q.y = i + 1 < len ? x[i + 1] : 0.0f;
  q.z = i + 2 < len ? x[i + 2] : 0.0f;
  q.w = i + 3 < len ? x[i + 3] : 0.0f;
  return q;
}

__device__ __forceinline__ double centred_square(float x, double mean) {
  const double d = __dsub_rn(static_cast<double>(x), mean);
  return __dmul_rn(d, d);
}

__device__ __forceinline__ float scaled(float x, double mean, double std) {
  return __double2float_rn(__ddiv_rn(__dsub_rn(static_cast<double>(x), mean), std));
}

template <bool VEC_OUT>
__global__ void __launch_bounds__(kThreads)
    normalize_rows_kernel(const float* __restrict__ packed,
                          const long long* __restrict__ offsets, const int* __restrict__ lens,
                          float* __restrict__ out, int n_pad, int vecs_per_block) {
  __shared__ double part[kWarps];
  __shared__ double slot[2];  // this block's partial sum, then its sum of squares
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.x / c;
  const int rank = static_cast<int>(cluster.block_rank());
  const int len = max(0, min(lens[row], n_pad));
  const float* x = packed + offsets[row];
  float* y = out + static_cast<long long>(row) * n_pad;
  const bool vec_in = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int n_vec = (n_pad + 3) / 4;
  const int v0 = min(n_vec, rank * vecs_per_block);
  const int v1 = min(n_vec, v0 + vecs_per_block);
  const int real_end = min(v1, (len + 3) / 4);  // vectors holding samples
  const double count = static_cast<double>(max(len, 1));

  // walk 1: the sum (samples past len read as 0 and add nothing)
  double s = 0.0;
#pragma unroll 4
  for (int v = v0 + threadIdx.x; v < real_end; v += kThreads) {
    const float4 q = load4(x, v, len, vec_in);
    s = __dadd_rn(s, static_cast<double>(q.x));
    s = __dadd_rn(s, static_cast<double>(q.y));
    s = __dadd_rn(s, static_cast<double>(q.z));
    s = __dadd_rn(s, static_cast<double>(q.w));
  }
  s = block_sum(s, part);
  if (threadIdx.x == 0) slot[0] = s;
  const double mean = __ddiv_rn(cluster_total(cluster, &slot[0]), count);

  // walk 2: the centred squares of the samples alone
  double sq = 0.0;
#pragma unroll 4
  for (int v = v0 + threadIdx.x; v < real_end; v += kThreads) {
    const float4 q = load4(x, v, len, vec_in);
    const int i = 4 * v;
    sq = __dadd_rn(sq, centred_square(q.x, mean));
    if (i + 1 < len) sq = __dadd_rn(sq, centred_square(q.y, mean));
    if (i + 2 < len) sq = __dadd_rn(sq, centred_square(q.z, mean));
    if (i + 3 < len) sq = __dadd_rn(sq, centred_square(q.w, mean));
  }
  sq = block_sum(sq, part);  // `part` is free: the cluster barrier followed walk 1's reads
  if (threadIdx.x == 0) slot[1] = sq;
  const double var = __ddiv_rn(cluster_total(cluster, &slot[1]), count);
  const double std = fmax(__dsqrt_rn(var), kStdFloor);

  // walk 3: the padded output
#pragma unroll 4
  for (int v = v0 + threadIdx.x; v < v1; v += kThreads) {
    const int i = 4 * v;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < len) {
      const float4 q = load4(x, v, len, vec_in);
      o.x = scaled(q.x, mean, std);
      if (i + 1 < len) o.y = scaled(q.y, mean, std);
      if (i + 2 < len) o.z = scaled(q.z, mean, std);
      if (i + 3 < len) o.w = scaled(q.w, mean, std);
    }
    if (VEC_OUT) {
      reinterpret_cast<float4*>(y)[v] = o;
    } else {
      y[i] = o.x;
      if (i + 1 < n_pad) y[i + 1] = o.y;
      if (i + 2 < n_pad) y[i + 2] = o.z;
      if (i + 3 < n_pad) y[i + 3] = o.w;
    }
  }
  // no block leaves while another may still read its slots
  cluster.sync();
}

// Blocks a row's cluster takes: the least power of 2 up to kMaxCluster
// whose slices hold at most kVecsPerThread vectors a thread.
int cluster_blocks(int n_pad) {
  const long long n_vec = (static_cast<long long>(n_pad) + 3) / 4;
  int c = 1;
  while (c < kMaxCluster && n_vec > static_cast<long long>(c) * kThreads * kVecsPerThread) c *= 2;
  return c;
}

template <bool VEC_OUT>
int launch(const float* packed, const long long* offsets, const int* lens, float* out, int rows,
           int n_pad, cudaStream_t stream) {
  const int c = cluster_blocks(n_pad);
  const int n_vec = (n_pad + 3) / 4;
  const int per_block = (n_vec + c - 1) / c;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows) * static_cast<unsigned>(c));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, normalize_rows_kernel<VEC_OUT>, packed,
                                             offsets, lens, out, n_pad, per_block);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper reports this launch's error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The blocks of one row's cluster at this padded length (for the wrapper's
// and the smoke's records).
extern "C" int normalize_cluster_blocks(int n_pad) { return cluster_blocks(n_pad); }

// packed: f32 samples; offsets [rows] int64, lens [rows] int32 (clamped to
// [0, n_pad]); out [rows, n_pad] f32.
extern "C" int normalize_rows_launch(const float* packed, const long long* offsets,
                                     const int* lens, float* out, int rows, int n_pad,
                                     void* stream) {
  if (rows <= 0 || n_pad <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every row of out starts 16-byte aligned when n_pad is a multiple of 4
  return (n_pad % 4 == 0) ? launch<true>(packed, offsets, lens, out, rows, n_pad, s)
                          : launch<false>(packed, offsets, lens, out, rows, n_pad, s);
}

// Norm + GELU (K6) for Hopper (sm_90a): the bf16 and f16 forward's
// normalization and erf-GELU chains of wav2vec2_tpu_torch/models/layers.py,
// each in one pass over device memory.
//
// Replaces no TPU kernel. The JAX package writes these chains as plain jnp
// (wav2vec2_tpu/models/layers.py: gelu, group_norm_1d, layer_norm_channels)
// and XLA fused them on the TPU. Run eagerly, PyTorch makes a pass over
// device memory of every operation: the A&S GELU of one bf16 element is 26
// f32 kernels, about 230 bytes of traffic, and the norm before it 50-90
// bytes more. K6 reads each element once and writes it once (4 bytes a
// bf16 element; 6 in the group mode), keeping every
// intermediate in registers or shared memory. Its bound is those bytes
// over 3.35 TB/s; the GELU's ~50 f32 instructions an element come close
// behind it.
//
// Three modes, each its own kernel:
// - gelu: y = gelu(x) over a contiguous tensor of n elements: grid-stride,
//   16-byte vectors (8 elements) where x and y are 16-byte aligned.
// - group: GroupNorm with groups = channels over the valid frames of each
//   (b, c) row of a contiguous x [B, C, T] (the frame count lens[b],
//   clamped to [0, T]; all T where lens is null), then GELU; one block a
//   row. Statistics: the masked f32 sum and sum of squares, one pass,
//   var = max(E[x²] − E[x]², 0), as group_norm_1d. Then ((x − mean)·m·rstd·w
//   + b)·m in that order (m = 1 on a valid frame, 0 past it: padded frames
//   come out 0), rounded as group_norm_1d's output is, then GELU. The row
//   is read twice from device memory, the second time mostly from L2: 6
//   bytes an element at most, for any T.
// - channel: LayerNorm over the C channels of each frame of a contiguous
//   x [B, C, T], then GELU, for 1 <= C <= 1024 (every conv-frontend config
//   has C = 512). A block takes a [C, 32-frame] slab: warp w loads
//   channels w, w+8, ... of 32 consecutive frames (one coalesced 64-byte
//   row a load), keeps them in shared memory, and the statistics (f32 mean,
//   then the centred variance, as var_mean(correction=0)) come from there;
//   (x − mean)·rstd·w + b is rounded as layer_norm_channels' output is,
//   then GELU.
//
// The GELU (`gelu_as`) is layers.gelu_as operation for operation in f32:
// each multiply and add is one IEEE operation (__fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA although it builds with -fmad=true),
// 1/d correctly rounded (__frcp_rn, the value of ATen's IEEE 1 / d), the
// accurate expf (not __expf), copysignf, and the
// constants the f32 roundings of layers.py's Python floats, as ATen rounds
// a scalar for an f32 tensor. ATen runs each step of the chain as a kernel
// built from the same operations, so K6's GELU equals the chain's bit for
// bit (tests/test_torch_port_norm_gelu.py checks all 65 536 bf16 inputs on
// the card). The norms sum in another order than ATen's reductions, so
// their outputs agree with layers.py's to 1 bf16 ulp.
//
// Launchers take device pointers to contiguous tensors and PyTorch's
// stream, return cudaGetLastError() after the launch (0 = launched) or the
// error that kept it from launching, and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// layers.py's constants rounded to f32 (np.float32 of the Python float)
constexpr float kInvSqrt2 = 0x1.6a09e6p-1f;  // 0.7071067811865476
constexpr float kP = 0x1.4f740ap-2f;         // 0.3275911
constexpr float kA0 = 0x1.04f20cp-2f;        // 0.254829592
constexpr float kA1 = -0x1.23531cp-2f;       // -0.284496736
constexpr float kA2 = 0x1.6be1c6p+0f;        // 1.421413741
constexpr float kA3 = -0x1.7401c6p+0f;       // -1.453152027
constexpr float kA4 = 0x1.0fb844p+0f;        // 1.061405429

constexpr int kGeluThreads = 256;
constexpr int kGeluMaxBlocks = 4096;
constexpr int kGroupThreads = 512;
constexpr int kChanFrames = 32;  // frames a channel block: one warp's lanes
constexpr int kChanThreads = 256;
constexpr int kChanWarps = kChanThreads / 32;
constexpr int kMaxChannels = 1024;

// bf16 / f16 to and from f32, rounding to nearest even
template <typename T>
struct Io;
template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 to(float v) { return __float2bfloat16_rn(v); }
};
template <>
struct Io<__half> {
  static __device__ __forceinline__ float f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half to(float v) { return __float2half_rn(v); }
};

// layers.gelu_as in f32: za = |x|·(1/√2); u = 1/(za·p + 1); P(u) by
// Horner; erf = copysign(1 − P·exp(−za²), x); 0.5·x·(erf + 1)
__device__ __forceinline__ float gelu_as(float x) {
  const float za = __fmul_rn(fabsf(x), kInvSqrt2);
  const float u = __frcp_rn(__fadd_rn(__fmul_rn(za, kP), 1.0f));
  float poly = __fmul_rn(u, kA4);
  poly = __fmul_rn(__fadd_rn(poly, kA3), u);
  poly = __fmul_rn(__fadd_rn(poly, kA2), u);
  poly = __fmul_rn(__fadd_rn(poly, kA1), u);
  poly = __fmul_rn(__fadd_rn(poly, kA0), u);
  const float e = expf(-__fmul_rn(za, za));
  const float erf = copysignf(__fadd_rn(-__fmul_rn(poly, e), 1.0f), x);
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(erf, 1.0f));
}

template <typename T>
__device__ __forceinline__ T gelu_t(T v) {
  return Io<T>::to(gelu_as(Io<T>::f(v)));
}

// A row of n elements at x split into a scalar head up to x's next 16-byte
// boundary, 16-byte vectors of 8, and a scalar tail; no vectors where the
// row's destination y lies at another offset within 16 bytes.
struct Split {
  int head;
  int nvec;
};

__device__ __forceinline__ Split split_row(const void* x, const void* y, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  if (((a ^ reinterpret_cast<uintptr_t>(y)) & 15) != 0) return {n, 0};
  const int head = min(n, static_cast<int>(((16 - (a & 15)) & 15) >> 1));
  return {head, (n - head) >> 3};
}

// f(i, v) -> T on every element i of a row of n elements read from src
// (split as `sp`), the results written to dst unless it is null; the
// block's threads share the work
template <typename T, typename F>
__device__ __forceinline__ void walk_row(const T* src, T* dst, Split sp, int n, F f) {
  for (int i = threadIdx.x; i < sp.head; i += blockDim.x) {
    const T r = f(i, src[i]);
    if (dst != nullptr) dst[i] = r;
  }
#pragma unroll 4
  for (int k = threadIdx.x; k < sp.nvec; k += blockDim.x) {
    const int i0 = sp.head + 8 * k;
    uint4 v = *reinterpret_cast<const uint4*>(src + i0);
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = f(i0 + j, e[j]);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + i0) = v;
  }
  for (int i = sp.head + 8 * sp.nvec + threadIdx.x; i < n; i += blockDim.x) {
    const T r = f(i, src[i]);
    if (dst != nullptr) dst[i] = r;
  }
}

// (a, b) summed over the block, the same on every thread; the order is
// fixed by the block's shape, so a row's statistics do not vary by run
template <int THREADS>
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = part[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) s = make_float2(s.x + part[w].x, s.y + part[w].y);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kGeluThreads)
    gelu_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0) {
    const long long nvec = n >> 3;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long k = first; k < nvec; k += stride) {
      uint4 v = xv[k];
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = gelu_t(e[j]);
      yv[k] = v;
    }
    done = nvec << 3;
  }
  for (long long i = done + first; i < n; i += stride) y[i] = gelu_t(x[i]);
}

template <typename T>
__global__ void __launch_bounds__(kGroupThreads)
    group_norm_gelu_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                           const float* __restrict__ bias, const long long* __restrict__ lens,
                           T* __restrict__ y, int channels, int t_len, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * t_len;
  T* yr = y + row * t_len;
  int valid = t_len;
  if (lens != nullptr) {
    const long long l = lens[row / channels];
    valid = l < 0 ? 0 : (l > t_len ? t_len : static_cast<int>(l));
  }
  const Split sp = split_row(xr, yr, t_len);
  float s = 0.0f, s2 = 0.0f;
  walk_row<T>(xr, nullptr, sp, t_len, [&](int i, T v) {
    if (i < valid) {
      const float f = Io<T>::f(v);
      s += f;
      s2 = fmaf(f, f, s2);
    }
    return v;
  });
  const float2 tot = block_sum2<kGroupThreads>(s, s2);
  const float count = static_cast<float>(max(valid, 1));
  const float mean = __fdiv_rn(tot.x, count);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(tot.y, count), __fmul_rn(mean, mean)), 0.0f);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  const float w = weight[row % channels], b = bias[row % channels];
  walk_row<T>(xr, yr, sp, t_len, [&](int i, T v) {
    const float m = i < valid ? 1.0f : 0.0f;
    float o = __fmul_rn(__fsub_rn(Io<T>::f(v), mean), m);
    o = __fadd_rn(__fmul_rn(__fmul_rn(o, rstd), w), b);
    return gelu_t(Io<T>::to(__fmul_rn(o, m)));
  });
}

template <typename T>
__global__ void __launch_bounds__(kChanThreads)
    channel_norm_gelu_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                             const float* __restrict__ bias, T* __restrict__ y, int channels,
                             int t_len, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);  // [channels][kChanFrames]
  __shared__ float part[kChanWarps][kChanFrames];
  const int tiles = (t_len + kChanFrames - 1) / kChanFrames;
  const long long bi = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = (blockIdx.x % tiles) * kChanFrames + lane;
  const bool live = t < t_len;
  const long long at = bi * channels * static_cast<long long>(t_len) + t;
  // each thread reads, keeps and writes the same (c, t) cells: c ≡ warp (mod 8)
  float sum = 0.0f;
#pragma unroll 8
  for (int c = warp; c < channels; c += kChanWarps) {
    const T v = live ? x[at + static_cast<long long>(c) * t_len] : Io<T>::to(0.0f);
    slab[c * kChanFrames + lane] = v;
    sum += Io<T>::f(v);
  }
  part[warp][lane] = sum;
  __syncthreads();
  sum = 0.0f;
#pragma unroll
  for (int w = 0; w < kChanWarps; ++w) sum += part[w][lane];
  const float mean = __fdiv_rn(sum, static_cast<float>(channels));
  __syncthreads();  // every thread has read `part`
  float sq = 0.0f;
  for (int c = warp; c < channels; c += kChanWarps) {
    const float d = __fsub_rn(Io<T>::f(slab[c * kChanFrames + lane]), mean);
    sq = fmaf(d, d, sq);
  }
  part[warp][lane] = sq;
  __syncthreads();
  sq = 0.0f;
#pragma unroll
  for (int w = 0; w < kChanWarps; ++w) sq += part[w][lane];
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(sq, static_cast<float>(channels)), eps));
  if (!live) return;
  for (int c = warp; c < channels; c += kChanWarps) {
    float o = __fmul_rn(__fsub_rn(Io<T>::f(slab[c * kChanFrames + lane]), mean), rstd);
    o = __fadd_rn(__fmul_rn(o, weight[c]), bias[c]);
    y[at + static_cast<long long>(c) * t_len] = gelu_t(Io<T>::to(o));
  }
}

template <typename T>
int gelu_launch(const void* x, void* y, long long n, cudaStream_t stream) {
  const long long units = (n + 7) / 8;
  const long long blocks = (units + kGeluThreads - 1) / kGeluThreads;
  gelu_kernel<T><<<static_cast<int>(blocks < kGeluMaxBlocks ? blocks : kGeluMaxBlocks),
                   kGeluThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int group_launch(const void* x, const float* w, const float* b, const long long* lens, void* y,
                 long long rows, int channels, int t_len, float eps, cudaStream_t stream) {
  group_norm_gelu_kernel<T><<<static_cast<unsigned>(rows), kGroupThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, lens, static_cast<T*>(y), channels, t_len, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int channel_launch(const void* x, const float* w, const float* b, void* y, int batch,
                   int channels, int t_len, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(channels) * kChanFrames * sizeof(T);
  const cudaError_t attr =
      cudaFuncSetAttribute(channel_norm_gelu_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks =
      static_cast<long long>(batch) * ((t_len + kChanFrames - 1) / kChanFrames);
  channel_norm_gelu_kernel<T><<<static_cast<unsigned>(blocks), kChanThreads, smem, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), channels, t_len, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem_bytes 2 with half != 0 is f16, with half == 0 bf16. x and y hold n
// elements.
extern "C" int norm_gelu_gelu_launch(const void* x, void* y, long long n, int half,
                                     void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return half ? gelu_launch<__half>(x, y, n, s) : gelu_launch<__nv_bfloat16>(x, y, n, s);
}

// x, y [B, C, T]; weight, bias [C] f32; lens [B] int64 frame counts, or
// null for all T
extern "C" int norm_gelu_group_launch(const void* x, const float* weight, const float* bias,
                                      const long long* lens, void* y, int batch, int channels,
                                      int t_len, float eps, int half, void* stream) {
  if (batch <= 0 || channels <= 0 || t_len <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(batch) * channels;
  return half ? group_launch<__half>(x, weight, bias, lens, y, rows, channels, t_len, eps, s)
              : group_launch<__nv_bfloat16>(x, weight, bias, lens, y, rows, channels, t_len,
                                            eps, s);
}

// x, y [B, C, T] with 1 <= C <= kMaxChannels; weight, bias [C] f32
extern "C" int norm_gelu_channel_launch(const void* x, const float* weight, const float* bias,
                                        void* y, int batch, int channels, int t_len, float eps,
                                        int half, void* stream) {
  if (batch <= 0 || channels <= 0 || t_len <= 0) return 0;
  if (channels > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return half ? channel_launch<__half>(x, weight, bias, y, batch, channels, t_len, eps, s)
              : channel_launch<__nv_bfloat16>(x, weight, bias, y, batch, channels, t_len, eps, s);
}

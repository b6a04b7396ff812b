// Single-token GQA decode attention against one layer of a stacked KV cache,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _decode_kernel (K3) of
// lmms_owc_tpu/ops/attention.py, reached through gqa_decode_attention: the
// query heads of one KV group attend to layer `layer` of the stacked
// [L, B, KVH, S, D] cache under a [B, S] validity mask (bf16 or f32 cache; the
// int8-cache variant of the TPU kernel is not ported yet).
//
// What bounds it on the H100: memory bytes. Each (row, KV head) reads its S x D
// slice of K and V once and does ~4*G flops per element read (G = H / KVH = 7
// at Qwen2-VL-7B), far below the card's ~295 flop/byte balance point.
//
// What this first design does about it: one CTA per (batch row, KV head)
// computes all G query heads of the group, so every K and V element is read
// from device memory exactly once per step, in 16-byte vectors. At decode
// batch sizes that is few CTAs (32 at B=8), so the kernel is bound by load
// latency long before it reaches the card's bandwidth; it keeps many
// independent loads in flight instead: each thread owns whole key rows for
// the scores (no cross-lane reductions), and for PV each thread owns one
// 16-byte column chunk of a strided set of value rows. The layer is a pointer
// offset into the stacked cache: nothing is sliced or copied. Left for later
// work: split-K (flash-decoding) across CTAs, so a small batch fills more
// than B*KVH SMs. `layer` arrives as a host int; capturing the decode step in
// a CUDA graph will need it as a device scalar instead.
//
// Numerics follow the TPU kernel and gqa_attention_reference: f32 scores scaled
// in f32, masked keys set to -1e30, max, exp, sum, normalise in f32, round the
// weights to the cache type, then PV with f32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrors DecodeArgs in lmms_owc_tpu_torch/ops/_build.py (ctypes.Structure).
struct DecodeArgs {
  const void* q;        // [B, H, D] contiguous
  const void* k_cache;  // [L, B, KVH, S, D] contiguous
  const void* v_cache;
  const int* mask;      // [B, S] int32 contiguous, nonzero = attend
  void* o;              // [B, H, D] contiguous
  int layers, batch, heads, kv_heads, seq, head_dim, layer, dtype;  // dtype: 0 f32, 1 bf16
  float scale;
};

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kMaxGroup = 8;   // query heads per KV head held in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One 16-byte vector of a cache row: kVec elements of type T.
template <typename T>
struct Vec {
  static constexpr int kVec = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) { raw = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ float operator[](int j) const {
    return to_f(reinterpret_cast<const T*>(&raw)[j]);
  }
};

// Shared memory: q [G][D] f32 | weights [G][S] f32 | output accumulator [G][D] f32.
// Requires D % (16 / sizeof(T)) == 0 and 16-byte aligned cache rows (checked by
// the Python wrapper).
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  constexpr int kVec = Vec<T>::kVec;
  extern __shared__ float smem[];
  const int G = a.heads / a.kv_heads, D = a.head_dim, S = a.seq;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qf = smem;
  float* w = qf + G * D;
  float* acc_out = w + G * S;

  const long long slice = (long long)S * D;
  const long long head_off = (((long long)a.layer * a.batch + b) * a.kv_heads + kvh) * slice;
  const T* kc = static_cast<const T*>(a.k_cache) + head_off;
  const T* vc = static_cast<const T*>(a.v_cache) + head_off;
  const T* q = static_cast<const T*>(a.q) + ((long long)b * a.heads + kvh * G) * D;
  const int* mask = a.mask + (long long)b * S;

  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    qf[i] = to_f(q[i]);
    acc_out[i] = 0.f;
  }
  __syncthreads();

  // Scores: each thread takes whole key rows; q is read from shared memory as
  // a broadcast (every lane of a warp reads the same element).
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const T* kr = kc + (long long)s * D;
    float acc[kMaxGroup];
#pragma unroll
    for (int gi = 0; gi < kMaxGroup; ++gi) acc[gi] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += kVec) {
      Vec<T> kv;
      kv.load(kr + c);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float x = kv[j];
#pragma unroll
        for (int gi = 0; gi < kMaxGroup; ++gi) {
          if (gi < G) acc[gi] = fmaf(qf[gi * D + c + j], x, acc[gi]);
        }
      }
    }
    const bool valid = mask[s] != 0;
#pragma unroll
    for (int gi = 0; gi < kMaxGroup; ++gi) {
      if (gi < G) w[gi * S + s] = valid ? acc[gi] * a.scale : -1e30f;
    }
  }
  __syncthreads();

  // Softmax per query head, normalised in f32 and rounded to the cache type.
  for (int gi = warp; gi < G; gi += kThreads / 32) {
    float* row = w + gi * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float p = expf(row[s] - m);
      row[s] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) row[s] = to_f(from_f<T>(row[s] / sum));
  }
  __syncthreads();

  // PV: thread (r, c) owns column chunk c (kVec values) of value rows r, r + R,
  // ...; the R row groups then add their partial sums into shared memory.
  const int chunks = D / kVec;
  const int groups = kThreads / chunks;
  const int c = threadIdx.x % chunks, r = threadIdx.x / chunks;
  if (r < groups) {
    float acc[kMaxGroup][kVec];
#pragma unroll
    for (int gi = 0; gi < kMaxGroup; ++gi) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[gi][j] = 0.f;
    }
#pragma unroll 4
    for (int s = r; s < S; s += groups) {
      Vec<T> vv;
      vv.load(vc + (long long)s * D + c * kVec);
#pragma unroll
      for (int gi = 0; gi < kMaxGroup; ++gi) {
        if (gi < G) {
          const float p = w[gi * S + s];
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[gi][j] = fmaf(p, vv[j], acc[gi][j]);
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxGroup; ++gi) {
      if (gi < G) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) atomicAdd(&acc_out[gi * D + c * kVec + j], acc[gi][j]);
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.o) + ((long long)b * a.heads + kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) out[i] = from_f<T>(acc_out[i]);
}

template <typename T>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t g = static_cast<size_t>(a.heads / a.kv_heads);
  const size_t smem = sizeof(float) * (2 * g * a.head_dim + g * a.seq);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kv_heads, a.batch);
  decode_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Shapes,
// contiguity and types are validated by the Python wrapper.
extern "C" int owc_gqa_decode_attention(const DecodeArgs* args, void* stream) {
  const DecodeArgs a = *args;
  const int vec = a.dtype == 1 ? 8 : 4;  // elements per 16-byte vector
  if (a.kv_heads <= 0 || a.heads % a.kv_heads != 0 || a.heads / a.kv_heads > kMaxGroup ||
      a.head_dim <= 0 || a.head_dim % vec != 0 || a.head_dim / vec > kThreads ||
      a.layer < 0 || a.layer >= a.layers)
    return cudaErrorInvalidValue;
  if (a.batch == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dtype == 1) return launch<__nv_bfloat16>(a, s);
  if (a.dtype == 0) return launch<float>(a, s);
  return cudaErrorInvalidValue;
}

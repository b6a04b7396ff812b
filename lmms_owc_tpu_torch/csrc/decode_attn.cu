// Single-token GQA decode attention against one layer of a stacked KV cache,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _decode_kernel (K3) of
// lmms_owc_tpu/ops/attention.py, reached through gqa_decode_attention: the
// query heads of one KV group attend to layer `layer` of the stacked
// [L, B, KVH, S, D] cache under a [B, S] validity mask. The cache is bf16/f32
// (the query's type), or int8 with per-position f32 scales [L, B, KVH, S] (the
// TPU kernel's int8 branch; its [.., 8, S] sublane replication is TPU tiling).
//
// What bounds it on the H100: memory bytes. Each (row, KV head) reads its S x D
// slice of K and V once and does ~4*G flops per element read (G = H / KVH = 7
// at Qwen2-VL-7B), far below the card's ~295 flop/byte balance point. The int8
// cache halves those bytes; its scales add 8 bytes per position.
//
// What this first design does about it: one CTA per (batch row, KV head)
// computes all G query heads of the group, so every K and V element is read
// from device memory exactly once per step, in 16-byte vectors. At decode
// batch sizes that is few CTAs (32 at B=8), so the kernel is bound by load
// latency long before it reaches the card's bandwidth; it keeps many
// independent loads in flight instead: each thread owns whole key rows for
// the scores (no cross-lane reductions), and for PV each thread owns one
// column chunk (16 bytes; 8 bytes = 8 values of an int8 cache, so the
// accumulators stay at 8 x 8 registers) of a strided set of value rows; the
// row groups' partial sums are added in a fixed order, so the output does not
// depend on the run or the batch size (greedy tokens stay reproducible). The
// int8 values are exact in f32; as in the TPU kernel the scales fold into rows
// the kernel already holds: k_scale[s] multiplies the f32 score of key s (each
// thread loads the scales of its own rows, so the loads coalesce), v_scale[s]
// the normalised weight before PV (loaded by the lanes that normalise it). The
// layer is a pointer offset into the stacked cache: nothing is sliced or
// copied. Left for later work: split-K (flash-decoding) across CTAs, so a
// small batch fills more than B*KVH SMs. `layer` arrives as a host int;
// capturing the decode step in a CUDA graph will need it as a device scalar.
//
// Numerics follow the TPU kernel and gqa_attention_reference: f32 scores scaled
// in f32 (then by k_scale), masked keys set to -1e30, max, exp, sum, normalise
// in f32 (then times v_scale), round the weights to the query type, then PV
// with f32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Mirrors DecodeArgs in lmms_owc_tpu_torch/ops/_build.py (ctypes.Structure).
struct DecodeArgs {
  const void* q;        // [B, H, D] contiguous
  const void* k_cache;  // [L, B, KVH, S, D] contiguous
  const void* v_cache;
  const int* mask;      // [B, S] int32 contiguous, nonzero = attend
  void* o;              // [B, H, D] contiguous
  const float* k_scale;  // [L, B, KVH, S] f32 contiguous for an int8 cache, else null
  const float* v_scale;
  int layers, batch, heads, kv_heads, seq, head_dim, layer;
  int dtype;       // of q and o (and of a float cache): 0 f32, 1 bf16
  int cache_int8;  // 1: int8 cache with k_scale/v_scale
  float scale;
};

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kMaxGroup = 8;   // query heads per KV head held in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

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

template <int kBytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};

// One vector of a cache row: N elements of type C, loaded as one 8- or 16-byte word.
template <typename C, int N>
struct Vec {
  using Word = typename Raw<N * sizeof(C)>::type;
  Word raw;
  __device__ __forceinline__ void load(const C* p) { raw = *reinterpret_cast<const Word*>(p); }
  __device__ __forceinline__ float operator[](int j) const {
    return to_f(reinterpret_cast<const C*>(&raw)[j]);
  }
};

// Shared memory: q [G][D] f32 | weights [G][S] f32 | output accumulator [G][D] f32.
// T is the type of q and o, C that of the cache (T, or int8_t with scales).
// Requires D % (16 / sizeof(C)) == 0 and 16-byte aligned cache rows (checked by
// the Python wrapper).
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr int kVecK = 16 / sizeof(C);                  // score loads: 16 bytes
  constexpr int kVecV = kVecK < 8 ? kVecK : 8;           // PV loads: at most 8 values
  extern __shared__ float smem[];
  const int G = a.heads / a.kv_heads, D = a.head_dim, S = a.seq;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qf = smem;
  float* w = qf + G * D;
  float* acc_out = w + G * S;

  const long long slice = (long long)S * D;
  const long long head_off = (((long long)a.layer * a.batch + b) * a.kv_heads + kvh) * slice;
  const C* kc = static_cast<const C*>(a.k_cache) + head_off;
  const C* vc = static_cast<const C*>(a.v_cache) + head_off;
  const long long scale_off = (((long long)a.layer * a.batch + b) * a.kv_heads + kvh) * S;
  const float* ks = kInt8 ? a.k_scale + scale_off : nullptr;
  const float* vs = kInt8 ? a.v_scale + scale_off : nullptr;
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
    const C* kr = kc + (long long)s * D;
    float acc[kMaxGroup];
#pragma unroll
    for (int gi = 0; gi < kMaxGroup; ++gi) acc[gi] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += kVecK) {
      Vec<C, kVecK> kv;
      kv.load(kr + c);
#pragma unroll
      for (int j = 0; j < kVecK; ++j) {
        const float x = kv[j];
#pragma unroll
        for (int gi = 0; gi < kMaxGroup; ++gi) {
          if (gi < G) acc[gi] = fmaf(qf[gi * D + c + j], x, acc[gi]);
        }
      }
    }
    const bool valid = mask[s] != 0;
    const float k_scale = kInt8 ? ks[s] : 1.f;
#pragma unroll
    for (int gi = 0; gi < kMaxGroup; ++gi) {
      if (gi < G) {
        const float score = kInt8 ? acc[gi] * a.scale * k_scale : acc[gi] * a.scale;
        w[gi * S + s] = valid ? score : -1e30f;
      }
    }
  }
  __syncthreads();

  // Softmax per query head, normalised in f32 and rounded to the query type.
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
    for (int s = lane; s < S; s += 32) {
      const float p = kInt8 ? row[s] / sum * vs[s] : row[s] / sum;
      row[s] = to_f(from_f<T>(p));
    }
  }
  __syncthreads();

  // PV: thread (r, c) owns column chunk c (kVecV values) of value rows r, r + R,
  // ...; the R row groups then add their partial sums into shared memory one
  // group after another, in a fixed order, so the result is the same on every
  // run and for every batch size (no atomics).
  const int chunks = D / kVecV;
  const int groups = kThreads / chunks;
  const int c = threadIdx.x % chunks, r = threadIdx.x / chunks;
  float acc[kMaxGroup][kVecV];
#pragma unroll
  for (int gi = 0; gi < kMaxGroup; ++gi) {
#pragma unroll
    for (int j = 0; j < kVecV; ++j) acc[gi][j] = 0.f;
  }
  if (r < groups) {
#pragma unroll 4
    for (int s = r; s < S; s += groups) {
      Vec<C, kVecV> vv;
      vv.load(vc + (long long)s * D + c * kVecV);
#pragma unroll
      for (int gi = 0; gi < kMaxGroup; ++gi) {
        if (gi < G) {
          const float p = w[gi * S + s];
#pragma unroll
          for (int j = 0; j < kVecV; ++j) acc[gi][j] = fmaf(p, vv[j], acc[gi][j]);
        }
      }
    }
  }
  for (int rr = 0; rr < groups; ++rr) {
    if (r == rr) {
#pragma unroll
      for (int gi = 0; gi < kMaxGroup; ++gi) {
        if (gi < G) {
#pragma unroll
          for (int j = 0; j < kVecV; ++j) acc_out[gi * D + c * kVecV + j] += acc[gi][j];
        }
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.o) + ((long long)b * a.heads + kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) out[i] = from_f<T>(acc_out[i]);
}

template <typename T, typename C>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t g = static_cast<size_t>(a.heads / a.kv_heads);
  const size_t smem = sizeof(float) * (2 * g * a.head_dim + g * a.seq);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kv_heads, a.batch);
  decode_kernel<T, C><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Shapes,
// contiguity and types are validated by the Python wrapper.
extern "C" int owc_gqa_decode_attention(const DecodeArgs* args, void* stream) {
  const DecodeArgs a = *args;
  const int vec = a.cache_int8 ? 16 : (a.dtype == 1 ? 8 : 4);  // cache elements per 16 bytes
  if (a.kv_heads <= 0 || a.heads % a.kv_heads != 0 || a.heads / a.kv_heads > kMaxGroup ||
      a.head_dim <= 0 || a.head_dim % vec != 0 || a.head_dim / vec > kThreads ||
      a.layer < 0 || a.layer >= a.layers ||
      (a.cache_int8 && (a.k_scale == nullptr || a.v_scale == nullptr)))
    return cudaErrorInvalidValue;
  if (a.batch == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.cache_int8) {
    if (a.dtype == 1) return launch<__nv_bfloat16, int8_t>(a, s);
    if (a.dtype == 0) return launch<float, int8_t>(a, s);
    return cudaErrorInvalidValue;
  }
  if (a.dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (a.dtype == 0) return launch<float, float>(a, s);
  return cudaErrorInvalidValue;
}

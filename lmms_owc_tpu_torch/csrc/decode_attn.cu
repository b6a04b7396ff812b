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
// Two designs. The bf16-query instances at head_dim 64 and 128 with a cache
// length the split plan covers (every main-path shape) are the Hopper kernel
// of namespace sm90 below: the key axis split across a thread block cluster
// so a small batch fills the card, coalesced 16-byte cp.async of whole rows,
// both products on the tensor cores with the query group packed into M. The
// general kernel serves f32 and everything else: one CTA per (batch row, KV
// head) computes all G query heads of the group, each thread owning whole key
// rows for the scores and one column chunk of a strided set of value rows for
// PV, whose row groups' partial sums are added in a fixed order. The general
// kernel keeps the group's f32 score rows in shared memory up to the card's
// 227 KB (S <= 8045 at G = 7, D = 128); past that the wrapper passes an f32
// workspace [B, KVH, G, S] in device memory and the rows live there, with the
// same arithmetic in the same order (S = 8704 at the longest bucket). Both read
// every K and V element from device memory once, fold the scales into rows
// they already hold (k_scale[s] into the f32 score of key s, v_scale[s] into
// the normalised weight before PV), take the layer as a pointer offset into
// the stacked cache, and give bits that depend neither on the run nor on the
// batch size (greedy tokens stay reproducible). `layer` arrives as a host
// int; capturing the decode step in a CUDA graph will need it as a device
// scalar.
//
// Numerics follow the TPU kernel and gqa_attention_reference: f32 scores scaled
// in f32 (then by k_scale), masked keys set to -1e30, max, exp, sum, normalise
// in f32 (then times v_scale), round the weights to the query type, then PV
// with f32 accumulation.

#include <cooperative_groups.h>
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
  int splits, split_keys;  // the key-axis split plan (decode_split_plan): CTAs per (row, KV head), keys each
  float* workspace;  // general kernel: f32 score rows [B, KVH, G, S] when they do not fit in shared memory, else null
};

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kMaxGroup = 8;   // query heads per KV head held in registers
constexpr int kMaxDynamicSmem = 232448;  // bytes a block may take on Hopper

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

// Shared memory: q [G][D] f32 | weights [G][S] f32 | output accumulator [G][D] f32,
// or, with a workspace (a cache too long for the score rows to fit), q | output
// accumulator, and the weights [G][S] of this (row, KV head) in the workspace.
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
  float* w = a.workspace ? a.workspace + ((long long)b * a.kv_heads + kvh) * G * S : qf + G * D;
  float* acc_out = a.workspace ? qf + G * D : w + G * S;

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
  const size_t smem = sizeof(float) * (2 * g * a.head_dim + (a.workspace ? 0 : g * a.seq));
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance: the card's limit
      decode_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (attr != cudaSuccess) return attr;
  if (smem > static_cast<size_t>(kMaxDynamicSmem)) return cudaErrorInvalidValue;
  const dim3 grid(a.kv_heads, a.batch);
  decode_kernel<T, C><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}


// ============================================================================
// The Hopper design of the bf16-query instances (bf16 or int8 cache).
//
// The key axis of each (row, KV head) is split across the CTAs of one thread
// block cluster, by a plan (splits, keys per split) that the wrapper computes
// from S alone (decode_split_plan), so a pooled and an unpooled batch split
// alike and give the same bits. At S = 384 that is 6 CTAs of 64 keys: 288 CTAs
// at B = 8 where the general kernel had 32. Each CTA:
//   * copies its K and V rows into shared memory with 16-byte cp.async, all in
//     flight at once (V lands while the scores are computed);
//   * computes the scores of all G <= 8 query heads (the rows of an m16 tile
//     past G are zero registers, never stored) against its keys
//     on the tensor cores, mma.sync m16n8k16 with int8 values converted to
//     bf16 in registers (exact: |x| <= 127), k_scale folded into the f32 score;
//   * pushes its per-head max and sum of exponentials into the shared memory
//     of every CTA of the cluster (remote stores, no round trips), once;
//   * normalises in f32, multiplies by v_scale, rounds to bf16, computes its
//     PV partial on the tensor cores and pushes each slice of it to the CTA
//     that owns that slice of the output;
//   * and adds the partials of its own slice in rank order and writes it.
// That keeps the TPU kernel's numerics (normalise before the cast) in one
// launch, with no atomics. The shared-memory attribute is set once per
// template instance; nothing varies per call but the arguments.

namespace sm90 {

constexpr int kThreads = 128;     // 4 warps
constexpr int kMaxSplits = 8;     // portable cluster size
constexpr int kMaxSplitKeys = 256;
constexpr int kRows = 8;          // the query group (mma M is 16: rows 8-15 are zeros, never stored)

template <typename C, int D>
struct Layout {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(C)) + 16;  // padded: no bank conflicts
  static constexpr int kQLd = D + 8;                                      // bf16 elements
  static size_t bytes(int keys) {
    return 2 * static_cast<size_t>(keys) * kRowBytes + kRows * kQLd * 2 + kRows * keys * 4 +
           (kRows * D + kMaxSplits) * 4 + 2 * keys * 4 + keys * 4 + (2 * kMaxSplits + 2) * kRows * 4;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pair_bits(const __nv_bfloat16* p) {  // two bf16 values
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair_bits(const int8_t* p) {  // two int8 values as bf16
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(p[0]), static_cast<float>(p[1]));
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pair_bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t x) { return __float2bfloat16(static_cast<float>(x)); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename C, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  using L = Layout<C, D>;
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr int kChunks = D * static_cast<int>(sizeof(C)) / 16;  // 16-byte chunks per cache row
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = a.splits, chunk = a.split_keys;
  const int G = a.heads / a.kv_heads, S = a.seq;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int s0 = rank * chunk, n = max(0, min(S, s0 + chunk) - s0);
  const int n16 = (n + 15) / 16 * 16;
  // Arrive now, wait before the first store into another CTA's shared memory:
  // every CTA of the cluster has started by then.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kbuf = smem;
  unsigned char* vbuf = kbuf + chunk * L::kRowBytes;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(vbuf + chunk * L::kRowBytes);
  float* w = reinterpret_cast<float*>(qs + kRows * L::kQLd);  // [8][chunk] scores, then weights
  float* part = w + kRows * chunk;  // [splits][per]: every CTA's partial of this CTA's output slice
  float* kscale = part + kRows * D + kMaxSplits;
  float* vscale = kscale + chunk;
  int* valid = reinterpret_cast<int*>(vscale + chunk);
  float* red_max = reinterpret_cast<float*>(valid + chunk);  // [splits][8] every CTA's max
  float* red_sum = red_max + kMaxSplits * kRows;             // and sum of exponentials
  float* gmax = red_sum + kMaxSplits * kRows;                // [8] the cluster's max
  float* total = gmax + kRows;                               // [8] and 1 / sum, per head

  const long long head = ((static_cast<long long>(a.layer) * a.batch + b) * a.kv_heads + kvh);
  const C* kc = static_cast<const C*>(a.k_cache) + head * S * D + static_cast<long long>(s0) * D;
  const C* vc = static_cast<const C*>(a.v_cache) + head * S * D + static_cast<long long>(s0) * D;

  // K and V rows [s0, s0 + n16) of this split (zero past S), as one group.
  for (int idx = tid; idx < n16 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool ok = r < n;
    const int bytes = ok ? 16 : 0;
    const long long off = static_cast<long long>(ok ? r : 0) * D * sizeof(C) + c * 16;
    const uint32_t dst = r * L::kRowBytes + c * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(kbuf + dst)),
                 "l"(reinterpret_cast<const unsigned char*>(kc) + off), "r"(bytes));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(vbuf + dst)),
                 "l"(reinterpret_cast<const unsigned char*>(vc) + off), "r"(bytes));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // q rows of the group (zero past G), the mask and the scales of the split.
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + (static_cast<long long>(b) * a.heads + kvh * G) * D;
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    qs[r * L::kQLd + c] = r < G ? q[r * D + c] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < n; i += kThreads) {
    valid[i] = a.mask[static_cast<long long>(b) * S + s0 + i] != 0;
    if (kInt8) {
      kscale[i] = a.k_scale[head * S + s0 + i];
      vscale[i] = a.v_scale[head * S + s0 + i];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Scores: warp w takes key tiles of 8 (w, w + 4, ...): S[16 x 8] = Q K^T,
  // with the q fragments held in registers.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc16 = 0; kc16 < D / 16; ++kc16) {
    const int c = kc16 * 16 + tig * 2;
    qa[kc16][0] = pair_bits(qs + g * L::kQLd + c);
    qa[kc16][1] = 0u;  // rows 8-15
    qa[kc16][2] = pair_bits(qs + g * L::kQLd + c + 8);
    qa[kc16][3] = 0u;
  }
  for (int t = warp; t * 8 < n; t += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const C* krow = reinterpret_cast<const C*>(kbuf + (t * 8 + g) * L::kRowBytes);
#pragma unroll
    for (int kc16 = 0; kc16 < D / 16; ++kc16) {
      const int c = kc16 * 16 + tig * 2;
      mma_bf16(acc, qa[kc16][0], qa[kc16][1], qa[kc16][2], qa[kc16][3], pair_bits(krow + c),
               pair_bits(krow + c + 8));
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // row g; regs 2, 3 hold the zero rows
      const int row = g, key = t * 8 + tig * 2 + c;
      if (key < n) {
        const float score = kInt8 ? acc[c] * a.scale * kscale[key] : acc[c] * a.scale;
        w[row * chunk + key] = valid[key] ? score : -1e30f;
      }
    }
  }
  __syncthreads();

  // Softmax across the cluster: each CTA's max and sum of exponentials per
  // head, exchanged once; every CTA combines them in rank order alike.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int h = warp; h < kRows; h += 4) {
    float m = -INFINITY, sum = 0.f;
    if (h < G) {
      for (int i = lane; i < n; i += 32) m = fmaxf(m, w[h * chunk + i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      for (int i = lane; i < n; i += 32) sum += expf(w[h * chunk + i] - m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane < splits) {  // pushed to every CTA of the cluster (stores, no round trips)
      cluster.map_shared_rank(red_max, lane)[rank * kRows + h] = m;
      cluster.map_shared_rank(red_sum, lane)[rank * kRows + h] = sum;
    }
  }
  cluster.sync();
  if (tid < G) {  // in rank order, so every CTA of the cluster gets the same values
    float m = -INFINITY, sum = 0.f;
    for (int r = 0; r < splits; ++r) m = fmaxf(m, red_max[r * kRows + tid]);
    for (int r = 0; r < splits; ++r) sum += red_sum[r * kRows + tid] * expf(red_max[r * kRows + tid] - m);
    gmax[tid] = m;
    total[tid] = 1.f / sum;
  }
  __syncthreads();
  // Normalise in f32 (times v_scale), round to bf16; keys past n weigh 0.
  for (int i = tid; i < kRows * n16; i += kThreads) {
    const int h = i / n16, key = i - h * n16;
    float p = 0.f;
    if (h < G && key < n) {
      p = expf(w[h * chunk + key] - gmax[h]) * total[h];
      if (kInt8) p *= vscale[key];
    }
    w[h * chunk + key] = __bfloat162float(__float2bfloat16(p));
  }
  __syncthreads();

  // PV partial: warp w takes the output's n8 column tiles w, w + 4, ...; the
  // A fragments (weights) of a k-step are read once for all of them.
  constexpr int kNT = D / 32;  // column tiles per warp
  const int per = (G * D + splits - 1) / splits;  // output elements each CTA adds
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < n16; k0 += 16) {
    const int kk = k0 + tig * 2;
    const float* w0 = w + g * chunk + kk;
    const uint32_t a0 = pack_pair(w0[0], w0[1]), a1 = 0u, a2 = pack_pair(w0[8], w0[9]), a3 = 0u;
    const unsigned char* r0 = vbuf + kk * L::kRowBytes;
    const unsigned char* r8 = vbuf + (kk + 8) * L::kRowBytes;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = (warp + 4 * j) * 8 + g;
      const C* v0 = reinterpret_cast<const C*>(r0) + col;
      const C* v1 = reinterpret_cast<const C*>(r0 + L::kRowBytes) + col;
      const C* v8 = reinterpret_cast<const C*>(r8) + col;
      const C* v9 = reinterpret_cast<const C*>(r8 + L::kRowBytes) + col;
      mma_bf16(acc[j], a0, a1, a2, a3, pair_bits(to_bf16(*v0), to_bf16(*v1)), pair_bits(to_bf16(*v8), to_bf16(*v9)));
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (g < G) {  // pushed to the CTA that adds this output element
        const int i = g * D + (warp + 4 * j) * 8 + tig * 2 + c, owner = i / per;
        cluster.map_shared_rank(part, owner)[rank * per + i - owner * per] = acc[j][c];
      }
    }
  }
  cluster.sync();

  // Each CTA adds its slice of the output over the partials in rank order and writes it.
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + (static_cast<long long>(b) * a.heads + kvh * G) * D;
  for (int i = rank * per + tid; i < min(G * D, (rank + 1) * per); i += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < splits; ++r) sum += part[r * per + i - rank * per];
    out[i] = __float2bfloat16(sum);
  }
}

template <typename C, int D>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance
      decode_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<C, D>::bytes(kMaxSplitKeys)));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.kv_heads, a.batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<C, D>::bytes(a.split_keys);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_kernel<C, D>, a);
}

// Whether these instances take the call: a bf16 query, head_dim 64 or 128,
// groups up to 8, and a split plan with at most 8 splits of at most 256 keys
// (a multiple of 16) that covers S. Anything else runs the general kernel.
bool takes(const DecodeArgs& a) {
  const int G = a.heads / a.kv_heads;
  return a.dtype == 1 && (a.head_dim == 64 || a.head_dim == 128) && G <= kRows && a.splits >= 1 &&
         a.splits <= kMaxSplits && a.split_keys % 16 == 0 && a.split_keys <= kMaxSplitKeys &&
         static_cast<long long>(a.splits) * a.split_keys >= a.seq &&
         static_cast<long long>(a.splits - 1) * a.split_keys < a.seq;
}

template <typename C>
cudaError_t dispatch(const DecodeArgs& a, cudaStream_t stream) {
  return a.head_dim == 64 ? launch<C, 64>(a, stream) : launch<C, 128>(a, stream);
}

}  // namespace sm90

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
  if (sm90::takes(a)) return a.cache_int8 ? sm90::dispatch<int8_t>(a, s) : sm90::dispatch<__nv_bfloat16>(a, s);
  if (a.cache_int8) {
    if (a.dtype == 1) return launch<__nv_bfloat16, int8_t>(a, s);
    if (a.dtype == 0) return launch<float, int8_t>(a, s);
    return cudaErrorInvalidValue;
  }
  if (a.dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (a.dtype == 0) return launch<float, float>(a, s);
  return cudaErrorInvalidValue;
}

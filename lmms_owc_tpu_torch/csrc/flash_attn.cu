// Tiled online-softmax attention for Hopper (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of lmms_owc_tpu/ops/attention.py:
//   * _flash_kernel (K2, reached through flash_attention and
//     fused_qkv_attention): the decoder prefill, causal GQA with one contiguous
//     (start, end) valid key run per batch row, and the Qwen2.5-VL vision
//     tower's window and global layers, whose window padding leaves gaps in the
//     key run (the [B, Lk] tensor-mask form);
//   * _flash_kernel_fm (K1, reached through fused_qkv_attention_fm): the vision
//     tower's non-causal MHA over the combined qkv projection, with the HF
//     half-split rope applied to q and k inside the kernel;
//   * _packed_kernel (K5, reached through packed_vision_attention): the same
//     attention over a qkv projection whose heads are zero-padded to 128
//     columns; the padding exists for TPU lane tiling, so here it is only a
//     wider token stride, and the caller zeroes the output's padding columns.
// One kernel template serves all three. The caller passes base pointers plus
// element strides for (batch, head, token) with a unit stride along head_dim, so
// each entry reads q, k and v as views of one qkv projection output (token- or
// head-major, padded or not) and writes its output layout with no copies.
//
// What bounds it on the H100: both uses are compute-bound at the main-path
// shapes. Per 64-row q block the kernel does 4*64*L*D flops against 2*L*D
// elements of K and V (the ViT at L=1024, D=80; the prefill at L~320, D=128),
// far above the card's ~295 flop/byte balance point.
//
// What this first design does about it: the two products run on the tensor
// cores as mma.sync m16n8k16 bf16 tiles with f32 accumulation; the score tile
// never leaves registers (its accumulator fragments are re-packed as the A
// operand of the PV product). Blocks that the causal diagonal or the (start,
// end) key range exclude are skipped; with a tensor mask (its own template
// instance, so the other forms compile as before), the tile's 64 mask entries
// are staged in shared memory beside k/v, and a tile with no valid key is
// skipped before its k/v loads. Left for later work: TMA or cp.async
// double buffering (loads here are synchronous), wgmma, and warp specialisation.
//
// Numerics: scores in f32, scaled by scale*log2(e) in f32, online softmax in
// base 2. p is rounded to the input type for the PV product (as the TPU kernel
// does); the running sum uses the f32 p. Rope rotates in f32 and rounds once to
// the input type. A query row with no valid key writes zeros. f32 inputs run
// the same tiling with CUDA-core dot products in place of the bf16 MMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Mirrors FlashArgs in lmms_owc_tpu_torch/ops/_build.py (ctypes.Structure).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_sl;  // element strides: batch, head, token
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  const int* mask_se;  // [B, 2] int32 (start, end) of each row's valid keys, or null
  const int* mask;     // [B, Lk] int32 contiguous, nonzero = attend, or null (exclusive with mask_se)
  const float* cos;    // [B or 1, L, D/2] f32 contiguous, or null (no rope)
  const float* sin;
  long long rope_sb;   // batch stride of cos/sin in elements (0 broadcasts one table)
  int batch, heads, kv_heads, lq, lk, head_dim, causal, dtype;  // dtype: 0 f32, 1 bf16
  float scale_log2;    // softmax scale * log2(e)
};

namespace {

constexpr int kBQ = 64;        // query rows per CTA (16 per warp)
constexpr int kBK = 64;        // keys per k block
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // shared-memory row padding (elements): no bank conflicts

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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a(16x16, row-major) * b(16x8, col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copies token rows [row0, row0 + kRows) of one head into shared memory
// [kRows][D + kPad], zero-filling rows at or past `nrows`. With `cos` set, the
// pair (i, i + D/2) of each row is rotated by the rope table in f32.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride, int row0,
                                          int nrows, const float* cos, const float* sin) {
  constexpr int kHalf = D / 2;
  constexpr int kLd = D + kPad;
  for (int idx = threadIdx.x; idx < kRows * kHalf; idx += kThreads) {
    const int r = idx / kHalf;
    const int i = idx - r * kHalf;
    const int row = row0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (row < nrows) {
      const T* p = src + row * row_stride;
      x1 = to_f(p[i]);
      x2 = to_f(p[i + kHalf]);
      if (cos != nullptr) {
        const long long t = (long long)row * kHalf + i;
        const float c = cos[t], s = sin[t];
        const float y1 = x1 * c - x2 * s;
        const float y2 = x2 * c + x1 * s;
        x1 = y1;
        x2 = y2;
      }
    }
    dst[r * kLd + i] = from_f<T>(x1);
    dst[r * kLd + i + kHalf] = from_f<T>(x2);
  }
}

// Scores s[j][c] of this warp's 16 rows against the 64 keys of the tile, in the
// m16n8 accumulator layout: row g (+8 for c >= 2), key j*8 + 2*tig + (c & 1).
template <int D>
__device__ __forceinline__ void qk(float (&s)[kBK / 8][4], const __nv_bfloat16* qs,
                                   const __nv_bfloat16* ks, int r_lo, int g, int tig, float*) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + tig * 2;
    const uint32_t a0 = ld_pair(qs + r_lo * kLd + c);
    const uint32_t a1 = ld_pair(qs + (r_lo + 8) * kLd + c);
    const uint32_t a2 = ld_pair(qs + r_lo * kLd + c + 8);
    const uint32_t a3 = ld_pair(qs + (r_lo + 8) * kLd + c + 8);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const __nv_bfloat16* kr = ks + (j * 8 + g) * kLd + c;
      mma_bf16(s[j], a0, a1, a2, a3, ld_pair(kr), ld_pair(kr + 8));
    }
  }
}

template <int D>
__device__ __forceinline__ void qk(float (&s)[kBK / 8][4], const float* qs, const float* ks,
                                   int r_lo, int g, int tig, float*) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float* qr = qs + (r_lo + (c >> 1) * 8) * kLd;
      const float* kr = ks + (j * 8 + tig * 2 + (c & 1)) * kLd;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      s[j][c] += acc;
    }
  }
}

// o[n][c] += p @ V for this warp's 16 rows: row g (+8 for c >= 2), dim
// n*8 + 2*tig + (c & 1). The bf16 form re-packs the score accumulators as the
// A operand; the f32 form stages p through this warp's shared scratch.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[kBK / 8][4],
                                   const __nv_bfloat16* vs, int g, int tig, float*) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    const uint32_t a0 = pack_pair(p[2 * kc][0], p[2 * kc][1]);
    const uint32_t a1 = pack_pair(p[2 * kc][2], p[2 * kc][3]);
    const uint32_t a2 = pack_pair(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    const uint32_t a3 = pack_pair(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    const int kr = kc * 16 + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + g;
      const uint32_t b0 = pack_pair(vs[kr * kLd + col], vs[(kr + 1) * kLd + col]);
      const uint32_t b1 = pack_pair(vs[(kr + 8) * kLd + col], vs[(kr + 9) * kLd + col]);
      mma_bf16(o[n], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[kBK / 8][4],
                                   const float* vs, int g, int tig, float* ps) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) ps[(g + (c >> 1) * 8) * kBK + j * 8 + tig * 2 + (c & 1)] = p[j][c];
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float* pr = ps + (g + (c >> 1) * 8) * kBK;
      const int col = n * 8 + tig * 2 + (c & 1);
      float acc = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) acc = fmaf(pr[kk], vs[kk * kLd + col], acc);
      o[n][c] += acc;
    }
  }
  __syncwarp();
}

template <typename T, int D, bool kTensorMask>
__global__ void __launch_bounds__(kThreads) flash_kernel(const FlashArgs a) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBQ * kLd;
  T* vs = ks + kBK * kLd;
  float* ps = reinterpret_cast<float*>(vs + kBK * kLd);  // f32 form only: [4 warps][16][kBK]
  __shared__ int mask_tile[kBK];  // the k tile's entries of a tensor mask

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qb * kBQ;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* cs = a.cos != nullptr ? a.cos + b * a.rope_sb : nullptr;
  const float* sn = a.sin != nullptr ? a.sin + b * a.rope_sb : nullptr;
  const int* mrow = kTensorMask ? a.mask + static_cast<long long>(b) * a.lk : nullptr;

  // Valid keys of this CTA: the row's (start, end) run, clipped by the causal
  // diagonal (aligned to the sequence end) of the block's last query row.
  int k_lo = 0, k_hi = a.lk;
  if (a.mask_se != nullptr) {
    k_lo = max(a.mask_se[2 * b], 0);
    k_hi = min(a.mask_se[2 * b + 1], a.lk);
  }
  const int offset = a.lk - a.lq;
  if (a.causal) k_hi = min(k_hi, min(q0 + kBQ, a.lq) + offset);

  load_tile<T, D, kBQ>(qs, qp, a.q_sl, q0, a.lq, cs, sn);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};
  const int r_lo = warp * 16 + g;  // tile rows r_lo and r_lo + 8
  const int qi[2] = {q0 + r_lo, q0 + r_lo + 8};

  for (int kb0 = (k_lo / kBK) * kBK; kb0 < k_hi; kb0 += kBK) {
    __syncthreads();  // the previous k/v tiles are consumed; the q tile is written
    if (kTensorMask) {
      int any = 0;
      for (int i = threadIdx.x; i < kBK; i += kThreads) {
        const int m = kb0 + i < a.lk ? mrow[kb0 + i] : 0;
        mask_tile[i] = m;
        any |= m;
      }
      if (!__syncthreads_or(any)) continue;  // no valid key in this tile (uniform branch)
    }
    load_tile<T, D, kBK>(ks, kp, a.k_sl, kb0, a.lk, cs, sn);
    load_tile<T, D, kBK>(vs, vp, a.v_sl, kb0, a.lk, nullptr, nullptr);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    qk<D>(s, qs, ks, r_lo, g, tig, ps);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = kb0 + j * 8 + tig * 2 + (c & 1);
        const bool ok = kk >= k_lo && kk < k_hi && (!a.causal || kk <= qi[c >> 1] + offset) &&
                        (!kTensorMask || mask_tile[kk - kb0] != 0);
        const float x = ok ? s[j][c] * a.scale_log2 : -INFINITY;
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      corr[r] = m_new == -INFINITY ? 1.f : exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p = m_row[r] == -INFINITY ? 0.f : exp2f(s[j][c] - m_row[r]);
        s[j][c] = p;
        rs[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_row[r] = l_row[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] *= corr[c >> 1];
    }
    pv<D>(o, s, vs, g, tig, ps + warp * 16 * kBK);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.lq) continue;
    const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
    T* orow = op + qi[r] * a.o_sl;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      orow[n * 8 + tig * 2] = from_f<T>(o[n][2 * r] * inv);
      orow[n * 8 + tig * 2 + 1] = from_f<T>(o[n][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D, bool kTensorMask>
cudaError_t launch_masked(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBQ + 2 * kBK) * (D + kPad) * sizeof(T) +
                      (std::is_same<T, float>::value ? 4 * 16 * kBK * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D, kTensorMask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kBQ - 1) / kBQ, a.heads, a.batch);
  flash_kernel<T, D, kTensorMask><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  return a.mask != nullptr ? launch_masked<T, D, true>(a, stream)
                           : launch_masked<T, D, false>(a, stream);
}

template <typename T>
cudaError_t dispatch_head_dim(const FlashArgs& a, cudaStream_t stream) {
  switch (a.head_dim) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Shapes,
// strides and types are validated by the Python wrapper.
extern "C" int owc_flash_attention(const FlashArgs* args, void* stream) {
  const FlashArgs a = *args;
  if (a.heads <= 0 || a.kv_heads <= 0 || a.heads % a.kv_heads != 0) return cudaErrorInvalidValue;
  if (a.batch == 0 || a.lq == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dtype == 1) return dispatch_head_dim<__nv_bfloat16>(a, s);
  if (a.dtype == 0) return dispatch_head_dim<float>(a, s);
  return cudaErrorInvalidValue;
}

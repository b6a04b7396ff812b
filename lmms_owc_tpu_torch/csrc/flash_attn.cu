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
// Two designs. The bf16 instances at head_dim 80 and 128 (every main-path
// shape) are the Hopper kernel of namespace sm90 below: a cp.async ring of
// K/V stages, wgmma for both products, rope once per token. The general
// kernel serves f32, head_dims 16/32/64 and views whose rows are not 16-byte
// aligned: the two products run on mma.sync m16n8k16 bf16 tiles (f32: CUDA
// cores) with f32 accumulation, synchronous loads, rope per tile. In both, the
// score tile never leaves registers (its accumulator fragments are re-packed
// as the A operand of the PV product); blocks that the causal diagonal or the
// (start, end) key range exclude are skipped, and with a tensor mask (its own
// template instance) tiles with no valid key are skipped before their loads.
// Left for later work: TMA, warp specialisation, overlapping one tile's
// softmax with the next tile's products.
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
  void* k_rot;         // bf16 scratch [B, KVH, Lk, D] for the rotated keys (rope), or null
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
  constexpr size_t smem = static_cast<size_t>(kBQ + 2 * kBK) * (D + kPad) * sizeof(T) +
                          (std::is_same<T, float>::value ? 4 * 16 * kBK * sizeof(float) : 0);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance
      flash_kernel<T, D, kTensorMask>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
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


// ============================================================================
// The Hopper design of the bf16 instances at head_dim 80 and 128.
//
// A CTA of kWG warpgroups owns 64 * kWG query rows of one head: three
// warpgroups (192 rows) share each K/V tile when the query is longer than 64
// rows (the vision towers' 1024, the prefill), one takes a 64-row window.
//   * Copies: K and V tiles of 64 keys stream through a ring of kStages = 3
//     shared-memory stages with 16-byte cp.async (zero-filled past the end),
//     issued two tiles ahead, so the next tiles load while the current one is
//     multiplied. The q tile is read once per CTA.
//   * Products: wgmma. S = Q K^T runs m64n64k16 with Q and K both read from
//     shared memory as K-major operands (head_dim/16 steps: 5 at D = 80);
//     O += P V runs m64nDk16 with P re-packed from the S accumulators into
//     bf16 A fragments in registers and V read as an MN-major operand
//     (N = D = 80 or 128, a multiple of 8). Tiles are stored as 8x8 core
//     matrices (no swizzle: 160-byte rows do not fit the 128-byte pattern), so
//     the same layout is K-major for Q and K and MN-major for V.
//   * Rope, once per token: the q tile is rotated in f32 as it is read (once
//     per CTA, that is once per query token and head); the keys are rotated
//     by a pre-pass kernel (rope_keys_kernel) into a scratch [B, KVH, Lk, D]
//     the wrapper allocates, once per key token and KV head, instead of once
//     per query block; with a single q block per head (the 2.5 window layers)
//     the kernel rotates each key tile in shared memory as it lands instead,
//     which saves the pre-pass's extra pass over K. Both round to bf16 once,
//     as the TPU kernel does.
//   * Schedule: each iteration issues QK of tile i + 1 and PV of tile i back
//     to back and waits for both within it; the softmax of tile i + 1 runs on
//     the CUDA cores while PV of tile i is in flight. Register fences keep the
//     compiler from moving accumulator reads and writes between a wgmma and
//     its wait, which would make ptxas serialize the wgmmas (chip_smoke.py
//     prints any such ptxas note).
//   * Softmax: scores stay unscaled; p = 2^(s * scale*log2(e) - m) is one fma
//     and one ex2. Masks are branch-free selects, skipped on tiles whose keys
//     are all valid.
//   * Masks: the causal diagonal and the (start, end) run clip the CTA's tile
//     range; the [B, Lk] tensor mask is copied to shared memory once per CTA
//     as bytes, only its tiles with a valid key enter the pipeline, and those
//     with every key valid skip the per-score mask.
// The shared-memory attribute is set once per template instance.

namespace sm90 {

constexpr int kBK = 64;        // keys per tile; query rows per warpgroup (wgmma M)
constexpr int kStages = 3;     // K/V ring depth (deeper rings measured no faster)
constexpr int kMaxKeys = 16384;  // tensor-mask rows staged in shared memory
constexpr int kMaxTiles = kMaxKeys / kBK;
constexpr int kFullTile = 1 << 30;  // tensor-mask tile list: every key of the tile is valid

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row r, 16-byte chunk c) in a tile of kRows rows stored as
// 8x8 core matrices: consecutive row groups 128 bytes apart, consecutive
// column chunks kRows * 16 bytes apart.
template <int kRows>
__device__ __forceinline__ uint32_t core_offset(int r, int c) {
  return static_cast<uint32_t>((c * (kRows / 8) + (r >> 3)) * 128 + (r & 7) * 16);
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// (K-direction) and stride (M/N-direction) byte offsets between core matrices.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// Generic-proxy writes to shared memory (st.shared, cp.async) before wgmma reads them.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64n64 f32 accumulator fragment) += A(64x16) * B(16x64), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (m64n80) += A(64x16, bf16 fragments in registers) * B(16x80), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39}, {%40,%41,%42,%43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (m64n128) += A(64x16, bf16 fragments in registers) * B(16x128), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_pv<80>(float (&o)[40], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n80(o, a, desc_b, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n128(o, a, desc_b, 1);
}

// Rotates 8 pairs (x1[i], x2[i]) by the rope table entries cos[i], sin[i]
// (16-byte aligned f32) in f32 and rounds each result to bf16 once.
__device__ __forceinline__ void rotate8(uint4& x1, uint4& x2, const float* cos, const float* sin) {
  const float4 c0 = *reinterpret_cast<const float4*>(cos), c1 = *reinterpret_cast<const float4*>(cos + 4);
  const float4 s0 = *reinterpret_cast<const float4*>(sin), s1 = *reinterpret_cast<const float4*>(sin + 4);
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&x1);
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&x2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), v = __bfloat1622float2(b[i]);
    a[i] = __floats2bfloat162_rn(u.x * c[2 * i] - v.x * s[2 * i], u.y * c[2 * i + 1] - v.y * s[2 * i + 1]);
    b[i] = __floats2bfloat162_rn(v.x * c[2 * i] + u.x * s[2 * i], v.y * c[2 * i + 1] + u.y * s[2 * i + 1]);
  }
}

// Rope pre-pass: k [B, KVH, Lk, D] (strided) -> out, contiguous, rotated.
// One thread per (key row, 16-byte chunk of the first half).
template <int D>
__global__ void __launch_bounds__(256) rope_keys_kernel(const FlashArgs a, __nv_bfloat16* out) {
  constexpr int kHalf = D / 2, kChunks = D / 16;
  const long long total = static_cast<long long>(a.batch) * a.kv_heads * a.lk * kChunks;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % kChunks);
  const long long row = idx / kChunks;  // (b * KVH + h) * Lk + t
  const int t = static_cast<int>(row % a.lk);
  const int h = static_cast<int>((row / a.lk) % a.kv_heads);
  const int b = static_cast<int>(row / (static_cast<long long>(a.lk) * a.kv_heads));
  const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh + t * a.k_sl;
  uint4 x1 = *reinterpret_cast<const uint4*>(src + c * 8);
  uint4 x2 = *reinterpret_cast<const uint4*>(src + kHalf + c * 8);
  const long long r = b * a.rope_sb + static_cast<long long>(t) * kHalf + c * 8;
  rotate8(x1, x2, a.cos + r, a.sin + r);
  __nv_bfloat16* dst = out + row * D;
  *reinterpret_cast<uint4*>(dst + c * 8) = x1;
  *reinterpret_cast<uint4*>(dst + kHalf + c * 8) = x2;
}

template <int D, bool kTensorMask, int kWG>
__global__ void __launch_bounds__(128 * kWG) flash_kernel(const FlashArgs a) {
  constexpr int kThreads = 128 * kWG;  // kWG warpgroups share each K/V tile
  constexpr int kBQ = kBK * kWG;       // query rows per CTA, 64 per warpgroup
  constexpr int kTile = kBK * D * 2;   // bytes of one k or v tile, or of a warpgroup's q rows
  constexpr int kChunks = D / 8;      // 16-byte chunks per row
  constexpr int kHalfChunks = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* ks = smem + kWG * kTile;
  unsigned char* vs = ks + kStages * kTile;
  int* tiles = reinterpret_cast<int*>(vs + kStages * kTile);                   // tensor mask only
  unsigned char* mk = reinterpret_cast<unsigned char*>(tiles + kMaxTiles);     // tensor mask only
  __shared__ int n_tiles_shared;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qb * kBQ;

  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  int k_lo = 0, k_hi = a.lk;
  if (a.mask_se != nullptr) {
    k_lo = max(a.mask_se[2 * b], 0);
    k_hi = min(a.mask_se[2 * b + 1], a.lk);
  }
  const int offset = a.lk - a.lq;
  if (a.causal) k_hi = min(k_hi, min(q0 + kBQ, a.lq) + offset);
  const int t0 = k_lo / kBK;
  const int t_end = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t0;

  // The tensor mask's row as bytes (zero past Lk), and the list of its tiles
  // in [t0, t_end) that hold a valid key, built by warp 0 with ballots.
  int n_tiles = t_end - t0;
  if (kTensorMask) {
    const int* mrow = a.mask + static_cast<long long>(b) * a.lk;
    for (int i = tid; i < t_end * kBK; i += kThreads) mk[i] = i < a.lk && mrow[i] != 0;
    __syncthreads();
    if (warp == 0) {
      int n = 0;
      for (int base = t0; base < t_end; base += 32) {
        const int t = base + lane;
        bool any = false, full = true;
        if (t < t_end) {
          const uint4* m = reinterpret_cast<const uint4*>(mk + t * kBK);
#pragma unroll
          for (int i = 0; i < kBK / 16; ++i) {
            const uint4 w = m[i];
            any |= (w.x | w.y | w.z | w.w) != 0;
            full &= (w.x & w.y & w.z & w.w) == 0x01010101u;  // every byte 1
          }
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, any);
        if (any) tiles[n + __popc(ballot & ((1u << lane) - 1))] = t | (full ? kFullTile : 0);
        n += __popc(ballot);
      }
      if (lane == 0) n_tiles_shared = n;
    }
    __syncthreads();
    n_tiles = n_tiles_shared;
  }

  // K/V tile i of the CTA's list into ring stage `stage` (16-byte cp.async,
  // rows at or past Lk zero-filled), as one commit group.
  auto load_kv = [&](int i, int stage) {
    if (i < n_tiles) {
      const int kb0 = (kTensorMask ? tiles[i] & ~kFullTile : t0 + i) * kBK;
      const uint32_t kd = smem_addr(ks + stage * kTile), vd = smem_addr(vs + stage * kTile);
      for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
        const int r = idx / kChunks, c = idx - r * kChunks;
        const bool valid = kb0 + r < a.lk;
        const long long row = valid ? kb0 + r : 0;
        cp_async16(kd + core_offset<kBK>(r, c), kp + row * a.k_sl + c * 8, valid);
        cp_async16(vd + core_offset<kBK>(r, c), vp + row * a.v_sl + c * 8, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_kv(s, s);

  // The q tile, rotated as it is read when a rope table is given.
  const float* cs = a.cos != nullptr ? a.cos + b * a.rope_sb : nullptr;
  const float* sn = a.sin != nullptr ? a.sin + b * a.rope_sb : nullptr;
  for (int idx = tid; idx < kBQ * kHalfChunks; idx += kThreads) {
    const int r = idx / kHalfChunks, c = idx - r * kHalfChunks;
    const int row = q0 + r;
    uint4 x1 = make_uint4(0, 0, 0, 0), x2 = x1;
    if (row < a.lq) {
      const __nv_bfloat16* p = qp + row * a.q_sl;
      x1 = *reinterpret_cast<const uint4*>(p + c * 8);
      x2 = *reinterpret_cast<const uint4*>(p + D / 2 + c * 8);
      if (cs != nullptr) rotate8(x1, x2, cs + row * (D / 2) + c * 8, sn + row * (D / 2) + c * 8);
    }
    *reinterpret_cast<uint4*>(qs + core_offset<kBQ>(r, c)) = x1;
    *reinterpret_cast<uint4*>(qs + core_offset<kBQ>(r, c + kHalfChunks)) = x2;
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};
  const int r_lo = warp * 16 + g;  // this thread's rows r_lo and r_lo + 8 (warpgroup warp / 4)
  const int qi[2] = {q0 + r_lo, q0 + r_lo + 8};
  const uint32_t q_addr = smem_addr(qs) + (warp / 4) * (kBK / 8) * 128;  // this warpgroup's rows

  // S = Q K^T of tile i into s: head_dim/16 k-steps; a k-step spans two
  // column chunks. Issued and committed; the caller waits.
  float s[32];
  auto issue_qk = [&](int i) {
    const uint32_t k_addr = smem_addr(ks + (i % kStages) * kTile);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      wgmma_ss_n64(s, make_desc(q_addr + kc * 2 * kBQ * 16, kBQ * 16, 128),
                   make_desc(k_addr + kc * 2 * kBK * 16, kBK * 16, 128), kc > 0);
    }
    wgmma_commit();
  };
  // Tile i has landed for every thread, and every thread is done with tile i - 1.
  auto tile_ready = [&]() {
    cp_async_wait<kStages - 3>();
    fence_async_smem();
    __syncthreads();
  };
  // With a single q block and no head sharing a KV head, each key tile meets
  // one CTA, so the keys are rotated here, in shared memory, as each tile
  // lands (still once per token); otherwise the pre-pass has rotated them
  // (a.k_rot is then set).
  const bool rope_k = cs != nullptr && a.k_rot == nullptr;
  auto rope_tile = [&](int i) {
    if (!rope_k) return;
    const int kb0 = (kTensorMask ? tiles[i] & ~kFullTile : t0 + i) * kBK;
    unsigned char* kt = ks + (i % kStages) * kTile;
    for (int idx = tid; idx < kBK * kHalfChunks; idx += kThreads) {
      const int r = idx / kHalfChunks, c = idx - r * kHalfChunks;
      if (kb0 + r >= a.lk) continue;
      uint4* p1 = reinterpret_cast<uint4*>(kt + core_offset<kBK>(r, c));
      uint4* p2 = reinterpret_cast<uint4*>(kt + core_offset<kBK>(r, c + kHalfChunks));
      uint4 x1 = *p1, x2 = *p2;
      const long long t = static_cast<long long>(kb0 + r) * (D / 2) + c * 8;
      rotate8(x1, x2, cs + t, sn + t);
      *p1 = x1;
      *p2 = x2;
    }
    fence_async_smem();
    __syncthreads();
  };

  // Mask and online softmax (base 2) of the scores of tile i in s, on this
  // thread's fragment: rows r_lo (regs 0, 1 of each n8 chunk j) and r_lo + 8
  // (regs 2, 3). Leaves p in s and the factors for o in corr.
  float corr[2];
  // Per row, the end of its valid keys: k_hi, clipped by the causal diagonal.
  int hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) hi[r] = a.causal ? min(k_hi, qi[r] + offset + 1) : k_hi;
  auto softmax = [&](int i) {
    const int kb0 = (kTensorMask ? tiles[i] & ~kFullTile : t0 + i) * kBK;
    const bool mask_full = !kTensorMask || (tiles[i] & kFullTile) != 0;
    float mx[2] = {-INFINITY, -INFINITY};
    if (mask_full && kb0 >= k_lo && kb0 + kBK <= min(hi[0], hi[1])) {  // every key valid
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    } else {  // branch-free masks
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = kb0 + j * 8 + tig * 2 + (c & 1);
          bool ok = (kk >= k_lo) & (kk < hi[c >> 1]);
          if (kTensorMask) ok &= mk[kk] != 0;
          const float x = ok ? s[j * 4 + c] : -INFINITY;
          s[j * 4 + c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      }
    }
    // The running max is kept in scaled (base-2) units; p = 2^(s * scale - m),
    // one fma and one ex2 per score.
    float neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r] * a.scale_log2);
      corr[r] = m_new == -INFINITY ? 1.f : fast_exp2(m_row[r] - m_new);
      m_row[r] = m_new;
      neg_m[r] = m_new == -INFINITY ? 0.f : -m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p = fast_exp2(fmaf(s[j * 4 + c], a.scale_log2, neg_m[r]));
        s[j * 4 + c] = p;
        rs[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_row[r] = l_row[r] * corr[r] + rs[r];
    }
  };
  // p rounded to bf16 as the A fragments of PV's four k16 steps.
  uint32_t pa[kBK / 16][4];
  auto pack_p = [&]() {
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      pa[kc][0] = pack_pair(s[8 * kc + 0], s[8 * kc + 1]);
      pa[kc][1] = pack_pair(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack_pair(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack_pair(s[8 * kc + 6], s[8 * kc + 7]);
    }
    fence_regs(s);  // the reads of s stay before the next QK, which overwrites it
  };

  // Each iteration issues QK of tile i + 1 and PV of tile i back to back and
  // waits for both in it, so nothing is in flight across iterations; the
  // softmax of tile i + 1 runs on the CUDA cores while PV of tile i runs.
  if (n_tiles > 0) {
    tile_ready();
    rope_tile(0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    pack_p();
  }
  // PV of tile i: rescale o by the softmax's factors, then O += P V.
  auto issue_pv = [&](int i) {
    const uint32_t v_addr = smem_addr(vs + (i % kStages) * kTile);
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      wgmma_pv<D>(o, pa[kc], make_desc(v_addr + kc * 2 * 128, 128, kBK * 16));
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n * 4 + c] *= corr[c >> 1];
    }
    fence_regs(o);  // the rescale stays before the wgmmas are issued
  };
  // The last tile is peeled off, so every wgmma is issued unconditionally.
  for (int i = 0; i + 1 < n_tiles; ++i) {
    rescale_o();
    tile_ready();  // tile i + 1 in place; the ring stage of tile i - 1 takes tile i + kStages - 1
    load_kv(i + kStages - 1, (i + kStages - 1) % kStages);
    rope_tile(i + 1);
    wgmma_fence();
    issue_qk(i + 1);
    issue_pv(i);
    wgmma_commit();
    wgmma_wait<1>();  // QK of tile i + 1 is done; PV of tile i runs on
    fence_regs(s);
    softmax(i + 1);
    wgmma_wait<0>();
    fence_regs(o);
    pack_p();
  }
  if (n_tiles > 0) {
    rescale_o();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.lq) continue;
    const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
    __nv_bfloat16* orow = op + qi[r] * a.o_sl;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tig * 2) = pack_pair(o[n * 4 + 2 * r] * inv, o[n * 4 + 2 * r + 1] * inv);
    }
  }
}

template <int D, bool kTensorMask, int kWG>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kWG + 2 * kStages) * kBK * D * 2 +
         (kTensorMask ? kMaxTiles * sizeof(int) + kMaxKeys : 0);
}

template <int D, bool kTensorMask, int kWG>
cudaError_t launch_masked(const FlashArgs& a, cudaStream_t stream) {
  // Once per instance: the largest dynamic shared memory it may take.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<D, kTensorMask, kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D, kTensorMask, kWG>()));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + kBK * kWG - 1) / (kBK * kWG), a.heads, a.batch);
  FlashArgs args = a;
  args.k_rot = nullptr;  // the kernel rotates the keys itself: one CTA meets each key tile
  if (a.cos != nullptr && (grid.x > 1 || a.heads != a.kv_heads)) {  // rotate the keys once into the scratch, then read them from there
    const long long threads = static_cast<long long>(a.batch) * a.kv_heads * a.lk * (D / 16);
    rope_keys_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        a, static_cast<__nv_bfloat16*>(a.k_rot));
    args.k = args.k_rot = a.k_rot;
    args.k_sl = D;
    args.k_sh = static_cast<long long>(a.lk) * D;
    args.k_sb = args.k_sh * a.kv_heads;
  }
  // Launch with what this call needs: the tensor mask's bytes up to the last tile.
  const size_t smem = smem_bytes<D, false, kWG>() +
                      (kTensorMask ? kMaxTiles * sizeof(int) + (a.lk + kBK - 1) / kBK * kBK : 0);
  flash_kernel<D, kTensorMask, kWG><<<grid, 128 * kWG, smem, stream>>>(args);
  return cudaGetLastError();
}

// Whether the Hopper instances take this call: bf16 at head_dim 80 or 128,
// 16-byte aligned q/k/v rows, a tensor mask that fits shared memory, and the
// keys' scratch when rope is on. Anything else runs the general kernel above.
bool takes(const FlashArgs& a) {
  if (a.dtype != 1 || (a.head_dim != 80 && a.head_dim != 128)) return false;
  if (a.mask != nullptr && a.lk > kMaxKeys) return false;
  if (a.cos != nullptr && a.k_rot == nullptr) return false;
  const long long strides[] = {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl, a.v_sb, a.v_sh, a.v_sl};
  for (long long s : strides) {
    if (s % 8 != 0) return false;
  }
  const uintptr_t ptrs[] = {reinterpret_cast<uintptr_t>(a.q), reinterpret_cast<uintptr_t>(a.k),
                            reinterpret_cast<uintptr_t>(a.v), reinterpret_cast<uintptr_t>(a.k_rot)};
  for (uintptr_t p : ptrs) {
    if (p % 16 != 0) return false;
  }
  return a.o_sl % 2 == 0 && a.o_sh % 2 == 0 && a.o_sb % 2 == 0 && reinterpret_cast<uintptr_t>(a.o) % 4 == 0;
}

template <int D, int kWG>
cudaError_t launch_wg(const FlashArgs& a, cudaStream_t stream) {
  return a.mask != nullptr ? launch_masked<D, true, kWG>(a, stream) : launch_masked<D, false, kWG>(a, stream);
}

// Three warpgroups (192 query rows) share each K/V tile when the query is
// long enough to fill them; a 64-row query (the 2.5 window layers) takes one.
template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  return a.lq > kBK ? launch_wg<D, 3>(a, stream) : launch_wg<D, 1>(a, stream);
}

}  // namespace sm90

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Shapes,
// strides and types are validated by the Python wrapper.
extern "C" int owc_flash_attention(const FlashArgs* args, void* stream) {
  const FlashArgs a = *args;
  if (a.heads <= 0 || a.kv_heads <= 0 || a.heads % a.kv_heads != 0) return cudaErrorInvalidValue;
  if (a.batch == 0 || a.lq == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sm90::takes(a)) return a.head_dim == 80 ? sm90::launch<80>(a, s) : sm90::launch<128>(a, s);
  if (a.dtype == 1) return dispatch_head_dim<__nv_bfloat16>(a, s);
  if (a.dtype == 0) return dispatch_head_dim<float>(a, s);
  return cudaErrorInvalidValue;
}

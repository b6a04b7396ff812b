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
// Three designs. The bf16 instances at head_dim 64, 72 and 88 (without
// rope), 80, 96 and 128 (every bf16 main-path shape: the CLIP-L towers of
// LLaVA and Phi-3, InternViT-300M, the SigLIP towers of LLaVA-OneVision and
// Idefics2, BLIP ViT-g of InstructBLIP, the decoders' prefill) are the Hopper
// kernel of namespace sm90 below: a cp.async ring of K/V stages, wgmma for
// both products, rope once per token. Every f32 call runs the kernel of
// namespace tf32: both products on mma.sync m16n8k8 tf32 tiles with each
// operand split in two (3xTF32, f32 accuracy), cp.async double buffering,
// 16 to 64 query rows per CTA as the query needs. The general kernel serves
// the rest of bf16: head_dims 16 and 32, 72 and 88 with rope, and views whose
// rows are not 16-byte aligned, at every head_dim: the two products run on
// mma.sync m16n8k16 bf16 tiles with f32 accumulation, synchronous loads, rope
// per tile. The bf16 kernels lay a head_dim of 72
// out as 80 columns in shared memory (tile_cols), and 88 as 96, the columns
// past head_dim zero, so the QK product steps 16 columns at a time over them;
// the output keeps its 72 or 88 columns. In all three, the
// score tile never leaves registers (its accumulator fragments are re-packed
// as the A operand of the PV product); blocks that the causal diagonal or the
// (start, end) key range exclude are skipped, and with a tensor mask the bf16
// kernels (each its own template instance) skip tiles with no valid key
// before their loads.
// Left for later work: TMA, warp specialisation, overlapping one tile's
// softmax with the next tile's products.
//
// Numerics: scores in f32, scaled by scale*log2(e) in f32, online softmax in
// base 2. In bf16, p is rounded to the input type for the PV product (as the
// TPU kernel does); the running sum uses the f32 p. Rope rotates in f32 and
// rounds once to the input type. A query row with no valid key writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


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
  const int* mask_run;  // [B, Lk] int32 contiguous, nonzero = attend, one contiguous run per row, or null
  const int* mask;      // [B, Lk] int32 contiguous, nonzero = attend, any pattern, or null (exclusive with mask_run)
  const float* cos;    // [B or 1, L, D/2] f32 contiguous, or null (no rope)
  const float* sin;
  long long rope_sb;   // batch stride of cos/sin in elements (0 broadcasts one table)
  int batch, heads, kv_heads, lq, lk, head_dim, causal, dtype;  // dtype: 0 f32, 1 bf16
  float scale_log2;    // softmax scale * log2(e)
  void* k_rot;         // bf16 scratch [B, KVH, Lk, D] for the rotated keys (rope), or null
  int warpgroups;      // the Hopper instances' warpgroups per CTA; 0: chosen by the query length
};

namespace {

constexpr int kBQ = 64;        // query rows per CTA (16 per warp)
constexpr int kBK = 64;        // keys per k block
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // shared-memory row padding (elements): no bank conflicts

// Columns of a q/k/v tile in shared memory: head_dim rounded up to the
// m16n8k16 depth of 16. At head_dim 72 (SigLIP) the QK product runs over
// 80 columns, and at 88 (BLIP ViT-g) over 96, the last 8 zero-filled, so they
// add nothing to the scores; the PV product and the output stay at 72 or 88
// columns (9 or 11 n8 tiles). The other head dims are multiples of 16 and
// keep their layout.
__host__ __device__ constexpr int tile_cols(int d) { return (d + 15) / 16 * 16; }

using bf16 = __nv_bfloat16;

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

// The (start, end) run of valid keys of one row of a [B, Lk] int32 mask that
// holds one contiguous run of nonzero entries: its first nonzero index, and
// that plus the count of nonzero entries; (0, 0) for a row with none. Every
// thread of the CTA calls it (two barriers); each reads Lk / blockDim
// entries, kLoads at a time, so a caller's mask needs no pass of its own
// before the launch. The general kernel takes one load at a time: the
// batched loads, inlined, changed that kernel's code and made its calls a
// third slower on the card.
template <int kLoads>
__device__ __forceinline__ int2 row_run(const int* mrow, int lk) {
  __shared__ int red[2];  // the first nonzero index, the count
  if (threadIdx.x == 0) {
    red[0] = lk;
    red[1] = 0;
  }
  __syncthreads();
  int first = lk, count = 0;
  for (int base = threadIdx.x; base < lk; base += kLoads * blockDim.x) {
    int m[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) m[j] = base + j * blockDim.x < lk ? mrow[base + j * blockDim.x] : 0;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (m[j] != 0) {
        first = min(first, base + j * static_cast<int>(blockDim.x));
        ++count;
      }
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  count = __reduce_add_sync(0xffffffffu, count);
  if (threadIdx.x % 32 == 0) {
    atomicMin(&red[0], first);
    atomicAdd(&red[1], count);
  }
  __syncthreads();
  const int start = red[1] > 0 ? red[0] : 0;
  return make_int2(start, start + red[1]);
}

// Copies token rows [row0, row0 + kRows) of one head into shared memory
// [kRows][tile_cols(D) + kPad], zero-filling rows at or past `nrows`. With `cos` set, the
// pair (i, i + D/2) of each row is rotated by the rope table in f32.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride, int row0,
                                          int nrows, const float* cos, const float* sin) {
  constexpr int kHalf = D / 2;
  constexpr int kLd = tile_cols(D) + kPad;
  if constexpr (tile_cols(D) != D) {  // zero the columns past head_dim (QK reads them)
    constexpr int kTail = tile_cols(D) - D;
    for (int idx = threadIdx.x; idx < kRows * kTail; idx += kThreads)
      dst[(idx / kTail) * kLd + D + idx % kTail] = __float2bfloat16(0.f);
  }
  for (int idx = threadIdx.x; idx < kRows * kHalf; idx += kThreads) {
    const int r = idx / kHalf;
    const int i = idx - r * kHalf;
    const int row = row0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (row < nrows) {
      const bf16* p = src + row * row_stride;
      x1 = __bfloat162float(p[i]);
      x2 = __bfloat162float(p[i + kHalf]);
      if (cos != nullptr) {
        const long long t = (long long)row * kHalf + i;
        const float c = cos[t], s = sin[t];
        const float y1 = x1 * c - x2 * s;
        const float y2 = x2 * c + x1 * s;
        x1 = y1;
        x2 = y2;
      }
    }
    dst[r * kLd + i] = __float2bfloat16(x1);
    dst[r * kLd + i + kHalf] = __float2bfloat16(x2);
  }
}

// Scores s[j][c] of this warp's 16 rows against the 64 keys of the tile, in the
// m16n8 accumulator layout: row g (+8 for c >= 2), key j*8 + 2*tig + (c & 1).
template <int D>
__device__ __forceinline__ void qk(float (&s)[kBK / 8][4], const __nv_bfloat16* qs,
                                   const __nv_bfloat16* ks, int r_lo, int g, int tig) {
  constexpr int kLd = tile_cols(D) + kPad;
#pragma unroll
  for (int kc = 0; kc < tile_cols(D) / 16; ++kc) {
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

// o[n][c] += p @ V for this warp's 16 rows: row g (+8 for c >= 2), dim
// n*8 + 2*tig + (c & 1), with the score accumulators re-packed as the A operand.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[kBK / 8][4],
                                   const __nv_bfloat16* vs, int g, int tig) {
  constexpr int kLd = tile_cols(D) + kPad;
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

template <int D, bool kTensorMask>
__global__ void __launch_bounds__(kThreads) flash_kernel(const FlashArgs a) {
  constexpr int kLd = tile_cols(D) + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * kLd;
  bf16* vs = ks + kBK * kLd;
  __shared__ int mask_tile[kBK];  // the k tile's entries of a tensor mask

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qb * kBQ;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  bf16* op = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* cs = a.cos != nullptr ? a.cos + b * a.rope_sb : nullptr;
  const float* sn = a.sin != nullptr ? a.sin + b * a.rope_sb : nullptr;
  const int* mrow = kTensorMask ? a.mask + static_cast<long long>(b) * a.lk : nullptr;

  // Valid keys of this CTA: the row's (start, end) run, clipped by the causal
  // diagonal (aligned to the sequence end) of the block's last query row.
  int k_lo = 0, k_hi = a.lk;
  if (a.mask_run != nullptr) {
    const int2 run = row_run<1>(a.mask_run + static_cast<long long>(b) * a.lk, a.lk);
    k_lo = run.x;
    k_hi = run.y;
  }
  const int offset = a.lk - a.lq;
  if (a.causal) k_hi = min(k_hi, min(q0 + kBQ, a.lq) + offset);

  load_tile<D, kBQ>(qs, qp, a.q_sl, q0, a.lq, cs, sn);

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
    load_tile<D, kBK>(ks, kp, a.k_sl, kb0, a.lk, cs, sn);
    load_tile<D, kBK>(vs, vp, a.v_sl, kb0, a.lk, nullptr, nullptr);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    qk<D>(s, qs, ks, r_lo, g, tig);

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
    pv<D>(o, s, vs, g, tig);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.lq) continue;
    const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
    bf16* orow = op + qi[r] * a.o_sl;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      orow[n * 8 + tig * 2] = __float2bfloat16(o[n][2 * r] * inv);
      orow[n * 8 + tig * 2 + 1] = __float2bfloat16(o[n][2 * r + 1] * inv);
    }
  }
}

template <int D, bool kTensorMask>
cudaError_t launch_masked(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(kBQ + 2 * kBK) * (tile_cols(D) + kPad) * sizeof(bf16);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance
      flash_kernel<D, kTensorMask>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + kBQ - 1) / kBQ, a.heads, a.batch);
  flash_kernel<D, kTensorMask><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  return a.mask != nullptr ? launch_masked<D, true>(a, stream) : launch_masked<D, false>(a, stream);
}

// The general bf16 kernel at every head_dim the wrapper takes.
cudaError_t dispatch_head_dim(const FlashArgs& a, cudaStream_t stream) {
  switch (a.head_dim) {
    case 16: return launch<16>(a, stream);
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 72: return launch<72>(a, stream);
    case 80: return launch<80>(a, stream);
    case 88: return launch<88>(a, stream);
    case 96: return launch<96>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ============================================================================
// The Hopper design of the bf16 instances at head_dim 64, 72, 80, 88, 96 and 128.
//
// Head_dim 72: its q, k and v rows are nine 16-byte chunks; the q and k
// tiles are 80 columns wide, their tenth chunk zero-filled (cp.async with no
// source bytes), so QK takes 5 k-steps of 16; V keeps its nine chunks and PV
// runs m64n72 (N only has to be a multiple of 8), 36 accumulators a thread,
// none dead. Head_dim 88 the same way: eleven chunks, q and k 96 wide with a
// zero-filled twelfth, QK in 6 k-steps, PV m64n88. takes() sends neither rope
// (72 / 2 and 88 / 2 are not whole numbers of 16-byte chunks). Head_dim 96
// (Phi-3-mini's decoder) fills its twelve chunks: QK takes 6 k-steps, PV the
// m64n96 product with every column stored, and rope runs as at 80 and 128.
// Head_dim 64 (the CLIP-L towers, InternViT-300M) fills eight chunks: QK
// takes 4 k-steps, PV the m64n64 product (32 accumulators a thread), and rope
// runs on its 32-column halves, four chunks each, as at 80 and 128.
//
// The query group is folded into the CTA's rows, as the TPU kernel's grid
// (batch, kv head, group, q block) revisits each K/V block across the group.
// A slot is one (64-row q tile, head of the group) pair, numbered
// q-tile-major (slot = qt * G + gi); a CTA of kWG warpgroups takes kWG
// consecutive slots of one (batch row, KV head), one per warpgroup, so its
// warpgroups are, as a rule, the G heads at the same query rows: they share
// one causal range, and each K/V tile the CTA loads serves all of them. The
// grid is (ceil(ceil(Lq / 64) * G / kWG), KV heads, batch); kWG is 1 for a
// single slot, else 2 or 3, whichever leaves fewer empty slots
// (warpgroups() below). At G = 1 a CTA owns 64 * kWG consecutive rows of one
// head.
//   * Copies: K and V tiles of 64 keys stream through a ring of kStages = 3
//     shared-memory stages with 16-byte cp.async (zero-filled past the end),
//     issued two tiles ahead, so the next tiles load while the current one is
//     multiplied. Each warpgroup reads its own q rows once.
//   * Products: wgmma. S = Q K^T runs m64n64k16 with Q and K both read from
//     shared memory as K-major operands (head_dim/16 steps: 5 at D = 80);
//     O += P V runs m64nDk16 with P re-packed from the S accumulators into
//     bf16 A fragments in registers and V read as an MN-major operand
//     (N = D = 64, 72, 80, 88, 96 or 128, a multiple of 8). Tiles are stored as 8x8
//     core matrices (no swizzle: 160-byte rows do not fit the 128-byte
//     pattern; at head_dim 64, whose rows are 128 bytes, the same layout), so
//     the same layout is K-major for Q and K and MN-major for V.
//   * Rope, once per token: the q rows are rotated in f32 as they are read
//     (once per query token and head); the keys by a pre-pass
//     kernel (rope_keys_kernel) into a scratch [B, KVH, Lk, D] the wrapper
//     allocates, once per key token and KV head, instead of once per CTA;
//     with one CTA per (batch row, KV head) (the 2.5 window layers) the
//     kernel rotates each key tile in shared memory as it lands instead,
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
//   * Masks: the (start, end) run and the causal diagonal of the CTA's last
//     q tile clip the CTA's tile range, the union of its warpgroups' ranges;
//     a warpgroup skips QK, softmax and PV of the tiles past its own
//     diagonal (its products run in a loop of its own, the barriers of the
//     tiles it skips in a second one), which is exact: a wholly masked tile
//     would leave m, l and o as they are. A contiguous mask comes as its
//     [B, Lk] rows, each CTA reducing its row to the (start, end) run. The [B, Lk] tensor mask is copied to shared memory once
//     per CTA as bytes, only its tiles with a valid key enter the pipeline,
//     and those with every key valid skip the per-score mask.
// The shared-memory attribute is set once per template instance.

namespace sm90 {

constexpr int kBK = 64;        // keys per tile; query rows per warpgroup (wgmma M)
constexpr int kStages = 3;     // K/V ring depth (deeper rings measured no faster)
constexpr int kMaxKeys = 16384;  // tensor-mask rows staged in shared memory
constexpr int kMaxTiles = kMaxKeys / kBK;
constexpr int kFullTile = 1 << 30;  // tensor-mask tile list: every key of the tile is valid

// K/V ring stages a launch allocates: kStages, or as many as the keys have
// tiles when that is fewer (a short prompt's CTA then takes less shared
// memory, and more CTAs share an SM). No CTA meets more tiles than that, so
// tile i always lands in stage i % kStages < the allocated count.
__host__ __device__ constexpr int ring_stages(int lk) {
  return lk <= kBK ? 1 : lk <= 2 * kBK ? 2 : kStages;
}

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
// A CTA-wide barrier that warps may reach at different instructions (the
// warpgroups of the flash kernel meet the barriers of the tiles they skip in
// a loop of their own); __syncthreads() is the aligned form, which may not be.
__device__ __forceinline__ void cta_barrier() { asm volatile("barrier.sync 0;\n" ::: "memory"); }
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

// d (m64n64) += A(64x16, bf16 fragments in registers) * B(16x64), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (m64n72) += A(64x16, bf16 fragments in registers) * B(16x72), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35}, {%36,%37,%38,%39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (m64n80) += A(64x16, bf16 fragments in registers) * B(16x80), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39}, {%40,%41,%42,%43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (m64n88) += A(64x16, bf16 fragments in registers) * B(16x88), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n88(float (&d)[44], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43}, {%44,%45,%46,%47}, %48, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (m64n96) += A(64x16, bf16 fragments in registers) * B(16x96), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}, {%48,%49,%50,%51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n64(o, a, desc_b, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<72>(float (&o)[36], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n72(o, a, desc_b, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<80>(float (&o)[40], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n80(o, a, desc_b, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<88>(float (&o)[44], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n88(o, a, desc_b, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<96>(float (&o)[48], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n96(o, a, desc_b, 1);
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
  constexpr int kCols = tile_cols(D);  // q and k columns in shared memory: 72 -> 80 and 88 -> 96, the last 8 zero
  constexpr int kTile = kBK * kCols * 2;  // bytes of one k or v tile, or of a warpgroup's q rows
  constexpr int kChunks = kCols / 8;  // 16-byte chunks per q or k row in shared memory
  constexpr int kDataChunks = D / 8;  // of which hold data (the rest are zero-filled); every v chunk
  constexpr int kHalfChunks = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  // Ring stage s holds its K tile at ks + 2 * s * kTile and its V tile right
  // after (vs = ks + kTile), at fixed offsets however many stages a launch
  // allocates (ring_stages).
  unsigned char* ks = smem + kWG * kTile;
  unsigned char* vs = ks + kTile;
  int* tiles = reinterpret_cast<int*>(ks + 2 * ring_stages(a.lk) * kTile);     // tensor mask only
  unsigned char* mk = reinterpret_cast<unsigned char*>(tiles + kMaxTiles);     // tensor mask only
  __shared__ int n_tiles_shared;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wg = warp / 4, wtid = tid % 128;  // this thread's warpgroup, and its index there
  // This warpgroup's slot: (64-row q tile qt, head gi of the group), numbered
  // q-tile-major; the CTA takes kWG consecutive slots of one (b, kv head).
  const int group = a.heads / a.kv_heads;
  const int n_slots = (a.lq + kBK - 1) / kBK * group;
  const int slot = blockIdx.x * kWG + wg;
  const bool wg_live = slot < n_slots;  // the last CTA's trailing warpgroups may have no slot
  const int h = kvh * group + slot % group;
  const int q0 = slot / group * kBK;  // this warpgroup's first query row

  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Valid keys: the row's (start, end) run; per warpgroup (wg_hi), clipped by
  // the causal diagonal (aligned to the sequence end) of its last query row,
  // and for the CTA (cta_hi), the union: the last live slot's, whose q tile
  // is the CTA's last.
  int k_lo = 0, k_hi = a.lk;
  if (a.mask_run != nullptr) {
    const int2 run = row_run<8>(a.mask_run + static_cast<long long>(b) * a.lk, a.lk);
    k_lo = run.x;
    k_hi = run.y;
  }
  const int offset = a.lk - a.lq;
  const int last_q0 = (min(static_cast<int>(blockIdx.x) * kWG + kWG, n_slots) - 1) / group * kBK;
  const int wg_hi = a.causal ? min(k_hi, min(q0 + kBK, a.lq) + offset) : k_hi;
  const int cta_hi = a.causal ? min(k_hi, min(last_q0 + kBK, a.lq) + offset) : k_hi;
  const int t0 = k_lo / kBK;
  const int t_end = cta_hi > k_lo ? (cta_hi + kBK - 1) / kBK : t0;

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
  auto tile_kb0 = [&](int i) { return (kTensorMask ? tiles[i] & ~kFullTile : t0 + i) * kBK; };
  // This warpgroup's tiles: a prefix of the CTA's list, those that start
  // before its valid keys end (the rest lie past its causal diagonal). A
  // warpgroup skips the products and the softmax of every later tile: with
  // every key masked they would leave m, l and o as they are.
  int n_wg = wg_live && wg_hi > k_lo ? n_tiles : 0;
  while (n_wg > 0 && tile_kb0(n_wg - 1) >= wg_hi) --n_wg;

  // K/V tile i of the CTA's list into ring stage `stage` (16-byte cp.async,
  // rows at or past Lk zero-filled), as one commit group.
  auto load_kv = [&](int i, int stage) {
    if (i < n_tiles) {
      const int kb0 = tile_kb0(i);
      const uint32_t kd = smem_addr(ks + 2 * stage * kTile), vd = smem_addr(vs + 2 * stage * kTile);
      for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
        const int r = idx / kChunks, c = idx - r * kChunks;
        const bool valid = kb0 + r < a.lk && c < kDataChunks;
        const long long row = valid ? kb0 + r : 0;
        const int col = valid ? c * 8 : 0;
        cp_async16(kd + core_offset<kBK>(r, c), kp + row * a.k_sl + col, valid);
        if (c < kDataChunks) cp_async16(vd + core_offset<kBK>(r, c), vp + row * a.v_sl + col, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_kv(s, s);

  // This warpgroup's q rows, rotated as they are read when a rope table is
  // given; the rows of a warpgroup with no slot are zero.
  const float* cs = a.cos != nullptr ? a.cos + b * a.rope_sb : nullptr;
  const float* sn = a.sin != nullptr ? a.sin + b * a.rope_sb : nullptr;
  unsigned char* qw = qs + wg * (kBK / 8) * 128;  // row 0 of this warpgroup's 64 in the [kBQ] tile
  if constexpr (kCols == D) {
#pragma unroll
    for (int idx = wtid; idx < kBK * kHalfChunks; idx += 128) {
      const int r = idx / kHalfChunks, c = idx - r * kHalfChunks;
      const int row = q0 + r;
      uint4 x1 = make_uint4(0, 0, 0, 0), x2 = x1;
      if (wg_live && row < a.lq) {
        const __nv_bfloat16* p = qp + row * a.q_sl;
        x1 = *reinterpret_cast<const uint4*>(p + c * 8);
        x2 = *reinterpret_cast<const uint4*>(p + D / 2 + c * 8);
        if (cs != nullptr) rotate8(x1, x2, cs + row * (D / 2) + c * 8, sn + row * (D / 2) + c * 8);
      }
      *reinterpret_cast<uint4*>(qw + core_offset<kBQ>(r, c)) = x1;
      *reinterpret_cast<uint4*>(qw + core_offset<kBQ>(r, c + kHalfChunks)) = x2;
    }
  } else {  // padded columns (takes() sends no rope here): chunks past head_dim are zero
#pragma unroll
    for (int idx = wtid; idx < kBK * kChunks; idx += 128) {
      const int r = idx / kChunks, c = idx - r * kChunks;
      const int row = q0 + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (wg_live && row < a.lq && c < kDataChunks) x = *reinterpret_cast<const uint4*>(qp + row * a.q_sl + c * 8);
      *reinterpret_cast<uint4*>(qw + core_offset<kBQ>(r, c)) = x;
    }
  }

  float o[D / 2];  // PV's accumulator at the true width: no dead columns at 72 and 88
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};
  const int r_lo = (warp % 4) * 16 + g;  // this thread's rows r_lo and r_lo + 8 of its warpgroup's 64
  const int qi[2] = {q0 + r_lo, q0 + r_lo + 8};
  const uint32_t q_addr = smem_addr(qw);  // this warpgroup's rows

  // S = Q K^T of tile i into s: head_dim/16 k-steps; a k-step spans two
  // column chunks. Issued and committed; the caller waits.
  float s[32];
  auto issue_qk = [&](int i) {
    const uint32_t k_addr = smem_addr(ks + 2 * (i % kStages) * kTile);
#pragma unroll
    for (int kc = 0; kc < kCols / 16; ++kc) {
      wgmma_ss_n64(s, make_desc(q_addr + kc * 2 * kBQ * 16, kBQ * 16, 128),
                   make_desc(k_addr + kc * 2 * kBK * 16, kBK * 16, 128), kc > 0);
    }
    wgmma_commit();
  };
  // Tile i has landed for every thread, and every thread is done with tile i - 1.
  auto tile_ready = [&]() {
    cp_async_wait<kStages - 3>();
    fence_async_smem();
    cta_barrier();
  };
  // With one CTA per (batch row, KV head), each key tile meets one CTA, so
  // the keys are rotated here, in shared memory, as each tile lands (still
  // once per token); otherwise the pre-pass has rotated them (a.k_rot is
  // then set).
  const bool rope_k = kCols == D && cs != nullptr && a.k_rot == nullptr;
  auto rope_tile = [&](int i) {
    if (!rope_k) return;
    const int kb0 = tile_kb0(i);
    unsigned char* kt = ks + 2 * (i % kStages) * kTile;
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
    cta_barrier();
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
    const int kb0 = tile_kb0(i);
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
  // Every thread meets each barrier (tile_ready, rope_tile), in the same
  // order; n_wg, which sets where, is the same for a whole warpgroup.
  if (n_tiles > 0) {
    cp_async_wait<1>();  // tile 0 has landed (tile 1 may still be in flight); the q tile is written
    fence_async_smem();
    __syncthreads();
    rope_tile(0);
    if (n_wg > 0) {
      wgmma_fence();
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0);
      pack_p();
    }
  }
  // PV of tile i: rescale o by the softmax's factors, then O += P V.
  auto issue_pv = [&](int i) {
    const uint32_t v_addr = smem_addr(vs + 2 * (i % kStages) * kTile);
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
  // This warpgroup's tiles: QK of tile i + 1 with PV of tile i, then PV of
  // its last tile alone; then only the CTA's barriers and loads for the
  // tiles it skips (the same sequence of them in every warpgroup).
  int i = 0;
  for (; i + 1 < n_wg; ++i) {
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
  if (n_wg > 0) {
    rescale_o();
    wgmma_fence();
    issue_pv(n_wg - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  for (; i + 1 < n_tiles; ++i) {
    tile_ready();
    load_kv(i + kStages - 1, (i + kStages - 1) % kStages);
    rope_tile(i + 1);
  }
  cp_async_wait<0>();

  if (!wg_live) return;
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
constexpr size_t smem_bytes(int ring = kStages) {
  return static_cast<size_t>(kWG + 2 * ring) * kBK * tile_cols(D) * 2 +
         (kTensorMask ? kMaxTiles * sizeof(int) + kMaxKeys : 0);
}

template <int D, bool kTensorMask, int kWG>
cudaError_t launch_masked(const FlashArgs& a, cudaStream_t stream) {
  // Once per instance: the largest dynamic shared memory it may take.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<D, kTensorMask, kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D, kTensorMask, kWG>()));
  if (attr != cudaSuccess) return attr;
  // kWG consecutive (q tile, head of the group) slots per CTA, per (b, kv head).
  const int slots = (a.lq + kBK - 1) / kBK * (a.heads / a.kv_heads);
  const dim3 grid((slots + kWG - 1) / kWG, a.kv_heads, a.batch);
  FlashArgs args = a;
  args.k_rot = nullptr;  // the kernel rotates the keys itself: one CTA meets each key tile
  if (tile_cols(D) == D && a.cos != nullptr && grid.x > 1) {  // rotate the keys once into the scratch, then read them from there
    const long long threads = static_cast<long long>(a.batch) * a.kv_heads * a.lk * (D / 16);
    rope_keys_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        a, static_cast<__nv_bfloat16*>(a.k_rot));
    args.k = args.k_rot = a.k_rot;
    args.k_sl = D;
    args.k_sh = static_cast<long long>(a.lk) * D;
    args.k_sb = args.k_sh * a.kv_heads;
  }
  // Launch with what this call needs: the tensor mask's bytes up to the last tile.
  const size_t smem = smem_bytes<D, false, kWG>(ring_stages(a.lk)) +
                      (kTensorMask ? kMaxTiles * sizeof(int) + (a.lk + kBK - 1) / kBK * kBK : 0);
  flash_kernel<D, kTensorMask, kWG><<<grid, 128 * kWG, smem, stream>>>(args);
  return cudaGetLastError();
}

// Whether the Hopper instances take this call: bf16 at head_dim 72 or 88 (no
// rope), 64, 80, 96 or 128, 16-byte aligned q/k/v rows, a tensor mask that fits
// shared memory, and the keys' scratch when rope is on. Anything else in bf16
// runs the general kernel above. Mirrored by flash_takes_hopper in
// lmms_owc_tpu_torch/ops/attention.py.
bool takes(const FlashArgs& a) {
  if (a.dtype != 1 || (a.head_dim != 64 && a.head_dim != 72 && a.head_dim != 80 && a.head_dim != 88 &&
                       a.head_dim != 96 && a.head_dim != 128))
    return false;
  if (tile_cols(a.head_dim) != a.head_dim && a.cos != nullptr) return false;
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

// Warpgroups per CTA (64 query rows each) for a launch with `group` query
// heads per KV head, over slots = ceil(lq / 64) * group (q tile, head) pairs
// per KV head. A single slot (the 2.5 window layers, a 64-row query per head)
// takes one warpgroup. Otherwise two or three, by the slots each pads to
// (ceil(slots / wg) * wg): up to head_dim 88, whichever pads fewer, three on
// a tie (577 rows at G = 1, CLIP-L/336, run as five CTAs of two where three
// would leave a fourth CTA with one row; 1025, 729 and 257 rows take three);
// at 96 and 128, where either count runs one CTA an SM (registers) and two
// measured 1.2-1.3 times three's time a slot at 320 to 4096 rows
// (chip_smoke.py --flash-wg-probe), two only where they pad to less than
// four fifths of three's slots (Vicuna's 128-row prompts: one CTA of two;
// the judge, Mistral and every longer prefill take three). One warpgroup per
// CTA measured slowest. Mirrored by flash_plan in
// lmms_owc_tpu_torch/ops/attention.py.
int warpgroups(int head_dim, int group, int lq) {
  const int slots = (lq + kBK - 1) / kBK * group;
  if (slots <= 1) return 1;
  const auto padded = [slots](int wg) { return (slots + wg - 1) / wg * wg; };
  return (head_dim >= 96 ? 5 * padded(2) < 4 * padded(3) : padded(2) < padded(3)) ? 2 : 3;
}

// a.warpgroups, when set, overrides the choice (chip_smoke.py's probe).
template <int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  switch (a.warpgroups > 0 ? a.warpgroups : warpgroups(D, a.heads / a.kv_heads, a.lq)) {
    case 1: return launch_wg<D, 1>(a, stream);
    case 2: return launch_wg<D, 2>(a, stream);
    case 3: return launch_wg<D, 3>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90

// ============================================================================
// The f32 instances: both products on the tensor cores at f32 accuracy
// (3xTF32), for every f32 call: MiniLM, the CLIP scorer's towers, rope (K1's
// f32 form), (start, end) runs, the tensor mask, causal, head_dim 16 to 128.
//
//   * Products: mma.sync m16n8k8 tf32 with f32 accumulation. Each operand x
//     splits as hi = tf32(x) (cvt.rna's rounding: half away from zero to 10
//     mantissa bits) and lo = tf32(x - hi); a product is lo*hi + hi*lo +
//     hi*hi, the small terms first, which leaves out lo*lo only (about 2^-22
//     of it, where plain TF32 would keep 2^-11). Operands split as they are
//     read from shared memory (q, k, v) or registers (p).
//   * P from registers: the score accumulator holds columns 2*tig and
//     2*tig + 1 of each 8-key block, the A fragment wants columns tig and
//     tig + 4. The PV product numbers the block's keys in the order 0, 2, 4,
//     6, 1, 3, 5, 7 for both operands (a sum does not care), so a thread's
//     accumulators are its A fragment as they stand and B reads v rows 2*tig
//     and 2*tig + 1: no shuffles, no shared-memory round trip.
//   * Rows: one warp per 16 query rows, 1 to 4 warps per CTA as the query
//     needs (MiniLM's 32 rows take two, CLIP's text tower's 16 one); a warp
//     whose rows all lie past the query skips the products.
//   * Keys: 32-key tiles, double-buffered with 16-byte cp.async (4-byte
//     copies when a view's rows are not 16-byte aligned), past Lk zero-filled;
//     a warp runs only the 8-key blocks that hold a key inside its (start,
//     end) run and causal diagonal, and rows no warp reads are not loaded.
//   * Layout: rows of head_dim + 4 floats, so the fragments' reads (8 rows x
//     4 columns, or 4 row pairs x 8 columns) hit 32 distinct banks.
//   * Rope: q is rotated once per CTA in shared memory, each key tile as it
//     lands, in f32.
//   * Softmax in f32 and base 2 as in the bf16 kernels; p stays f32.
// What bounds it: operations, at a third of the TF32 tensor-core rate.

namespace tf32 {

constexpr int kBK = 32;        // keys per tile
constexpr int kMaxWarps = 4;   // 16 query rows each

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

// cvt.rna.tf32.f32's rounding on the bits: round half away from zero to 10
// mantissa bits (add half a tf32 ulp to the magnitude), the low 13 bits
// cleared, so the result is exactly the float it stands for. Two integer
// operations, where the cvt instruction ran slower.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a(16x8, row-major) * b(8x8, col-major), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment a, split once for the products it takes part in.
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ SplitA(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// d += a * b, b split here (3xTF32): lo*hi + hi*lo + hi*hi.
__device__ __forceinline__ void mma3(float (&d)[4], const SplitA& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, a.lo, bh0, bh1);
  mma(d, a.hi, bl0, bl1);
  mma(d, a.hi, bh0, bh1);
}

template <int D>
constexpr size_t smem_bytes(int warps, bool tensor_mask) {
  return (static_cast<size_t>(4 * kBK + 16 * warps) * (D + 4) + (tensor_mask ? 2 * kBK : 0)) * sizeof(float);
}

template <int D, bool kTensorMask>
__global__ void __launch_bounds__(32 * kMaxWarps) flash_kernel(const FlashArgs a, int vec16) {
  constexpr int kLd = D + 4;       // floats per row in shared memory
  constexpr int kChunks = D / 4;   // 16-byte chunks per row
  constexpr int kHalf = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [2][kBK][kLd]
  float* vs = ks + 2 * kBK * kLd;                  // [2][kBK][kLd]
  float* qs = vs + 2 * kBK * kLd;                  // [16 * warps][kLd]
  const int nthreads = blockDim.x, rows = nthreads / 2;  // 16 query rows per 32-thread warp
  int* mt = reinterpret_cast<int*>(qs + rows * kLd);  // [2][kBK], tensor mask only

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qb * rows;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* cs = a.cos != nullptr ? a.cos + b * a.rope_sb : nullptr;
  const float* sn = a.sin != nullptr ? a.sin + b * a.rope_sb : nullptr;
  const int* mrow = kTensorMask ? a.mask + static_cast<long long>(b) * a.lk : nullptr;

  // Valid keys of the CTA, and of this warp: the row's (start, end) run,
  // clipped by the causal diagonal (aligned to the sequence end) of the last
  // query row of the CTA and of the warp.
  int k_lo = 0, k_hi = a.lk;
  if (a.mask_run != nullptr) {
    const int2 run = row_run<8>(a.mask_run + static_cast<long long>(b) * a.lk, a.lk);
    k_lo = run.x;
    k_hi = run.y;
  }
  const int offset = a.lk - a.lq;
  const int w0 = q0 + warp * 16;
  int w_hi = k_hi;
  if (a.causal) {
    k_hi = min(k_hi, min(q0 + rows, a.lq) + offset);
    w_hi = min(w_hi, min(w0 + 16, a.lq) + offset);
  }
  const bool warp_rows = w0 < a.lq;
  const int r_lo = warp * 16 + g;  // tile rows r_lo and r_lo + 8
  const int qi[2] = {q0 + r_lo, q0 + r_lo + 8};

  // Rows [r0, r1) of a [*][kLd] tile from rows row0 + r of src (zero past
  // `limit`), one 16-byte chunk per thread and step; one commit group is the caller's.
  auto copy_rows = [&](float* dst, const float* src, long long stride, int row0, int r0, int r1, int limit) {
    for (int idx = tid; idx < (r1 - r0) * kChunks; idx += nthreads) {
      const int r = r0 + idx / kChunks, c = idx % kChunks;
      const bool valid = row0 + r < limit;
      const float* from = valid ? src + static_cast<long long>(row0 + r) * stride + c * 4 : src;
      const uint32_t to = sm90::smem_addr(dst + r * kLd + c * 4);
      if (vec16) {
        sm90::cp_async16(to, from, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(to + 4 * e, valid ? from + e : from, valid);
      }
    }
  };
  // The K/V tile at key kb0 into stage st: the rows some warp reads, those
  // of the 8-key blocks that meet [k_lo, k_hi).
  const int t_first = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - t_first + kBK - 1) / kBK : 0;
  auto load_kv = [&](int kb0, int st) {
    const int r0 = max(k_lo - kb0, 0) & ~7, r1 = min(k_hi - kb0 + 7, kBK) & ~7;
    copy_rows(ks + st * kBK * kLd, kp, a.k_sl, kb0, r0, r1, a.lk);
    copy_rows(vs + st * kBK * kLd, vp, a.v_sl, kb0, r0, r1, a.lk);
    if (kTensorMask) {
      for (int i = tid; i < kBK; i += nthreads)
        cp_async4(sm90::smem_addr(mt + st * kBK + i), kb0 + i < a.lk ? mrow + kb0 + i : mrow, kb0 + i < a.lk);
    }
    sm90::cp_async_commit();
  };
  // Rope on rows [r0, r1) of a tile whose row r holds position pos0 + r (< limit).
  auto rope_rows = [&](float* t, int pos0, int r0, int r1, int limit) {
    for (int idx = tid; idx < (r1 - r0) * kHalf; idx += nthreads) {
      const int r = r0 + idx / kHalf, i = idx % kHalf;
      if (pos0 + r >= limit) continue;
      const long long at = static_cast<long long>(pos0 + r) * kHalf + i;
      const float c = cs[at], s = sn[at];
      const float x1 = t[r * kLd + i], x2 = t[r * kLd + i + kHalf];
      t[r * kLd + i] = x1 * c - x2 * s;
      t[r * kLd + i + kHalf] = x2 * c + x1 * s;
    }
  };

  copy_rows(qs, qp, a.q_sl, q0, 0, rows, a.lq);
  sm90::cp_async_commit();
  if (n_tiles > 0) load_kv(t_first, 0);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int kb0 = t_first + i * kBK, st = i & 1;
    if (i + 1 < n_tiles) {
      load_kv(kb0 + kBK, st ^ 1);  // the stage tile i - 1 used; every warp is done with it
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + st * kBK * kLd;
    const float* vt = vs + st * kBK * kLd;
    if (cs != nullptr) {
      if (i == 0) rope_rows(qs, q0, 0, rows, a.lq);
      rope_rows(ks + st * kBK * kLd, kb0, max(k_lo - kb0, 0) & ~7, min(k_hi - kb0 + 7, kBK) & ~7, a.lk);
      __syncthreads();
    }
    // This warp's 8-key blocks [j_lo, j_hi): those that meet [k_lo, w_hi).
    const int j_lo = max(k_lo - kb0, 0) / 8;
    const int j_hi = warp_rows ? (min(max(w_hi - kb0, 0), kBK) + 7) / 8 : 0;
    if (j_lo < j_hi) {
      float s[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 8; ++kc) {
        const float* q_lo = qs + r_lo * kLd + kc * 8 + tig;
        const SplitA qa(q_lo[0], q_lo[8 * kLd], q_lo[4], q_lo[8 * kLd + 4]);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          if (j < j_lo || j >= j_hi) continue;
          const float* kr = kt + (j * 8 + g) * kLd + kc * 8 + tig;
          mma3(s[j], qa, kr[0], kr[4]);
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = kb0 + j * 8 + tig * 2 + (c & 1);
          const bool ok = j >= j_lo && j < j_hi && kk >= k_lo && kk < k_hi &&
                          (!a.causal || kk <= qi[c >> 1] + offset) &&
                          (!kTensorMask || mt[st * kBK + kk - kb0] != 0);
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
      // O += P V, the block's keys in the order 0, 2, 4, 6, 1, 3, 5, 7.
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        if (j < j_lo || j >= j_hi) continue;
        const SplitA pa(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* v0 = vt + (j * 8 + 2 * tig) * kLd + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) mma3(o[n], pa, v0[n * 8], v0[kLd + n * 8]);
      }
    }
    __syncthreads();  // every warp is done with stage st before tile i + 2 lands there
  }
  sm90::cp_async_wait<0>();  // nothing in flight at exit (no tile: the q rows' group)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.lq) continue;
    const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
    float* orow = op + qi[r] * a.o_sl;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      orow[n * 8 + tig * 2] = o[n][2 * r] * inv;
      orow[n * 8 + tig * 2 + 1] = o[n][2 * r + 1] * inv;
    }
  }
}

template <int D, bool kTensorMask>
cudaError_t launch_masked(const FlashArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance: the largest CTA
      flash_kernel<D, kTensorMask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>(kMaxWarps, kTensorMask)));
  if (attr != cudaSuccess) return attr;
  const int warps = a.lq < 16 * kMaxWarps ? (a.lq + 15) / 16 : kMaxWarps;
  const dim3 grid((a.lq + 16 * warps - 1) / (16 * warps), a.heads, a.batch);
  // 16-byte copies when every row of q, k and v starts 16-byte aligned.
  const long long strides[] = {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl, a.v_sb, a.v_sh, a.v_sl};
  const uintptr_t ptrs[] = {reinterpret_cast<uintptr_t>(a.q), reinterpret_cast<uintptr_t>(a.k),
                            reinterpret_cast<uintptr_t>(a.v)};
  int vec16 = 1;
  for (long long st : strides) vec16 &= st % 4 == 0;
  for (uintptr_t p : ptrs) vec16 &= p % 16 == 0;
  flash_kernel<D, kTensorMask><<<grid, 32 * warps, smem_bytes<D>(warps, kTensorMask), stream>>>(a, vec16);
  return cudaGetLastError();
}

cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
#define OWC_TF32_CASE(d)                                                                      \
  case d:                                                                                      \
    return a.mask != nullptr ? launch_masked<d, true>(a, stream) : launch_masked<d, false>(a, stream);
  switch (a.head_dim) {
    OWC_TF32_CASE(16)
    OWC_TF32_CASE(32)
    OWC_TF32_CASE(64)
    OWC_TF32_CASE(72)
    OWC_TF32_CASE(80)
    OWC_TF32_CASE(88)
    OWC_TF32_CASE(96)
    OWC_TF32_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef OWC_TF32_CASE
}

}  // namespace tf32

}  // namespace

// The Hopper instance's plan for a launch: out[0] warpgroups per CTA, out[1]
// CTAs per (batch row, KV head). chip_smoke.py holds flash_plan in
// lmms_owc_tpu_torch/ops/attention.py to it.
extern "C" void owc_flash_plan(int heads, int kv_heads, int lq, int head_dim, int* out) {
  const int group = heads / kv_heads;
  out[0] = sm90::warpgroups(head_dim, group, lq);
  out[1] = ((lq + sm90::kBK - 1) / sm90::kBK * group + out[0] - 1) / out[0];
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). Shapes,
// strides and types are validated by the Python wrapper.
extern "C" int owc_flash_attention(const FlashArgs* args, void* stream) {
  const FlashArgs a = *args;
  if (a.heads <= 0 || a.kv_heads <= 0 || a.heads % a.kv_heads != 0) return cudaErrorInvalidValue;
  if (a.batch == 0 || a.lq == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sm90::takes(a)) {
    switch (a.head_dim) {
      case 64: return sm90::launch<64>(a, s);
      case 72: return sm90::launch<72>(a, s);
      case 80: return sm90::launch<80>(a, s);
      case 88: return sm90::launch<88>(a, s);
      case 96: return sm90::launch<96>(a, s);
      default: return sm90::launch<128>(a, s);
    }
  }
  if (a.dtype == 1) return dispatch_head_dim(a, s);
  if (a.dtype == 0) return tf32::launch(a, s);
  return cudaErrorInvalidValue;
}

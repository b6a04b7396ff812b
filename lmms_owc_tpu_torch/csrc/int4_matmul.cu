// Matmul against a packed int4 groupwise-quantized weight, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel _kernel (K4) of lmms_owc_tpu/ops/int4_matmul.py,
// reached through int4_matmul from the int4 branch of dense at decode row
// counts (M <= 256): out[M, N] = x[M, K] @ dequant(q4, scale), with q4 int8
// [N, K/2] in the halves layout (byte j of row n holds input column j in its
// low nibble and column j + K/2 in its high nibble) and scale f32 [N, K/group].
// Numerics follow the TPU kernel: each nibble is sign-extended, multiplied by
// its group scale in f32 and rounded to bf16; x is rounded to bf16; the
// products accumulate in f32; the output is cast to x's type.
//
// What bounds it on the H100: at decode M the weight stream. The weight is half
// a byte per element and each element is used M times, so up to M ~ 100 the
// kernel moves more bytes than it has flops for at the card's ~295 flop/byte
// balance point; the 7B decode reads 2.6 GB of packed weights per step, the
// head (3584 x 152064) 272 MB of it. Streaming at 3.35 TB/s with about a
// microsecond of memory latency takes about 25 KB of weight in flight on each
// of the 132 SMs, and enough CTAs to put it there.
//
// The design, and what each part does about that:
//  1. Split-K from (K, N) alone. Each CTA owns a 64-column N tile (32 where
//     64 would leave the card under one wave), a 16/32/64-row M tile chosen
//     by M, and one split of K: `split_bytes` packed bytes, in whole 128-byte
//     units (one 128-column scale group of each half of x). The plan
//     (int4_split_plan in ops/int4_matmul.py) aims at two waves of CTAs: at
//     M = 8 the q/o and down products run 280 CTAs (5 splits), k/v 224
//     (32-column tiles, 14 splits), gate/up 296 and the head 2376 (1 split),
//     where one split per tile gave 8 (k/v) and 56 (q/o, down). The plan never
//     depends on M, so a row gives the same bits alone or pooled with others.
//  2. A fixed-order reduction. With more than one split each CTA writes its
//     f32 partial to a workspace [splits, M, N]; a second launch adds the
//     partials of each element in split order and casts. No atomics. With one
//     split the CTA writes the output itself.
//  3. Bytes in flight. A 4-stage ring of 16-byte cp.async.cg copies holds,
//     for each k step of 64 packed bytes (128 input columns), the weight tile
//     (4 KB at 64 columns), the step's low and high group scales and the x
//     tile. Three stages are in flight while one is consumed, so a CTA keeps
//     12 KB of weight in flight, and the two CTAs per SM of the plan (up to
//     four fit: 53 KB of shared memory each at M <= 16) about 25 KB; the head
//     (2376 CTAs) runs four per SM, 48 KB. Each step dequantizes its tile
//     from shared memory into registers and into a bf16 [N tile][128 k]
//     staging tile: a nibble becomes a float by an exact bit trick (OR'ed
//     into the mantissa of 2^23, minus 2^23 + 8: no int-to-float conversion
//     instructions), is multiplied by its scale in f32 and rounded to bf16 in
//     pairs.
//  Tensor cores as before: mma.sync m16n8k16 bf16 with f32 accumulators, the
//  A fragments (x) read from the ring slot (bf16 x) or from a bf16 copy of it
//  (f32 x). Left for later work: wgmma with the dequantized weight as a
//  register operand, TMA, and a cluster or one-launch reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Mirrors Int4MatmulArgs in lmms_owc_tpu_torch/ops/_build.py (ctypes.Structure).
struct Int4MatmulArgs {
  const void* x;       // [M, K] contiguous, 16-byte aligned
  const int8_t* q4;    // [N, K/2] contiguous, 16-byte aligned, halves layout
  const float* scale;  // [N, groups] contiguous
  void* out;           // [M, N] contiguous
  float* workspace;    // [splits, M, N] f32 partials when splits > 1, else null
  int m, n, k, groups, dtype;  // dtype of x and out: 0 f32, 1 bf16
  int splits, split_bytes, block_n;  // the split-K plan (int4_split_plan): a function of (K, N) only
};

namespace {

constexpr int kBKP = 64;       // packed bytes per k step
constexpr int kBK = 2 * kBKP;  // input columns per k step (64 low, 64 high)
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kThreads = 128;  // 4 warps
constexpr int kLd = kBK + 8;   // bf16 row stride of the staging and x tiles: no bank conflicts

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// d += a(16x16, row-major) * b(16x8, col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The signed nibble at bit `shift` of a packed word whose nibbles' top bits
// were flipped (w ^ 0x88888888): the float 2^23 + (u ^ 8), minus 2^23 + 8. Exact.
__device__ __forceinline__ float nibble(uint32_t flipped, int shift) {
  return __uint_as_float(((flipped >> shift) & 0xFu) | 0x4B000000u) - 8388616.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of one instance: kStages ring slots of [weight | scales | x],
// then the bf16 weight staging tile, then (f32 x only) the bf16 x tile.
template <typename T, int BM, int BN>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kXLd = kF32 ? kBK + 4 : kLd;  // x row stride in the slot (elements)
  static constexpr int kW = BN * kBKP;               // packed weight bytes
  static constexpr int kS = 2 * BN * 4;              // each row's low and high scale
  static constexpr int kX = BM * kXLd * static_cast<int>(sizeof(T));
  static constexpr int kSlot = kW + kS + kX;
  static constexpr int kBytes = kStages * kSlot + BN * kLd * 2 + (kF32 ? BM * kLd * 2 : 0);
  static_assert(kW % 16 == 0 && kS % 16 == 0 && kX % 16 == 0, "slot parts stay 16-byte aligned");
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads) int4_kernel(const Int4MatmulArgs a) {
  using L = Smem<T, BM, BN>;
  constexpr int kWarpsM = BM >= 64 ? 2 : 1;
  constexpr int kWarpsN = 4 / kWarpsM;
  constexpr int kWM = BM / kWarpsM;  // rows per warp
  constexpr int kWN = BN / kWarpsN;  // columns per warp
  constexpr int kMT = kWM / 16, kNT = kWN / 8;
  constexpr int kVecX = 16 / static_cast<int>(sizeof(T));  // x elements per 16-byte copy
  constexpr int kXChunks = kBK / kVecX;                      // 16-byte copies per x row
  constexpr int kWChunks = BN * kBKP / 16;                   // 16-byte copies per weight tile
  static_assert(kWChunks % kThreads == 0, "the weight tile splits evenly over the threads");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* staging = reinterpret_cast<__nv_bfloat16*>(smem + kStages * L::kSlot);
  __nv_bfloat16* xs16 = staging + BN * kLd;  // f32 x only

  const int k2 = a.k / 2, group = a.k / a.groups;
  const bool ring_scales = group % kBKP == 0;  // a step lies in one group of each half
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int first = split * a.split_bytes / kBKP;
  const int last = min(k2, (split + 1) * a.split_bytes) / kBKP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const T* x = static_cast<const T*>(a.x);

  // Copies k step `step` into ring slot step % kStages: the weight tile as
  // rows of 64 bytes (four 16-byte copies each), the scales of the step's low
  // and high halves, and x's 64 low and 64 high columns (rows past M zeros).
  auto issue = [&](int step) {
    unsigned char* slot = smem + (step % kStages) * L::kSlot;
    const int j0 = step * kBKP;
#pragma unroll
    for (int i = 0; i < kWChunks / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, cc = c & 3;
      cp_async16(slot + r * kBKP + cc * 16, a.q4 + (long long)(n0 + r) * k2 + j0 + cc * 16, 16);
    }
    if (ring_scales && tid < 2 * BN) {
      const int r = tid % BN, h = tid / BN;
      cp_async4(slot + L::kW + (h * BN + r) * 4,
                a.scale + (long long)(n0 + r) * a.groups + (j0 + h * k2) / group);
    }
    T* xslot = reinterpret_cast<T*>(slot + L::kW + L::kS);
    for (int c = tid; c < BM * kXChunks; c += kThreads) {
      const int r = c / kXChunks, col = (c % kXChunks) * kVecX;
      const int src_col = col < kBKP ? j0 + col : k2 + j0 + (col - kBKP);
      const bool ok = m0 + r < a.m;
      cp_async16(xslot + r * L::kXLd + col, x + (long long)(ok ? m0 + r : 0) * a.k + src_col, ok ? 16 : 0);
    }
  };

  // Dequantizes the weight tile of step `step`'s slot into the staging tile:
  // each 16-byte copy (packed bytes jb..jb+15 of row r) gives 16 low-half and
  // 16 high-half bf16 values.
  auto dequantize = [&](int step) {
    const unsigned char* slot = smem + (step % kStages) * L::kSlot;
    const float* sc = reinterpret_cast<const float*>(slot + L::kW);
#pragma unroll
    for (int i = 0; i < kWChunks / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, cc = c & 3;
      const uint4 q = *reinterpret_cast<const uint4*>(slot + r * kBKP + cc * 16);
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
      const int jb = step * kBKP + cc * 16;
      const float* srow = a.scale + (long long)(n0 + r) * a.groups;
      uint32_t lo[8], hi[8];
      if (ring_scales || group % 16 == 0) {
        const float s_lo = ring_scales ? sc[r] : srow[jb / group];
        const float s_hi = ring_scales ? sc[BN + r] : srow[(jb + k2) / group];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const uint32_t f = words[w] ^ 0x88888888u;
          lo[2 * w] = pack_bf16(nibble(f, 0) * s_lo, nibble(f, 8) * s_lo);
          lo[2 * w + 1] = pack_bf16(nibble(f, 16) * s_lo, nibble(f, 24) * s_lo);
          hi[2 * w] = pack_bf16(nibble(f, 4) * s_hi, nibble(f, 12) * s_hi);
          hi[2 * w + 1] = pack_bf16(nibble(f, 20) * s_hi, nibble(f, 28) * s_hi);
        }
      } else {  // groups narrower than 16 columns: a scale per byte
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const uint32_t f = words[w] ^ 0x88888888u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int b0 = jb + 4 * w + 2 * h;
            lo[2 * w + h] = pack_bf16(nibble(f, 16 * h) * srow[b0 / group],
                                      nibble(f, 16 * h + 8) * srow[(b0 + 1) / group]);
            hi[2 * w + h] = pack_bf16(nibble(f, 16 * h + 4) * srow[(b0 + k2) / group],
                                      nibble(f, 16 * h + 12) * srow[(b0 + 1 + k2) / group]);
          }
        }
      }
      uint4* dst_lo = reinterpret_cast<uint4*>(staging + r * kLd + cc * 16);
      dst_lo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dst_lo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      uint4* dst_hi = reinterpret_cast<uint4*>(staging + r * kLd + kBKP + cc * 16);
      dst_hi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dst_hi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    if constexpr (L::kF32) {  // x to bf16 for the A fragments
      const float* xslot = reinterpret_cast<const float*>(slot + L::kW + L::kS);
      for (int e = tid; e < BM * kBK / 2; e += kThreads) {
        const int r = e / (kBK / 2), c = 2 * (e % (kBK / 2));
        *reinterpret_cast<uint32_t*>(xs16 + r * kLd + c) =
            pack_bf16(xslot[r * L::kXLd + c], xslot[r * L::kXLd + c + 1]);
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  // The ring: steps first .. first + kStages - 2 are in flight before the
  // loop; one commit group per step (empty past the split), so step s's
  // group has landed once at most kStages - 2 groups are pending.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (first + i < last) issue(first + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int step = first; step < last; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // this step's slot has landed; the previous step's products are done
    if (step + kStages - 1 < last) issue(step + kStages - 1);  // into the slot the previous step freed
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    dequantize(step);
    __syncthreads();
    const __nv_bfloat16* xt =
        L::kF32 ? xs16 : reinterpret_cast<const __nv_bfloat16*>(smem + (step % kStages) * L::kSlot + L::kW + L::kS);
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const int c = kc * 16 + tig * 2;
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const __nv_bfloat16* xr = xt + (wm * kWM + mt * 16 + g) * kLd + c;
        af[mt][0] = ld_pair(xr);
        af[mt][1] = ld_pair(xr + 8 * kLd);
        af[mt][2] = ld_pair(xr + 8);
        af[mt][3] = ld_pair(xr + 8 * kLd + 8);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const __nv_bfloat16* wrp = staging + (wn * kWN + nt * 8 + g) * kLd + c;
        const uint32_t b0 = ld_pair(wrp), b1 = ld_pair(wrp + 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  T* out = static_cast<T*>(a.out);
  float* part = a.splits > 1 ? a.workspace + (long long)split * a.m * a.n : nullptr;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm * kWM + mt * 16 + g + (c >= 2 ? 8 : 0);
        const int col = n0 + wn * kWN + nt * 8 + tig * 2 + (c & 1);
        if (row >= a.m) continue;
        if (part != nullptr) {
          part[(long long)row * a.n + col] = acc[mt][nt][c];
        } else {
          out[(long long)row * a.n + col] = from_f<T>(acc[mt][nt][c]);
        }
      }
    }
  }
}

// out[i] = the split partials of element i added in split order, then cast.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ part, T* __restrict__ out, long long mn, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn; i += (long long)gridDim.x * blockDim.x) {
    float sum = part[i];
    for (int r = 1; r < splits; ++r) sum += part[r * mn + i];
    out[i] = from_f<T>(sum);
  }
}

template <typename T, int BM, int BN>
cudaError_t launch_tile(const Int4MatmulArgs& a, cudaStream_t stream) {
  constexpr int kBytes = Smem<T, BM, BN>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance
      int4_kernel<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.n / BN, (a.m + BM - 1) / BM, a.splits);
  int4_kernel<T, BM, BN><<<grid, kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_rows(const Int4MatmulArgs& a, cudaStream_t stream) {
  if (a.m <= 16) return launch_tile<T, 16, BN>(a, stream);
  if (a.m <= 32) return launch_tile<T, 32, BN>(a, stream);
  return launch_tile<T, 64, BN>(a, stream);
}

template <typename T>
cudaError_t launch(const Int4MatmulArgs& a, cudaStream_t stream) {
  const cudaError_t err = a.block_n == 64 ? launch_rows<T, 64>(a, stream) : launch_rows<T, 32>(a, stream);
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long mn = static_cast<long long>(a.m) * a.n;
  const int blocks = static_cast<int>(min((mn + 255) / 256, 4096LL));
  reduce_splits<T><<<blocks, 256, 0, stream>>>(a.workspace, static_cast<T*>(a.out), mn, a.splits);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Needs
// N % block_n == 0, K/2 % 64 == 0, a group (K / groups) that divides K/2, and
// splits of whole k steps that cover K/2 with none empty: every shape of the
// TPU kernel's contract under int4_split_plan (checked again by the Python
// wrapper).
extern "C" int owc_int4_matmul(const Int4MatmulArgs* args, void* stream) {
  const Int4MatmulArgs a = *args;
  const int k2 = a.k / 2;
  if (a.m < 0 || (a.block_n != 32 && a.block_n != 64) || a.n <= 0 || a.n % a.block_n != 0 || a.k <= 0 ||
      k2 % kBKP != 0 || a.groups <= 0 || a.k % a.groups != 0 || k2 % (a.k / a.groups) != 0 ||
      a.splits < 1 || a.split_bytes <= 0 || a.split_bytes % kBKP != 0 ||
      static_cast<long long>(a.splits) * a.split_bytes < k2 ||
      static_cast<long long>(a.splits - 1) * a.split_bytes >= k2 || (a.splits > 1 && a.workspace == nullptr))
    return cudaErrorInvalidValue;
  if (a.m == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dtype == 1) return launch<__nv_bfloat16>(a, s);
  if (a.dtype == 0) return launch<float>(a, s);
  return cudaErrorInvalidValue;
}

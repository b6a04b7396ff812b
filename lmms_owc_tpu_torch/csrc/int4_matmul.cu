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
// head (3584 x 152064) 272 MB of it.
//
// What this first design does about it: each CTA owns a 64-column N tile and a
// 16/32/64-row M tile (chosen by M) and walks K in steps of 32 packed bytes
// (32 low + 32 high input columns), loading the packed weight as one 16-byte
// vector per thread and x as 16-byte vectors, so every weight byte is read once
// per M tile. The next step's loads are issued into registers before this
// step's products, so they are in flight during the tensor-core work. The
// nibbles are unpacked and scaled in registers and staged in shared memory as a
// bf16 [64 n][64 k] tile; x is staged as a bf16 [BM][64 k] tile (low columns,
// then high columns, so the two halves of the weight meet their own x columns);
// the product runs as mma.sync m16n8k16 bf16 tiles with f32 accumulators. The
// scales of a step's low and high halves are groups k/group and
// (k + K/2)/group: one load each when the group is a multiple of 16. Left for
// later work: at N = 3584 only 56 N tiles x 2 M tiles exist for 132 SMs
// (split-K would fill the card), cp.async/TMA multi-stage pipelining, and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors Int4MatmulArgs in lmms_owc_tpu_torch/ops/_build.py (ctypes.Structure).
struct Int4MatmulArgs {
  const void* x;       // [M, K] contiguous, 16-byte aligned
  const int8_t* q4;    // [N, K/2] contiguous, 16-byte aligned, halves layout
  const float* scale;  // [N, groups] contiguous
  void* out;           // [M, N] contiguous
  int m, n, k, groups, dtype;  // dtype of x and out: 0 f32, 1 bf16
};

namespace {

constexpr int kBN = 64;        // output columns per CTA
constexpr int kBKP = 32;       // packed bytes per k step
constexpr int kBK = 2 * kBKP;  // input columns per k step (32 low, 32 high)
constexpr int kThreads = 128;  // 4 warps
constexpr int kLd = kBK + 8;   // shared-memory row stride (bf16): no bank conflicts

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

// d += a(16x16, row-major) * b(16x8, col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sign-extended low and high nibbles of a packed byte.
__device__ __forceinline__ int nibble_lo(int p) { return static_cast<int>(static_cast<unsigned>(p) << 28) >> 28; }
__device__ __forceinline__ int nibble_hi(int p) { return p >> 4; }

// Stores 16-byte vector `v` of x (kVec elements of T) as bf16 at `dst`.
__device__ __forceinline__ void store_x(__nv_bfloat16* dst, const uint4& v, __nv_bfloat16) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void store_x(__nv_bfloat16* dst, const uint4& v, float) {
  const float* f = reinterpret_cast<const float*>(&v);
  __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads) int4_kernel(const Int4MatmulArgs a) {
  constexpr int kWarpsM = BM >= 64 ? 2 : 1;
  constexpr int kWarpsN = 4 / kWarpsM;
  constexpr int kWM = BM / kWarpsM;  // rows per warp
  constexpr int kWN = kBN / kWarpsN;  // columns per warp
  constexpr int kMT = kWM / 16, kNT = kWN / 8;
  constexpr int kVecX = 16 / sizeof(T);
  constexpr int kXLoads = BM * kBK / kVecX / kThreads;
  static_assert(BM * kBK % (kVecX * kThreads) == 0, "x tile must split evenly over threads");

  __shared__ __align__(16) __nv_bfloat16 xs[BM * kLd];
  __shared__ __align__(16) __nv_bfloat16 ws[kBN * kLd];

  const int k2 = a.k / 2, group = a.k / a.groups;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const T* x = static_cast<const T*>(a.x);

  // Weight loads: thread t reads 16 packed bytes of weight row n0 + t/2, half t%2.
  const int wr = threadIdx.x >> 1, wh = threadIdx.x & 1;
  const int8_t* wrow = a.q4 + (long long)(n0 + wr) * k2 + wh * 16;
  const float* srow = a.scale + (long long)(n0 + wr) * a.groups;

  uint4 wreg;
  uint4 xreg[kXLoads];
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  auto fetch = [&](int step) {
    const int j0 = step * kBKP;
    wreg = *reinterpret_cast<const uint4*>(wrow + j0);
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int e = (threadIdx.x + i * kThreads) * kVecX;
      const int r = e / kBK, c = e % kBK;
      const int col = c < kBKP ? j0 + c : k2 + j0 + (c - kBKP);
      const int row = m0 + r;
      xreg[i] = row < a.m ? *reinterpret_cast<const uint4*>(x + (long long)row * a.k + col)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto stage = [&](int step) {
    const int jb = step * kBKP + wh * 16;  // first packed byte of this thread
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&wreg);
    __nv_bfloat16* lo_dst = ws + wr * kLd + wh * 16;
    __nv_bfloat16* hi_dst = lo_dst + kBKP;
    if (group % 16 == 0) {
      const float s_lo = srow[jb / group], s_hi = srow[(jb + k2) / group];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int p = bytes[i];
        lo_dst[i] = __float2bfloat16(static_cast<float>(nibble_lo(p)) * s_lo);
        hi_dst[i] = __float2bfloat16(static_cast<float>(nibble_hi(p)) * s_hi);
      }
    } else {
      for (int i = 0; i < 16; ++i) {
        const int p = bytes[i];
        lo_dst[i] = __float2bfloat16(static_cast<float>(nibble_lo(p)) * srow[(jb + i) / group]);
        hi_dst[i] = __float2bfloat16(static_cast<float>(nibble_hi(p)) * srow[(jb + i + k2) / group]);
      }
    }
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int e = (threadIdx.x + i * kThreads) * kVecX;
      store_x(xs + (e / kBK) * kLd + e % kBK, xreg[i], T());
    }
  };

  const int steps = k2 / kBKP;
  fetch(0);
  for (int step = 0; step < steps; ++step) {
    __syncthreads();  // the previous step's products are done with the tiles
    stage(step);
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1);  // in flight during the products below
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const int c = kc * 16 + tig * 2;
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const __nv_bfloat16* xr = xs + (wm * kWM + mt * 16 + g) * kLd + c;
        af[mt][0] = ld_pair(xr);
        af[mt][1] = ld_pair(xr + 8 * kLd);
        af[mt][2] = ld_pair(xr + 8);
        af[mt][3] = ld_pair(xr + 8 * kLd + 8);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const __nv_bfloat16* wrp = ws + (wn * kWN + nt * 8 + g) * kLd + c;
        const uint32_t b0 = ld_pair(wrp), b1 = ld_pair(wrp + 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm * kWM + mt * 16 + g + (c >= 2 ? 8 : 0);
        const int col = n0 + wn * kWN + nt * 8 + tig * 2 + (c & 1);
        if (row < a.m) out[(long long)row * a.n + col] = from_f<T>(acc[mt][nt][c]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Int4MatmulArgs& a, cudaStream_t stream) {
  const int bm = a.m <= 16 ? 16 : (a.m <= 32 ? 32 : 64);
  const dim3 grid(a.n / kBN, (a.m + bm - 1) / bm);
  if (bm == 16) {
    int4_kernel<T, 16><<<grid, kThreads, 0, stream>>>(a);
  } else if (bm == 32) {
    int4_kernel<T, 32><<<grid, kThreads, 0, stream>>>(a);
  } else {
    int4_kernel<T, 64><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Needs
// N % 64 == 0, K/2 % 32 == 0 and a group (K / groups) that divides K/2: every
// shape of the TPU kernel's contract (checked again by the Python wrapper).
extern "C" int owc_int4_matmul(const Int4MatmulArgs* args, void* stream) {
  const Int4MatmulArgs a = *args;
  if (a.m < 0 || a.n <= 0 || a.n % kBN != 0 || a.k <= 0 || (a.k / 2) % kBKP != 0 ||
      a.groups <= 0 || a.k % a.groups != 0 || (a.k / 2) % (a.k / a.groups) != 0)
    return cudaErrorInvalidValue;
  if (a.m == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dtype == 1) return launch<__nv_bfloat16>(a, s);
  if (a.dtype == 0) return launch<float>(a, s);
  return cudaErrorInvalidValue;
}

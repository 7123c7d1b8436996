// The s8 x s8 -> s32 convolution of the int8 serving precision, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (lssvc_tpu_torch/ops/int8.py; built by build.py).
//
// Replaces: the JAX package's s8 convolution, which is no Pallas kernel but
// XLA's `lax.conv_general_dilated(..., preferred_element_type=int32)` in
// `int8_conv2d` (lssvc_tpu/ops/int8.py:63-76), and with it the quantize ->
// s8 conv -> dequantize of a calibrated packed site (`_pconv_int8`,
// lssvc_tpu/models/packed_blocks.py:35-53).
//
// What it computes, NHWC activations and an s8 weight in the kernel's
// layout (ops/int8.py `Int8Weight.layout`: (cout_pad / N, kh*kw, cinp / 16,
// N, 16), Cin padded with zeros to cinp, a multiple of 32, and Cout to
// cout_pad, a multiple of the Cout chunk N that `chunk_n` picks):
//   acc[n, oy, ox, o] = sum_{ky, kx, c} q(x[n, oy*s + ky - pad_t,
//                        ox*s + kx - pad_l, c]) * w[o, c, ky, kx]
// in s32, exactly (|acc| <= 127^2 * K, 8.7e7 at K = 5376, far below 2^31);
// outside the picture q is 0.  x is s8 (q(v) = v) or bf16 / f32, quantized
// once per tile: q(v) = clamp(rint(v / s_in), -127, 127) with an IEEE
// division (__fdiv_rn) and rint's round-half-to-even, what jnp.round(x /
// s) computes.  The output is acc (s32), or the fused epilogue of a
// calibrated site in bf16: bf16(f32(acc) * mult[o] + bias[o]), with
// __fmul_rn and __fadd_rn so that no FMA contraction makes it differ from
// the plain version's separate multiply and add.
//
// Bound on an H100 SXM: at the packed 3x3 96 -> 96 site at 1x1152x960,
// bf16 in and out, 424.7 MB moved (0.127 ms at 3.35 TB/s) against 183.5 GOP
// (0.093 ms at 1,979 int8 TOP/s): bytes bind, as at every 1x1 site.
// SpyNet's packed 7x3 128 -> 256 at 1x1152x480 is 0.76 TOP (0.38 ms):
// operations bind.
//
// Design.  A block of four warpgroups (512 threads) computes an implicit
// GEMM per output tile: M = th x pitch output pixels (the tile's rows at
// the pitch of its halo's phase planes; the last pitch - tw columns of each
// row are computed and not stored), N = a chunk of Cout, K = kh*kw*cinp.
// - Products on wgmma.mma_async m64nNk32 s32.s8.s8, A and B from shared
//   memory by descriptors, no swizzle (8-row x 16-byte core matrices).
//   Each warpgroup takes MT M tiles of 64 rows (N <= 64: 2, else 1) with an
//   s32 accumulator each (at most 64 registers of them).  One k-step (32
//   channels of a tap) is one wgmma group, fenced and committed, with up
//   to kInFlight groups in flight; descriptors are added in 32 bits and
//   each tap's A offset comes from a table in shared memory, so that the
//   issue between two wgmmas stays a few instructions (with divisions and
//   64-bit adds there the products ran far below the tensor-core rate).
// - The halo in shared memory is s8, chunk-planar (a plane per 16
//   channels, pixel after pixel) and split by stride phase (pixel (y, x)
//   in plane (y % s, x % s) at (y / s) * pitch + x / s), so an M tile at
//   any tap is 64 consecutive pixels of one plane: tap (ky, kx) is one
//   offset for the whole tile, the descriptor's start moving by 16 bytes a
//   pixel, and a stride-2 conv reads no pixel twice.
// - The weights (B) stay in shared memory for the block's life where they
//   fit beside the halo ("resident": one bulk copy, cp.async.bulk with an
//   mbarrier); else they stream through a ring of 2-3 stages of whole
//   taps, one bulk copy a stage on its own mbarrier, so the next stage
//   lands while this one multiplies (one barrier a stage, none a tap).
//   A buffer is refilled once every warpgroup's products from it are done:
//   with three stages one stage later (its products are done once the next
//   stage's have been issued), so that the products never drain; with two
//   at the end of its own stage (all products waited for before the
//   barrier), so that the stage after the next one is always in flight.
// - A persistent grid (one block an SM; `cudaOccupancy...` decides) walks
//   the tiles, y fastest within a column of tiles, so neighbours' halos
//   overlap in L2.  Where the raw halo fits ("staging"), the next tile's
//   raw input (bf16, f32 or s8) is copied with cp.async into a staging
//   buffer while this tile multiplies and stores; each tile's input is
//   quantized once, from staging to the s8 halo, for all of Cout (a Cout
//   past N loops over chunks with the halo resident), by a multiply with
//   an exact fallback to the division (the quantizer, below).  Misaligned
//   inputs or rows that are not whole 16-byte units take element loads.
// - The host plan (`make_plan`) picks the tile (its pitch; all four
//   warpgroups' M tiles busy, or half of them) and the modes by a cost
//   estimate among those whose shared memory fits (232,448 bytes);
//   `lssvc_int8_plan` returns its choice without launching.
// - The epilogue stores from the accumulator fragments: with Cout a
//   multiple of 8 and the output 16-byte aligned, a quad's fragments are
//   transposed by shuffles so that each lane stores 8 whole columns (16
//   bytes of bf16, 32 of s32); else column pairs (4-byte bf16x2, 8-byte
//   int2) where Cout is even and the output aligned, else elements.
//   Offsets into global memory are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroups = 4;  // warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kMaxSmem = 232448;
// the mbarriers and each tap's A offset, at the start of shared memory
constexpr int kBarBytes = 256;
constexpr int kMaxTaps = (kBarBytes - 64) / 4;
constexpr int kMaxStages = 3;   // of the weight ring
constexpr uint32_t kBulkPiece = 32768;  // bytes of one bulk copy at most
// wgmma groups (k-steps) a warpgroup keeps in flight (2 to 8 measured
// alike on an H100)
constexpr int kInFlight = 3;

// the Cout chunk of one wgmma (and of the weight layout) for a Cout
__host__ __device__ constexpr int chunk_n(int cout) {
  return cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64
                                                         : cout <= 96 ? 96
                                                                      : 128;
}
// M tiles of 64 rows a warpgroup holds an accumulator for (at most 64
// registers of accumulators: 128 a thread with four warpgroups)
__host__ __device__ constexpr int m_tiles(int n) { return n <= 64 ? 2 : 1; }

// The quantizer.  q(v) = clamp(rint(v / s), -127, 127) with v / s the IEEE
// quotient.  Fast path: y = v * r, r = 1/s rounded to nearest.  For s and r
// normal, |y - v/s| <= |v/s| (2^-24 + 2^-24) (r's rounding and the
// product's), and the IEEE quotient is within 2^-24 |v/s| of v/s, so up
// to 128 y is within 128 * 3 * 2^-24 = 2.3e-5 of the quotient.  rint's
// result changes only at half-integers; where y lies farther than 2^-14
// from every half-integer, y and the quotient round alike.  Within 2^-14
// of one (about 1 element in 8,000 of uniform fractions) the kernel
// divides.  Past 128 both clamp to 127 (a value there near a tie divides
// all the same); NaN and +-inf take the product's path and give what the
// quotient gives (-127 for NaN, +-127 for inf).
struct Scale {
  float s, r;
  bool fast;  // s and r normal and finite: the product's path is exact
};

__device__ __forceinline__ bool is_normal(float x) {
  const float a = fabsf(x);  // NaN compares false
  return a >= 1.17549435e-38f && a <= 3.40282347e38f;
}

// round to nearest even by adding and subtracting 1.5 * 2^23 (exact for
// |y| <= 2^22): two adds on the FMA pipe in place of the conversion pipe's
// rint (a quarter of the rate)
constexpr float kRound = 12582912.f;

// 8 values quantized into 8 s8 bytes.  The products are clamped to
// +-200 first (past 127.5 every value clamps to 127, NaN to -127 as the
// quotient's path gives), so the rounding adds are exact; q + kRound holds
// the integer q in its low mantissa bits.
__device__ __forceinline__ uint2 quant8(const float (&v)[8], const Scale& sc) {
  float q[8];
  uint32_t need = 0xffu;
  if (sc.fast) {
    need = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = fminf(fmaxf(__fmul_rn(v[j], sc.r), -200.f), 200.f);
      q[j] = __fsub_rn(__fadd_rn(y, kRound), kRound);
      // within 2^-14 of a half-integer: |y - rint(y)| >= 0.5 - 2^-14
      need |= fabsf(y - q[j]) >= 0.5f - 0x1p-14f ? 1u << j : 0u;
    }
  }
  if (need) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if ((need >> j) & 1u) q[j] = rintf(__fdiv_rn(v[j], sc.s));
  }
  int i[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    i[j] = __float_as_int(
               __fadd_rn(fminf(fmaxf(q[j], -127.f), 127.f), kRound)) -
           __float_as_int(kRound);
  return make_uint2(__byte_perm(__byte_perm(i[0], i[1], 0x0040),
                                __byte_perm(i[2], i[3], 0x0040), 0x5410),
                    __byte_perm(__byte_perm(i[4], i[5], 0x0040),
                                __byte_perm(i[6], i[7], 0x0040), 0x5410));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 channels from p, of which `avail` exist (the rest are 0), quantized
// (s8 copied); by 16-byte vectors when all 16 exist and kVec says p is
// 16-byte aligned
template <typename T, bool kVec>
__device__ __forceinline__ uint4 quant16(const T* p, int avail,
                                         const Scale& sc) {
  if constexpr (std::is_same<T, int8_t>::value) {
    if (kVec && avail >= 16) return *reinterpret_cast<const uint4*>(p);
    uint32_t r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < avail)
        r[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j]))
                     << (8 * (j & 3));
    return make_uint4(r[0], r[1], r[2], r[3]);
  } else {
    uint2 half[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v[8];
      const T* ph = p + 8 * hf;
      if (kVec && avail >= 16) {
        if constexpr (std::is_same<T, float>::value) {
          const float4 f0 = reinterpret_cast<const float4*>(ph)[0];
          const float4 f1 = reinterpret_cast<const float4*>(ph)[1];
          v[0] = f0.x;
          v[1] = f0.y;
          v[2] = f0.z;
          v[3] = f0.w;
          v[4] = f1.x;
          v[5] = f1.y;
          v[6] = f1.z;
          v[7] = f1.w;
        } else {
          const uint4 a = *reinterpret_cast<const uint4*>(ph);
          const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[2 * k] = __uint_as_float(w[k] << 16);
            v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = 8 * hf + j < avail ? to_f32(ph[j]) : 0.f;
      }
      half[hf] = quant8(v, sc);
    }
    return make_uint4(half[0].x, half[0].y, half[1].x, half[1].y);
  }
}

// u / d and u % d for 0 <= u < 2^22 by a float reciprocal (inv = 1.f / d)
// and one correction
__device__ __forceinline__ int div_by(int u, int d, float inv, int& rem) {
  int q = __float2int_rz(__int2float_rn(u) * inv);
  int r = u - q * d;
  if (r < 0) {
    --q;
    r += d;
  } else if (r >= d) {
    ++q;
    r -= d;
  }
  rem = r;
  return q;
}

// a 4x4 transpose of 32-bit values across the four lanes of a quad: lane t
// holds a[i] = M[t][i] and ends with a[i] = M[i][t] (two exchange stages)
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int t) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool hi = (t & bit) != 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q & bit) continue;
      const uint32_t send = hi ? a[q] : a[q + bit];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, bit);
      if (hi)
        a[q] = got;
      else
        a[q + bit] = got;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// this thread's shared-memory stores become visible to wgmma (the async
// proxy) after the next barrier
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global to shared memory by the bulk-copy
// engine in pieces, completing on `bar`, which expects them
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  for (uint32_t o = 0; o < bytes; o += kBulkPiece) {
    const uint32_t piece = bytes - o < kBulkPiece ? bytes - o : kBulkPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(
            static_cast<uint8_t*>(dst) + o)),
        "l"(static_cast<const uint8_t*>(src) + o), "r"(piece),
        "r"(smem_addr(bar))
        : "memory");
  }
}

// shared-memory matrix descriptor, no swizzle (8-row x 16-byte core
// matrices): lbo = bytes between core matrices along K, sbo = along M / N
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
// keeps the compiler from moving accesses of r across this point
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// the products, A and B from shared-memory descriptors given as their
// 32-bit halves (offsets change only the low half's start address, so the
// loops add in 32 bits), s32 accumulators
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void ss(uint32_t* d, uint32_t a_lo,
                                            uint32_t a_hi, uint32_t b_lo,
                                            uint32_t b_hi) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %12, 0;\n"
        "mov.b64 da, {%8, %9};\nmov.b64 db, {%10, %11};\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a_lo), "r"(a_hi), "r"(b_lo), "r"(b_hi), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(uint32_t* d, uint32_t a_lo,
                                            uint32_t a_hi, uint32_t b_lo,
                                            uint32_t b_hi) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %20, 0;\n"
        "mov.b64 da, {%16, %17};\nmov.b64 db, {%18, %19};\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a_lo), "r"(a_hi), "r"(b_lo), "r"(b_hi), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(uint32_t* d, uint32_t a_lo,
                                            uint32_t a_hi, uint32_t b_lo,
                                            uint32_t b_hi) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %36, 0;\n"
        "mov.b64 da, {%32, %33};\nmov.b64 db, {%34, %35};\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a_lo), "r"(a_hi), "r"(b_lo), "r"(b_hi), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void ss(uint32_t* d, uint32_t a_lo,
                                            uint32_t a_hi, uint32_t b_lo,
                                            uint32_t b_hi) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %52, 0;\n"
        "mov.b64 da, {%48, %49};\nmov.b64 db, {%50, %51};\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "r"(a_lo), "r"(a_hi), "r"(b_lo), "r"(b_hi), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(uint32_t* d, uint32_t a_lo,
                                            uint32_t a_hi, uint32_t b_lo,
                                            uint32_t b_hi) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %68, 0;\n"
        "mov.b64 da, {%64, %65};\nmov.b64 db, {%66, %67};\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a_lo), "r"(a_hi), "r"(b_lo), "r"(b_hi), "r"(1));
  }
};

// The launch's plan (make_plan): shapes, tile, modes and shared memory.
struct Plan {
  int n, h, w, cin, ho, wo, cout, cinp, kh, kw, stride, pad_t, pad_l;
  int taps, c16, nchunks;  // kh*kw; 16-channel chunks of K; Cout chunks
  // the tile: th x tw outputs (M = th * pitch rows, mtiles M tiles of
  // 64, at most kGroups * m_tiles(N): warpgroup g takes tiles g * MT ...
  // g * MT + MT - 1 of them, where they exist); its halo hh x hw
  // input pixels; positions of a phase plane; 16-byte units between two
  // chunk planes of the halo (stride^2 phase planes)
  int th, tw, pitch, mtiles, hh, hw, plane, cps;
  int tiles_y, tiles_x, tiles;
  // weights streamed (ring) in stages of tps taps, `stages` buffers
  int ring, tps, nst, stages, stage_bytes;
  // the next tile's raw halo staged by cp.async, raw_stride bytes a pixel
  int staging, raw_stride;
  // 16-byte input loads; output stores of column pairs, or of 8 columns
  // (a quad's transposed fragments)
  int vec_in, out_bf16, pair_store, vec_store;
  // 1.f / hw, / (hh * hw) and / the 16-byte units of a pixel (div_by)
  float inv_hw, inv_hpix, inv_upr;
  int off_w, off_halo, off_raw, smem;  // bytes into shared memory
};

struct TileAt {
  int img, oy0, ox0;
};

__device__ __forceinline__ TileAt tile_at(const Plan& p, int t) {
  const int per = p.tiles_y * p.tiles_x;
  const int img = t / per;
  t -= img * per;
  const int tx = t / p.tiles_y, ty = t - tx * p.tiles_y;  // y fastest
  return {img, ty * p.th, tx * p.tw};
}

// the position of halo pixel (hy, hx) in its chunk plane, 16-byte units
__device__ __forceinline__ int halo_pos(const Plan& p, int hy, int hx) {
  const int s = p.stride;
  if (s == 1) return hy * p.pitch + hx;
  return ((hy % s) * s + hx % s) * p.plane + (hy / s) * p.pitch + hx / s;
}

// the raw halo of tile `at` into staging by cp.async (zero-filled outside
// the picture), 16-byte units, consecutive threads on consecutive units
template <typename T>
__device__ void stage_raw(const Plan& p, const T* __restrict__ x,
                          uint8_t* raw, TileAt at) {
  const int upr = p.cin * static_cast<int>(sizeof(T)) / 16;
  const int total = p.hh * p.hw * upr;
  const int iy0 = at.oy0 * p.stride - p.pad_t;
  const int ix0 = at.ox0 * p.stride - p.pad_l;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  for (int u = threadIdx.x; u < total; u += kThreads) {
    int k, hx;
    const int px = div_by(u, upr, p.inv_upr, k);
    const int hy = div_by(px, p.hw, p.inv_hw, hx);
    const int iy = iy0 + hy, ix = ix0 + hx;
    const bool in = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
    const uint8_t* src =
        in ? xb + ((static_cast<int64_t>(at.img) * p.h + iy) * p.w + ix) *
                      p.cin * static_cast<int64_t>(sizeof(T)) +
                 k * 16
           : xb;
    cp_async16(smem_addr(raw + px * p.raw_stride + k * 16), src,
               in ? 16 : 0);
  }
  cp_async_commit();
}

// the s8 halo of tile `at` (unit c * hh * hw + pixel: 16 channels of a
// pixel), quantized from staging, or loaded from x (by vectors with vec_in,
// else element by element); zero outside the picture and past cin.
// Consecutive threads take consecutive pixels of one chunk plane, so the
// 16-byte stores meet no bank conflict.
template <typename T>
__device__ void fill_halo(const Plan& p, const T* __restrict__ x,
                          const uint8_t* raw, int8_t* halo, TileAt at,
                          const Scale& sc) {
  const int hpix = p.hh * p.hw, total = p.c16 * hpix;
  const int iy0 = at.oy0 * p.stride - p.pad_t;
  const int ix0 = at.ox0 * p.stride - p.pad_l;
  for (int u = threadIdx.x; u < total; u += kThreads) {
    int px, hx;
    const int c = div_by(u, hpix, p.inv_hpix, px);
    const int hy = div_by(px, p.hw, p.inv_hw, hx);
    const int avail = p.cin - 16 * c;
    uint4 v;
    if (p.staging) {
      v = quant16<T, true>(
          reinterpret_cast<const T*>(raw + px * p.raw_stride) + 16 * c,
          avail, sc);
    } else {
      const int iy = iy0 + hy, ix = ix0 + hx;
      v = make_uint4(0u, 0u, 0u, 0u);
      if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
        const T* src =
            x + ((static_cast<int64_t>(at.img) * p.h + iy) * p.w + ix) *
                    p.cin +
            16 * c;
        v = p.vec_in ? quant16<T, true>(src, avail, sc)
                     : quant16<T, false>(src, avail, sc);
      }
    }
    *reinterpret_cast<uint4*>(
        halo + (static_cast<int64_t>(c) * p.cps + halo_pos(p, hy, hx)) * 16) =
        v;
  }
}

// A place in a block's weight stream: stage g (the stream repeats each
// tile's chunks x stages: chunk j, stage s), in ring buffer b, whose
// mbarrier completes a phase of this parity on it
struct RingPos {
  int g, j, s, b;
  uint32_t parity;
  __device__ void next(const Plan& p) {
    ++g;
    if (++s == p.nst) {
      s = 0;
      if (++j == p.nchunks) j = 0;
    }
    if (++b == p.stages) {
      b = 0;
      parity ^= 1u;
    }
  }
};

// the stage at `at` into its ring buffer, then on to the next
__device__ __forceinline__ void produce(const Plan& p,
                                        const int8_t* __restrict__ w,
                                        int8_t* ring, uint64_t* bars,
                                        RingPos& at, int n_chunk) {
  bulk_load(ring + static_cast<int64_t>(at.b) * p.stage_bytes,
            w + (static_cast<int64_t>(at.j) * p.taps + at.s * p.tps) *
                    p.cinp * n_chunk,
            p.stage_bytes, &bars[1 + at.b]);
  at.next(p);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     void* __restrict__ out, const float* __restrict__ mult,
                     const float* __restrict__ bias, float s_in,
                     const Plan p) {
  constexpr int MT = m_tiles(N);
  extern __shared__ __align__(128) uint8_t smem[];
  // bars[0]: the resident weights; bars[1 + b]: ring buffer b
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // each tap's A offset in 16-byte units: its stride phase's plane and its
  // shift (ky / s) rows and (kx / s) pixels on
  int* tap_off = reinterpret_cast<int*>(smem + 64);
  int8_t* wsm = reinterpret_cast<int8_t*>(smem + p.off_w);
  int8_t* halo = reinterpret_cast<int8_t*>(smem + p.off_halo);
  uint8_t* raw = smem + p.off_raw;
  const int tid = threadIdx.x;
  // the grid is at most the tile count, so every block has a tile
  const int my_tiles =
      (p.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int total_stages = p.ring ? my_tiles * p.nchunks * p.nst : 0;
  Scale sc;
  sc.s = s_in;
  sc.r = __frcp_rn(s_in);
  sc.fast = is_normal(s_in) && is_normal(sc.r);

  if (tid == 0) {
    for (int b = 0; b <= kMaxStages; ++b) mbar_init(&bars[b], 1);
    mbar_init_fence();
  }
  if (tid < p.taps) {
    const int ky = tid / p.kw, kx = tid - ky * p.kw, s = p.stride;
    tap_off[tid] = ((ky % s) * s + kx % s) * p.plane + (ky / s) * p.pitch +
                   kx / s;
  }
  __syncthreads();
  // the weight stream's next stage to load (thread 0) and to multiply;
  // stages loaded ahead of the first: both buffers of a 2-stage ring (each
  // is refilled at the end of its own stage), two of a 3-stage one (each
  // refilled one stage later)
  RingPos made = {0, 0, 0, 0, 0u}, used = {0, 0, 0, 0, 0u};
  const bool drain = p.stages == 2;
  if (tid == 0) {
    if (!p.ring) {
      bulk_load(wsm, w,
                static_cast<uint32_t>(p.nchunks) * p.taps * p.cinp * N,
                &bars[0]);
    } else {
      while (made.g < (drain ? 2 : p.stages - 1) && made.g < total_stages)
        produce(p, w, wsm, bars, made, N);
    }
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // descriptors: A at chunk plane 0, position 0 of the halo (LBO: the
  // chunk-plane stride); B at the weights (LBO: N rows of 16 bytes between
  // K chunks).  Offsets below are 16-byte units.  A warpgroup whose M
  // tiles lie past the tile's (a half-busy tile) repeats its last M tile
  // and stores nothing: a branch around wgmma would serialize every
  // product (ptxas C7520).
  const uint64_t a_desc = desc_kmajor(smem_addr(halo), p.cps * 16, 128);
  const uint64_t b_desc = desc_kmajor(smem_addr(wsm), N * 16, 128);
  const uint32_t a_hi = static_cast<uint32_t>(a_desc >> 32);
  const uint32_t b_hi = static_cast<uint32_t>(b_desc >> 32);
  uint32_t a_lo[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    a_lo[mt] = static_cast<uint32_t>(a_desc) +
               min(wg * MT + mt, p.mtiles - 1) * 64;
  const uint32_t b_lo = static_cast<uint32_t>(b_desc);
  const uint32_t a_kstep = 2 * p.cps, b_kstep = 2 * N;
  const int ksteps = p.c16 / 2;
  if (p.staging) stage_raw<T>(p, x, raw, tile_at(p, blockIdx.x));

  for (int it = 0; it < my_tiles; ++it) {
    const TileAt at = tile_at(p, blockIdx.x + it * gridDim.x);
    if (p.staging) {
      cp_async_wait_all();
      __syncthreads();  // the tile's raw halo landed, everyone's
    }
    fill_halo<T>(p, x, raw, halo, at, sc);
    fence_async();
    __syncthreads();  // the halo is written; staging is free
    if (p.staging && it + 1 < my_tiles)
      stage_raw<T>(p, x, raw, tile_at(p, blockIdx.x + (it + 1) * gridDim.x));
    if (!p.ring && it == 0) mbar_wait(&bars[0], 0);

    // this thread's output rows: M row 16*warp + g + 8*h of each M tile
    int64_t orow[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int v = (wg * MT + mt) * 64 + 16 * warp + g + 8 * hf;
        const int r = v / p.pitch, c = v - r * p.pitch;
        const int oy = at.oy0 + r, ox = at.ox0 + c;
        orow[mt][hf] =
            wg * MT + mt < p.mtiles && c < p.tw && r < p.th && oy < p.ho &&
                    ox < p.wo
                ? ((static_cast<int64_t>(at.img) * p.ho + oy) * p.wo + ox) *
                      p.cout
                : -1;
      }
    }

    for (int j = 0; j < p.nchunks; ++j) {
      uint32_t acc[MT][N / 2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          acc[mt][i] = 0u;
          pin(acc[mt][i]);
        }
      }
      // ksteps k-steps from A offset a_k and B offset b_k (16-byte units),
      // one group each: fenced, committed, and at most kInFlight groups in
      // flight, so that no wgmma is left uncommitted at a loop's back edge
      // (ptxas would wait there for the products to finish)
      auto k_steps = [&](uint32_t a_k, uint32_t b_k) {
        for (int k = 0; k < ksteps; ++k) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int i = 0; i < N / 2; ++i) pin(acc[mt][i]);
          }
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            Wgmma<N>::ss(acc[mt], a_lo[mt] + a_k, a_hi, b_lo + b_k, b_hi);
          wgmma_commit();
          wgmma_wait<kInFlight - 1>();
          a_k += a_kstep;
          b_k += b_kstep;
        }
      };
      if (!p.ring) {
        for (int t = 0; t < p.taps; ++t)
          k_steps(tap_off[t], (j * p.taps + t) * p.c16 * N);
      } else {
        for (int s = 0; s < p.nst; ++s) {
          mbar_wait(&bars[1 + used.b], used.parity);
          for (int tt = 0; tt < p.tps; ++tt)
            k_steps(tap_off[s * p.tps + tt],
                    used.b * (p.stage_bytes >> 4) + tt * p.c16 * N);
          // 3 stages: this warpgroup's groups but the last kInFlight - 1
          // are done, its products of the previous stage, if this stage
          // has that many groups; 2 stages: all of them.  After the
          // barrier everyone's: the previous (3) or this (2) stage's
          // buffer is free, and the next produce refills it
          if (drain || p.tps * ksteps < kInFlight - 1) wgmma_wait<0>();
          __syncthreads();
          if (tid == 0 && made.g < total_stages)
            produce(p, w, wsm, bars, made, N);
          used.next(p);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) pin(acc[mt][i]);
      }

      // the epilogue: acc[mt][nb*4 + 2*hf + e] is M row 16*warp + g + 8*hf
      // of M tile mt, column nb*8 + 2*t4 + e of the chunk
      if (N % 32 == 0 && p.vec_store) {
        // four 8-column blocks at a time: a quad's fragments transposed,
        // so lane t4 stores block 4k + t4 of its row whole (16 bytes of
        // bf16, 32 of s32); the quad's four stores are 64 (128) bytes in
        // a row
#pragma unroll
        for (int k = 0; k < N / 32; ++k) {
          float m[4][2], b[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = j * N + (4 * k + i) * 8 + 2 * t4 + e;
              m[i][e] = p.out_bf16 && n < p.cout ? mult[n] : 0.f;
              b[i][e] = p.out_bf16 && n < p.cout ? bias[n] : 0.f;
            }
          }
          const int n_blk = j * N + (4 * k + t4) * 8;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (wg * MT + mt >= p.mtiles) continue;  // the warpgroup's
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const bool store = orow[mt][hf] >= 0 && n_blk < p.cout;
              if (p.out_bf16) {
                uint32_t a[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int v0 =
                      static_cast<int>(acc[mt][(4 * k + i) * 4 + 2 * hf]);
                  const int v1 =
                      static_cast<int>(acc[mt][(4 * k + i) * 4 + 2 * hf + 1]);
                  // both rounded to bf16 by one cvt.rn.bf16x2.f32
                  const __nv_bfloat162 y = __floats2bfloat162_rn(
                      __fadd_rn(__fmul_rn(__int2float_rn(v0), m[i][0]),
                                b[i][0]),
                      __fadd_rn(__fmul_rn(__int2float_rn(v1), m[i][1]),
                                b[i][1]));
                  a[i] = static_cast<uint32_t>(__bfloat16_as_ushort(y.x)) |
                         (static_cast<uint32_t>(__bfloat16_as_ushort(y.y))
                          << 16);
                }
                quad_transpose(a, t4);
                if (store)
                  *reinterpret_cast<uint4*>(
                      static_cast<__nv_bfloat16*>(out) + orow[mt][hf] +
                      n_blk) = make_uint4(a[0], a[1], a[2], a[3]);
              } else {
                uint32_t lo[4], hi[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  lo[i] = acc[mt][(4 * k + i) * 4 + 2 * hf];
                  hi[i] = acc[mt][(4 * k + i) * 4 + 2 * hf + 1];
                }
                quad_transpose(lo, t4);
                quad_transpose(hi, t4);
                if (store) {
                  uint4* o = reinterpret_cast<uint4*>(
                      static_cast<int*>(out) + orow[mt][hf] + n_blk);
                  o[0] = make_uint4(lo[0], hi[0], lo[1], hi[1]);
                  o[1] = make_uint4(lo[2], hi[2], lo[3], hi[3]);
                }
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb) {
          const int n = j * N + nb * 8 + 2 * t4;
          if (n >= p.cout) continue;
          const bool two = n + 1 < p.cout;
          float m0 = 0.f, m1 = 0.f, b0 = 0.f, b1 = 0.f;
          if (p.out_bf16) {
            m0 = mult[n];
            b0 = bias[n];
            if (two) {
              m1 = mult[n + 1];
              b1 = bias[n + 1];
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              if (orow[mt][hf] < 0) continue;
              const int v0 = static_cast<int>(acc[mt][nb * 4 + 2 * hf]);
              const int v1 = static_cast<int>(acc[mt][nb * 4 + 2 * hf + 1]);
              if (p.out_bf16) {
                __nv_bfloat16* o =
                    static_cast<__nv_bfloat16*>(out) + orow[mt][hf] + n;
                const __nv_bfloat16 y0 = __float2bfloat16_rn(
                    __fadd_rn(__fmul_rn(__int2float_rn(v0), m0), b0));
                if (two) {
                  const __nv_bfloat16 y1 = __float2bfloat16_rn(
                      __fadd_rn(__fmul_rn(__int2float_rn(v1), m1), b1));
                  if (p.pair_store) {
                    __nv_bfloat162 y;
                    y.x = y0;
                    y.y = y1;
                    *reinterpret_cast<__nv_bfloat162*>(o) = y;
                  } else {
                    o[0] = y0;
                    o[1] = y1;
                  }
                } else {
                  o[0] = y0;
                }
              } else {
                int* o = static_cast<int*>(out) + orow[mt][hf] + n;
                if (two && p.pair_store) {
                  *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
                } else {
                  o[0] = v0;
                  if (two) o[1] = v1;
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every warpgroup's products are done: the halo is free
  }
}

// ---------------------------------------------------------------------------
// The host plan

int round_up(int v, int m) { return (v + m - 1) / m * m; }

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// Estimated seconds of one tile on one SM: its raw input from DRAM at its
// share of 3 TB/s, the products at 60% of the int8 peak, the quantizer and
// the epilogue at a measured ~0.12 and ~0.06 cycles an element and output
// (1.7 GHz), the ring's weights from L2 at its share of 6 TB/s.  Staged
// loads overlap the rest.
double tile_seconds(const Plan& p, int elt, int sms) {
  // every warpgroup multiplies (a half-busy tile's idle ones repeat a tile)
  const double m_rows = kGroups * m_tiles(chunk_n(p.cout)) * 64.0;
  const double cout_pad = static_cast<double>(p.nchunks) * chunk_n(p.cout);
  const double load = static_cast<double>(p.hh) * p.hw * p.cin * elt /
                      (3.0e12 / sms);
  const double mma = m_rows * p.taps * p.cinp * cout_pad * 2.0 /
                     (0.6 * 1979e12 / sms);
  const double quant = static_cast<double>(p.hh) * p.hw * p.cinp * 0.12 /
                       1.7e9;
  const double epi = static_cast<double>(p.th) * p.tw * p.cout * 0.06 / 1.7e9;
  const double ring =
      p.ring ? static_cast<double>(p.taps) * p.cinp * cout_pad /
                   (6.0e12 / sms)
             : 0.0;
  double t = mma + quant + (p.staging ? 0.0 : load) + epi;
  if (p.staging && load > t) t = load;
  return t > ring ? t : ring;
}

// Chooses the tile and the modes (weights resident or in a ring, the raw
// halo staged or loaded directly) of least estimated time
// (waves of tiles over the SMs x tile_seconds) among those whose shared
// memory fits.  A 1x1 stride-1 conv without padding is one GEMM over the
// batch's pixels (one row of them).
bool make_plan(Plan& p, int elt, int sms) {
  const int n_chunk = chunk_n(p.cout);
  const int m_rows = kGroups * m_tiles(n_chunk) * 64;
  p.taps = p.kh * p.kw;
  p.c16 = p.cinp / 16;
  const int64_t w_all = static_cast<int64_t>(p.nchunks) * p.taps * p.cinp *
                        n_chunk;
  // tile shapes (M rows, pitch): all M tiles or half of them busy
  int shapes[16][2], np = 0;
  const int shift_x = (p.kw - 1) / p.stride;
  const bool linear = p.kh == 1 && p.kw == 1 && p.stride == 1 &&
                      p.pad_t == 0 && p.pad_l == 0 && p.ho == p.h &&
                      p.wo == p.w &&
                      static_cast<int64_t>(p.n) * p.h * p.w <= 2147483647LL;
  if (linear) {
    p.w = p.wo = p.n * p.h * p.w;
    p.n = p.h = p.ho = 1;
  }
  for (int rows = m_rows; rows >= m_rows / 2; rows /= 2) {
    if (linear) {
      shapes[np][0] = rows;
      shapes[np++][1] = rows;
      continue;
    }
    for (int pitch = 8; pitch <= rows; pitch *= 2) {
      if (pitch - shift_x < 1) continue;
      shapes[np][0] = rows;
      shapes[np++][1] = pitch;
      if (pitch - shift_x >= p.wo) break;  // wider adds only idle columns
    }
  }
  int raw_stride = round_up(p.cin * elt, 16);
  if ((raw_stride / 16) % 2 == 0) raw_stride += 16;  // no bank conflicts
  double best = 0.0;
  Plan pick = p;
  bool found = false;
  for (int mode = 0; mode < 4; ++mode) {
    const int ring = mode & 1, staging = mode >> 1;
    if (staging && !p.vec_in) continue;
    for (int i = 0; i < np; ++i) {
      Plan q = p;
      q.ring = ring;
      q.staging = staging;
      q.raw_stride = raw_stride;
      q.mtiles = shapes[i][0] / 64;
      q.pitch = shapes[i][1];
      q.th = shapes[i][0] / q.pitch;
      q.tw = q.pitch - shift_x;
      q.hh = (q.th - 1) * q.stride + q.kh;
      q.hw = (q.tw - 1) * q.stride + q.kw;
      const int rows = (q.hh - 1) / q.stride + 1;
      q.plane = rows * q.pitch + shift_x;
      q.cps = q.stride * q.stride * q.plane;
      const int halo = round_up(q.c16 * q.cps * 16, 128);
      const int raw = staging ? round_up(q.hh * q.hw * raw_stride, 128) : 0;
      const int room = kMaxSmem - kBarBytes - halo - raw;
      if (room <= 0) continue;
      int weights;
      if (!ring) {
        if (w_all > room) continue;
        q.tps = q.nst = q.stages = q.stage_bytes = 0;
        weights = round_up(static_cast<int>(w_all), 128);
      } else {
        // the most taps a stage that two stages hold, then a third stage
        // where it fits
        const int tap_bytes = q.cinp * n_chunk;
        q.tps = 0;
        for (int tps = q.taps; tps >= 1 && q.tps == 0; --tps)
          if (q.taps % tps == 0 && 2 * tps * tap_bytes <= room) q.tps = tps;
        if (q.tps == 0) continue;
        q.stages = kMaxStages * q.tps * tap_bytes <= room ? kMaxStages : 2;
        q.nst = q.taps / q.tps;
        q.stage_bytes = q.tps * tap_bytes;
        weights = round_up(q.stages * q.stage_bytes, 128);
      }
      q.off_w = kBarBytes;
      q.off_halo = q.off_w + weights;
      q.off_raw = q.off_halo + halo;
      q.smem = q.off_raw + raw;
      q.inv_hw = 1.f / q.hw;
      q.inv_hpix = 1.f / (q.hh * q.hw);
      q.inv_upr = 1.f / (q.cin * elt / 16 > 0 ? q.cin * elt / 16 : 1);
      q.tiles_y = (q.ho + q.th - 1) / q.th;
      q.tiles_x = (q.wo + q.tw - 1) / q.tw;
      const int64_t tiles = static_cast<int64_t>(q.n) * q.tiles_y * q.tiles_x;
      if (tiles > 2147483647LL) continue;
      q.tiles = static_cast<int>(tiles);
      const double t = static_cast<double>((q.tiles + sms - 1) / sms) *
                       tile_seconds(q, elt, sms);
      if (!found || t < best) {
        best = t;
        pick = q;
        found = true;
      }
    }
  }
  if (found) p = pick;
  return found;
}

// The plan's fields that `lssvc_int8_plan` returns, in this order
constexpr int kPlanInfo = 13;

// Plans the launch and launches it, or with `info` fills info[0 ..
// kPlanInfo - 1] with the plan and the grid and launches nothing
template <typename T, int N>
cudaError_t launch(const void* x, const int8_t* w, void* out,
                   const float* mult, const float* bias, float s_in,
                   Plan p, cudaStream_t stream, int* info) {
  const int sms = sm_count();
  if (!make_plan(p, static_cast<int>(sizeof(T)), sms))
    return cudaErrorInvalidValue;
  auto kernel = int8_conv_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const int64_t slots = static_cast<int64_t>(sms) * per_sm;
  const int grid = static_cast<int>(p.tiles < slots ? p.tiles : slots);
  if (info != nullptr) {
    const int v[kPlanInfo] = {p.ring,   p.staging, p.stages, p.tps,
                              p.pitch,  p.th,      p.tw,     p.mtiles,
                              p.tiles,  grid,      p.smem,   p.vec_in,
                              p.vec_store};
    for (int i = 0; i < kPlanInfo; ++i) info[i] = v[i];
    return cudaSuccess;
  }
  kernel<<<grid, kThreads, static_cast<size_t>(p.smem), stream>>>(
      static_cast<const T*>(x), w, out, mult, bias, s_in, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(const void* x, const int8_t* w, void* out,
                        const float* mult, const float* bias, float s_in,
                        const Plan& p, cudaStream_t stream, int* info) {
#define LSSVC_INT8_LAUNCH(N) \
  return launch<T, N>(x, w, out, mult, bias, s_in, p, stream, info)
  switch (chunk_n(p.cout)) {
    case 16:
      LSSVC_INT8_LAUNCH(16);
    case 32:
      LSSVC_INT8_LAUNCH(32);
    case 64:
      LSSVC_INT8_LAUNCH(64);
    case 96:
      LSSVC_INT8_LAUNCH(96);
    default:
      LSSVC_INT8_LAUNCH(128);
  }
#undef LSSVC_INT8_LAUNCH
}

// Both entry points: the arguments checked, the plan's shapes and modes
// filled in, then launch_type (info: the plan only)
int run(const void* x, const void* wk, void* out, const void* mult,
        const void* bias, float s_in, int n, int h, int w, int cin, int ho,
        int wo, int cout, int cout_pad, int cinp, int kh, int kw, int stride,
        int pad_t, int pad_l, int in_dtype, int out_bf16, void* stream,
        int* info) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || ho <= 0 || wo <= 0 ||
      cout <= 0 || kh <= 0 || kw <= 0 || kh * kw > kMaxTaps || stride <= 0 ||
      cinp % 32 != 0 ||
      cinp < cin || in_dtype < 0 || in_dtype > 2 ||
      cout_pad != round_up(cout, chunk_n(cout)) ||
      (out_bf16 && (mult == nullptr || bias == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Plan p = {};
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.ho = ho;
  p.wo = wo;
  p.cout = cout;
  p.cinp = cinp;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad_t = pad_t;
  p.pad_l = pad_l;
  p.nchunks = cout_pad / chunk_n(cout);
  p.out_bf16 = out_bf16;
  const int elt = in_dtype == 0 ? 1 : in_dtype == 1 ? 2 : 4;
  p.vec_in = (cin * elt) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.pair_store =
      cout % 2 == 0 &&
      reinterpret_cast<uintptr_t>(out) % (out_bf16 ? 4 : 8) == 0;
  p.vec_store = cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int8_t* wp = static_cast<const int8_t*>(wk);
  const float* mp = static_cast<const float*>(mult);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 0) {
    err = launch_type<int8_t>(x, wp, out, mp, bp, s_in, p, st, info);
  } else if (in_dtype == 1) {
    err = launch_type<__nv_bfloat16>(x, wp, out, mp, bp, s_in, p, st, info);
  } else {
    err = launch_type<float>(x, wp, out, mp, bp, s_in, p, st, info);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// x: (n, h, w, cin) of in_dtype (0: s8, 1: bf16, 2: f32); wk: the weight
// layout (cout_pad / N, kh*kw, cinp / 16, N, 16) s8, N = chunk_n(cout),
// 16-byte aligned; out: (n, ho, wo, cout), s32, or bf16 with out_bf16
// (then mult and bias are (cout,) f32).  The caller sizes ho and wo from
// its padding; rows and columns past the input read as zero.  Returns
// cudaGetLastError() after the launch (0: launched), or the error that
// kept it from launching.
int lssvc_int8_conv(const void* x, const void* wk, void* out,
                    const void* mult, const void* bias, float s_in, int n,
                    int h, int w, int cin, int ho, int wo, int cout,
                    int cout_pad, int cinp, int kh, int kw, int stride,
                    int pad_t, int pad_l, int in_dtype, int out_bf16,
                    void* stream) {
  return run(x, wk, out, mult, bias, s_in, n, h, w, cin, ho, wo, cout,
             cout_pad, cinp, kh, kw, stride, pad_t, pad_l, in_dtype,
             out_bf16, stream, nullptr);
}

// The plan lssvc_int8_conv would launch with the same arguments (but the
// stream), launching nothing: info[0..12] = weights in a ring (else
// resident), the raw halo staged (else loaded directly), ring stages, taps
// a stage, the tile's pitch, rows and columns, its M tiles of 64, the
// tiles, the grid, bytes of shared memory, 16-byte input loads, 16-byte
// output stores.  Returns 0, or the error lssvc_int8_conv would return.
int lssvc_int8_plan(const void* x, const void* wk, void* out,
                    const void* mult, const void* bias, float s_in, int n,
                    int h, int w, int cin, int ho, int wo, int cout,
                    int cout_pad, int cinp, int kh, int kw, int stride,
                    int pad_t, int pad_l, int in_dtype, int out_bf16,
                    int* info) {
  if (info == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(x, wk, out, mult, bias, s_in, n, h, w, cin, ho, wo, cout,
             cout_pad, cinp, kh, kw, stride, pad_t, pad_l, in_dtype,
             out_bf16, nullptr, info);
}

}  // extern "C"

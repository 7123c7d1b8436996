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
// What it computes, NHWC activations and a kernel-layout weight
// (cout_pad, kh*kw, cinp) of s8 (OHWI, Cin padded with zeros to cinp, a
// multiple of 32, and Cout to cout_pad):
//   acc[n, oy, ox, o] = sum_{ky, kx, c} q(x[n, oy*s + ky - pad_t,
//                        ox*s + kx - pad_l, c]) * w[o, ky*kw + kx, c]
// in s32, exactly (|acc| <= 127^2 * K, 8.7e7 at K = 5376, far below 2^31);
// outside the picture q is 0.  x is s8 (q(v) = v) or bf16 / f32, quantized
// as it is loaded: q(v) = clamp(rint(v / s_in), -127, 127) with an IEEE
// division (__fdiv_rn) and rint's round-half-to-even, what jnp.round(x /
// s) computes.  The output is acc (s32), or the fused epilogue of a
// calibrated site in bf16: bf16(f32(acc) * mult[o] + bias[o]), with
// __fmul_rn and __fadd_rn so that no FMA contraction makes it differ from
// the plain version's separate multiply and add.
//
// Bound on an H100 SXM: at the packed 3x3 96 -> 96 site at 1x1152x960, bf16
// in and out, 424.7 MB moved (0.127 ms at 3.35 TB/s) against 18.35 GOP
// (0.009 ms at 1,979 int8 TOP/s): bytes bind.  SpyNet's packed 7x3 128 ->
// 256 at 1x1152x480 is 0.76 TOP (0.38 ms): operations bind.
//
// Design (right and simple; wgmma s8, TMA and a persistent schedule are
// later work): one block of 8 warps computes an output tile of 8 rows x 16
// columns x BN = 16*NT output channels.  It loads the tile's input halo
// ((8-1)*s + kh rows x (16-1)*s + kw columns x cinp channels) once,
// quantizing as it loads (16-byte loads where the row and pointer allow
// them), into shared memory, where K's padding is written as zeros and
// nothing past the tensor is read.  Then, tap by tap, it stages the tap's
// BN x cinp weights and runs mma.sync m16n8k32 s8 on the integer tensor
// cores: the A fragments come straight from the halo (an output pixel's
// row of the implicit GEMM is its halo pixel's channels), the B fragments
// from the staged weights.  A staged pixel or weight row is cinp + 16
// bytes, so the eight rows a fragment load touches fall in distinct banks.
// Each warp holds a 32-pixel x 8*NT-channel accumulator.  Offsets into
// global memory are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // output rows a block (two a warp row)
constexpr int TW = 16;         // output columns a block: one m16 tile
constexpr int THREADS = 256;   // 8 warps: 4 along the pixels x 2 along Cout
constexpr int ROW_PAD = 16;    // bytes past cinp in a staged row
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ uint32_t quant(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rn(q))));
}

// Per input type: elements a 16-byte load, the quantizer of one element,
// and a 16-byte load quantized into VEC bytes of shared memory.
template <typename T>
struct In;

template <>
struct In<int8_t> {
  static constexpr int VEC = 16;
  __device__ static int8_t one(int8_t v, float) { return v; }
  __device__ static void vec(const int8_t* src, int8_t* dst, float) {
    *reinterpret_cast<int4*>(dst) = __ldg(reinterpret_cast<const int4*>(src));
  }
  __device__ static void zero(int8_t* dst) {
    *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
  }
};

template <>
struct In<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static int8_t one(__nv_bfloat16 v, float s) {
    return static_cast<int8_t>(quant(__bfloat162float(v), s));
  }
  __device__ static void vec(const __nv_bfloat16* src, int8_t* dst, float s) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(src));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo |= quant(__bfloat162float(h[i]), s) << (8 * i);
      hi |= quant(__bfloat162float(h[4 + i]), s) << (8 * i);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  }
  __device__ static void zero(int8_t* dst) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  }
};

template <>
struct In<float> {
  static constexpr int VEC = 4;
  __device__ static int8_t one(float v, float s) {
    return static_cast<int8_t>(quant(v, s));
  }
  __device__ static void vec(const float* src, int8_t* dst, float s) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    *reinterpret_cast<uint32_t*>(dst) = quant(v.x, s) | (quant(v.y, s) << 8) |
                                        (quant(v.z, s) << 16) |
                                        (quant(v.w, s) << 24);
  }
  __device__ static void zero(int8_t* dst) {
    *reinterpret_cast<uint32_t*>(dst) = 0u;
  }
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Shape {
  int h, w, cin, ho, wo, cout, cinp, kh, kw, stride, pad_t, pad_l;
  int tiles_x, tiles_y;
};

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     void* __restrict__ out, const float* __restrict__ mult,
                     const float* __restrict__ bias, float s_in, Shape sh,
                     int vec_in, int out_bf16, int pair_store) {
  constexpr int BN = 16 * NT;
  extern __shared__ __align__(16) int8_t smem[];
  const int cps = sh.cinp + ROW_PAD;
  const int hh = (TH - 1) * sh.stride + sh.kh;
  const int hw = (TW - 1) * sh.stride + sh.kw;
  int8_t* halo = smem;
  int8_t* ws = smem + hh * hw * cps;

  int b = blockIdx.x;
  const int tx = b % sh.tiles_x;
  b /= sh.tiles_x;
  const int ty = b % sh.tiles_y;
  const int img = b / sh.tiles_y;
  const int oy0 = ty * TH, ox0 = tx * TW;
  const int n0 = blockIdx.y * BN;
  const int iy0 = oy0 * sh.stride - sh.pad_t;
  const int ix0 = ox0 * sh.stride - sh.pad_l;
  const int tid = threadIdx.x;

  // 1. The quantized halo, zeros outside the picture and past cin.
  {
    const int vec = vec_in ? In<T>::VEC : 1;
    const int chunks = sh.cinp / vec;
    const int total = hh * hw * chunks;
    for (int i = tid; i < total; i += THREADS) {
      const int pix = i / chunks;
      const int c = (i - pix * chunks) * vec;
      const int hy = pix / hw, hx = pix - hy * hw;
      const int iy = iy0 + hy, ix = ix0 + hx;
      int8_t* dst = halo + pix * cps + c;
      const bool in = iy >= 0 && iy < sh.h && ix >= 0 && ix < sh.w &&
                      c < sh.cin;
      const T* src =
          x + ((static_cast<int64_t>(img) * sh.h + iy) * sh.w + ix) * sh.cin +
          c;
      if (vec_in) {
        if (in) {
          In<T>::vec(src, dst, s_in);
        } else {
          In<T>::zero(dst);
        }
      } else {
        *dst = in ? In<T>::one(*src, s_in) : static_cast<int8_t>(0);
      }
    }
  }

  // 2. The fragments' places.  Warp (wm, wn) computes output rows 2*wm
  // and 2*wm + 1 of the tile (one m16 tile each: columns g and g + 8 of
  // the fragment are tile columns g and g + 8) and output channels
  // n0 + wn*8*NT ... + 8*NT.
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  int a_off[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      a_off[mt][hf] =
          ((2 * wm + mt) * sh.stride * hw + (g + 8 * hf) * sh.stride) * cps +
          4 * t;
    }
  }
  const int b_off = (wn * 8 * NT + g) * cps + 4 * t;

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0;
    }
  }

  const int taps = sh.kh * sh.kw;
  const int wchunks = sh.cinp / 16;
  for (int tap = 0; tap < taps; ++tap) {
    const int ky = tap / sh.kw, kx = tap - ky * sh.kw;
    __syncthreads();  // the halo is written; the last tap's weights read
    for (int i = tid; i < BN * wchunks; i += THREADS) {
      const int n = i / wchunks, c = (i - n * wchunks) * 16;
      const int8_t* src =
          w + (static_cast<int64_t>(n0 + n) * taps + tap) * sh.cinp + c;
      *reinterpret_cast<int4*>(ws + n * cps + c) =
          __ldg(reinterpret_cast<const int4*>(src));
    }
    __syncthreads();
    const int8_t* hp = halo + (ky * hw + kx) * cps;
    for (int c0 = 0; c0 < sh.cinp; c0 += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p0 = hp + a_off[mt][0] + c0;
        const int8_t* p1 = hp + a_off[mt][1] + c0;
        a[mt][0] = lds32(p0);
        a[mt][1] = lds32(p1);
        a[mt][2] = lds32(p0 + 16);
        a[mt][3] = lds32(p1 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* q = ws + b_off + nt * 8 * cps + c0;
        const uint32_t b0 = lds32(q), b1 = lds32(q + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

  // 3. The epilogue: c0, c1 of a fragment are row g, channels 2t and
  // 2t + 1; c2, c3 the same channels of row g + 8.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = oy0 + 2 * wm + mt;
    if (oy >= sh.ho) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int ox = ox0 + g + 8 * hf;
      if (ox >= sh.wo) continue;
      const int64_t row =
          ((static_cast<int64_t>(img) * sh.ho + oy) * sh.wo + ox) * sh.cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * 8 * NT + nt * 8 + 2 * t;
        if (n >= sh.cout) continue;
        const bool two = n + 1 < sh.cout;
        const int v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
        if (out_bf16) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + row + n;
          const __nv_bfloat16 y0 = __float2bfloat16_rn(
              __fadd_rn(__fmul_rn(__int2float_rn(v0), mult[n]), bias[n]));
          if (two) {
            const __nv_bfloat16 y1 = __float2bfloat16_rn(__fadd_rn(
                __fmul_rn(__int2float_rn(v1), mult[n + 1]), bias[n + 1]));
            if (pair_store) {
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
          int* o = static_cast<int*>(out) + row + n;
          if (two && pair_store) {
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

template <int NT>
constexpr int block_n() {
  return 16 * NT;
}

template <typename T, int NT>
cudaError_t launch(const void* x, const int8_t* w, void* out,
                   const float* mult, const float* bias, float s_in,
                   const Shape& sh, int n, int cout_pad, int vec_in,
                   int out_bf16, int pair_store, cudaStream_t stream) {
  constexpr int BN = block_n<NT>();
  const int64_t grid_x = static_cast<int64_t>(sh.tiles_x) * sh.tiles_y * n;
  const int grid_y = (sh.cout + BN - 1) / BN;
  if (grid_x > 2147483647LL || grid_y > 65535 || grid_y * BN > cout_pad)
    return cudaErrorInvalidValue;
  const int cps = sh.cinp + ROW_PAD;
  const int64_t smem =
      static_cast<int64_t>((TH - 1) * sh.stride + sh.kh) *
          ((TW - 1) * sh.stride + sh.kw) * cps +
      static_cast<int64_t>(BN) * cps;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = int8_conv_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(grid_x), grid_y), THREADS,
           static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(x), w, out, mult, bias, s_in, sh, vec_in,
      out_bf16, pair_store);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(const void* x, const int8_t* w, void* out,
                        const float* mult, const float* bias, float s_in,
                        const Shape& sh, int n, int cout_pad, int vec_in,
                        int out_bf16, int pair_store, cudaStream_t stream) {
  // the narrowest Cout tile that holds all of Cout, up to 128 channels
  const int need = (sh.cout + 15) / 16;
#define LSSVC_INT8_LAUNCH(NT)                                              \
  return launch<T, NT>(x, w, out, mult, bias, s_in, sh, n, cout_pad,      \
                       vec_in, out_bf16, pair_store, stream)
  if (need <= 1) LSSVC_INT8_LAUNCH(1);
  if (need <= 2) LSSVC_INT8_LAUNCH(2);
  if (need <= 4) LSSVC_INT8_LAUNCH(4);
  if (need <= 6) LSSVC_INT8_LAUNCH(6);
  LSSVC_INT8_LAUNCH(8);
#undef LSSVC_INT8_LAUNCH
}

}  // namespace

extern "C" {

// x: (n, h, w, cin) of in_dtype (0: s8, 1: bf16, 2: f32); wk: (cout_pad,
// kh*kw, cinp) s8, 16-byte aligned; out: (n, ho, wo, cout), s32, or bf16
// with out_bf16 (then mult and bias are (cout,) f32).  The caller sizes ho
// and wo from its padding; rows and columns past the input read as zero.
// Returns cudaGetLastError() after the launch (0: launched).
int lssvc_int8_conv(const void* x, const void* wk, void* out,
                    const void* mult, const void* bias, float s_in, int n,
                    int h, int w, int cin, int ho, int wo, int cout,
                    int cout_pad, int cinp, int kh, int kw, int stride,
                    int pad_t, int pad_l, int in_dtype, int out_bf16,
                    void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || ho <= 0 || wo <= 0 ||
      cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || cinp % 32 != 0 ||
      cinp < cin || cout_pad < cout || in_dtype < 0 || in_dtype > 2 ||
      (out_bf16 && (mult == nullptr || bias == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Shape sh;
  sh.h = h;
  sh.w = w;
  sh.cin = cin;
  sh.ho = ho;
  sh.wo = wo;
  sh.cout = cout;
  sh.cinp = cinp;
  sh.kh = kh;
  sh.kw = kw;
  sh.stride = stride;
  sh.pad_t = pad_t;
  sh.pad_l = pad_l;
  sh.tiles_x = (wo + TW - 1) / TW;
  sh.tiles_y = (ho + TH - 1) / TH;
  const int vec = in_dtype == 0 ? 16 : in_dtype == 1 ? 8 : 4;
  const int vec_in =
      cin % vec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int pair_store =
      cout % 2 == 0 &&
      reinterpret_cast<uintptr_t>(out) % (out_bf16 ? 4 : 8) == 0;
  const int8_t* wp = static_cast<const int8_t*>(wk);
  const float* mp = static_cast<const float*>(mult);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 0) {
    err = launch_type<int8_t>(x, wp, out, mp, bp, s_in, sh, n, cout_pad,
                              vec_in, out_bf16, pair_store, st);
  } else if (in_dtype == 1) {
    err = launch_type<__nv_bfloat16>(x, wp, out, mp, bp, s_in, sh, n,
                                     cout_pad, vec_in, out_bf16, pair_store,
                                     st);
  } else {
    err = launch_type<float>(x, wp, out, mp, bp, s_in, sh, n, cout_pad,
                             vec_in, out_bf16, pair_store, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"

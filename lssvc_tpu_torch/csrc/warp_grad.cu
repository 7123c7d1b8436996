// Backward kernels of the bilinear warps for Hopper (sm_90a), plain C
// interface.
//
// What they stand for.  The JAX package trains through no Pallas kernel:
// its train step routes every warp through the XLA formulas
// (lssvc_tpu/ops/warp_pallas.py set_warp_differentiable) and lets XLA take
// their gradient:
//   flow_warp_backward     the gradient of lssvc_tpu/ops/warp.py flow_warp
//                          (taken at warp_pallas.py:1262), for one source
//                          or for the pair [a, b] of flow_warp_pair (both
//                          sources, one summed flow gradient, one launch);
//   grouped_warp_backward  the gradient of the grouped formula _slow_eager
//                          (warp_pallas.py:1372-1378, through
//                          lssvc_tpu/ops/warp.py flow_warp_grouped).
// Each computes what jax.grad of that formula computes:
//   out = top * (1 - wy) + bot * wy,
//   top = v00 * (1 - wx) + v01 * wx,  bot = v10 * (1 - wx) + v11 * wx,
//   px = clip(ix + fx, 0, W - 1), wx = px - floor(px)  (y likewise),
// so, with g the output gradient,
//   grad_x  at the four taps: g (1-wy)(1-wx), g (1-wy) wx, g wy (1-wx),
//           g wy wx, added where taps of several outputs meet;
//   grad_fx = sum over channels of g (1-wy)(v01 - v00) + g wy (v11 - v10),
//   grad_fy = sum over channels of g (bot - top),
// each flow gradient times the clip's factor: 1 inside [0, S-1], 0
// outside, 1/2 on a bound (jnp.clip is min(max(x, lo), hi), and a tie of
// jnp.maximum or jnp.minimum gives each side half; a NaN passes with
// factor 1, as torch.maximum's gradient gives it; outside, the gradient
// is 0 even where the sum is NaN).  The grouped warp's
// output is mask_j times the warp of source channel (j % group_num)*cg + k
// by unit j's flow (block layout, channel k*go + j), so its g is g * mask
// and grad_mask_j is the sum over k of g times the unmasked warp.
//
// Bound: bytes.  A launch must read the output gradient, the source (for
// the flow and mask gradients), the flows (and mask) once, and write the
// source gradient and the flow (and mask) gradients once: at the 1080p EL
// pair (1x1152x1920x(3+48) f32) 1.39 GB, 0.41 ms at 3.35 TB/s.
//
// The scatter.  The source gradient is a scatter: the four taps of
// neighbouring outputs meet on one source pixel.  The first design summed
// it with four scalar f32 atomicAdds straight to global memory per (pixel,
// channel): at the EL pair 451 M atomics, six times the bound, and the
// grouped warp, whose lanes were units with their own flows, put each
// atomic and each tap load on its own sector (a reduction whose 32 lanes
// hit 32 pixels runs at 16 G/s on an H100 where contiguous ones run at
// 236 G/s, measured).  A bf16 source's gradient is summed in f32 and
// rounded once by lssvc_f32_to_bf16: whether a source pixel's contributors
// all lie in one block is known only after every block has run.
//
// flow_warp_backward: direct vector reductions, taps merged in registers.
// A thread takes a run of 2 pixels of a row and, in turn, the units (4
// channels, or 1 where a pixel's channels are no whole units or the
// pointers unaligned) of its lane: 4 lanes a run, so a warp's reductions
// fall on 8 runs x 64 contiguous bytes.  Along the run, a pixel's two tap
// columns (top and bottom rows each) merge with the column pending from the
// pixel before where they meet, the usual case of a smooth flow: 3 columns
// for 2 pixels where the parent added 4 a pixel, each row of a column one
// red.global.add.v4.f32 (a scalar red where units are single channels).
// Runs of 1, 4 and 8 pixels measured 1.26, 1.39 and 1.47 ms against 1.23
// at the EL pair f32 on smooth flows (longer runs cost registers: 172 at
// 4).  A shared-memory box per output tile, flushed once, was built first
// and measured slower at every case (at the EL pair 2.23 ms f32 on smooth
// flows against 1.28 for direct reductions): Hopper has no shared f32
// atomic add (atomicAdd on shared memory compiles to a compare-and-swap
// loop, half a plain read-modify-write's rate), while contiguous vector
// reductions to lines the neighbouring pixels just touched are served by
// L2.  The flow gradient is each lane's sum over its channels in a fixed
// order, then a sum over the run's 4 lanes by shuffles: no atomics, the
// same bits every launch.
//
// grouped_warp_backward: a shared-memory box per unit.  A block takes 8 x 8
// output pixels and first copies their output gradient (all go*cg
// channels), flows and mask into shared memory with coalesced 16-byte
// loads; a warp then takes whole groups, each unit of a group with its 32
// lanes over 4 x 8 neighbouring pixels (two such blocks make the tile), so
// one instruction's taps fall on neighbouring source pixels.  A unit's 3
// channels are 12 bytes of a 192-byte pixel, so its direct reductions hit a
// sector a lane; instead its taps are added into a box in the warp's
// shared memory covering its own footprint (the units of one group, j and
// j+16 in the model, share one box where their union is no larger than the
// two), and the box is flushed once, skipping pixels it did not reach.
// The box takes shared-memory atomics (a plain read-modify-write for the
// lanes whose tap no other lane shares, found with __match_any_sync and a
// __syncwarp a tap, measured 17% slower at the 1080p smooth case).  A
// footprint larger than the box (far-reaching or NaN flows, which clamp to
// row and column 0) scatters straight to global memory.  The model's shape
// (cg = 3, go = 32, 16 groups, x and the accumulator 16-byte aligned)
// loads a group's 3 channels as one 2-channel and one 1-channel load by
// the group's alignment, and adds them to gx the same way (a .v2 and a
// scalar reduction); other shapes take the same kernel with runtime
// constants and one access per channel.  The flow and mask gradients of a
// (pixel, unit) are summed over its channels in one thread, written into
// the staged flows in place and stored out coalesced in the block layout.
//
// The fixed-order variant (`lssvc_*_backward_fixed`, what the wrappers
// launch under torch.use_deterministic_algorithms).  The f32 sums above
// take their contributions in the order the threads run, so two launches
// may differ in the last bits.  This variant converts each tap's value v
// on its own to the integer round(v * 2^s) and sums the integers exactly
// in 64 bits, whose sums are the same in any order, then turns each sum
// into f32 (or bf16) once: the plain version (`ops/warp_kernels.py`
// `*_fixed_plain`, an int64 index_add_ of the same integers) is its bits.
// s comes from one max reduction over the output gradient (times one over
// the mask for the grouped warp), M <= 2^e: a source element takes at
// most K contributions of size M (each output pixel's four tap weights sum
// to 1, and taps past a border clamp onto the edge pixels; K = h * w,
// times a group's units for the grouped warp), so s = 62 - ceil(log2 K) -
// e leaves no sum room to overflow.  At the 1080p EL pair a value's grid
// is M * 2^-40, far below f32's rounding of the default path.  A
// non-finite value sets a byte of flags of its element (+inf, -inf, NaN),
// from which the element's f32 sum of non-finite values follows, whatever
// the order.
// Hopper has no vector integer reduction, and a 64-bit shared-memory
// atomic add compiles to a compare-and-swap loop (`ATOMS.CAST.SPIN.64`;
// `tools/atomics_bench.py`): the boxes below add 64-bit integers as two
// native 32-bit adds, the low word's returned value giving the carry
// (`smem_add64`).
// The pair: `fx_cover_kernel` first counts, for each source pixel, the
// tiles of 8 x 32 output pixels whose taps touch it.  Then
// `flow_warp_backward_fixed_kernel`, a thread a pixel, sums a tile's taps
// into a shared-memory box of its footprint, kFxChunk channels a pass; a
// near tile (footprint within kFxReachY rows and kFxReachX columns, at
// most kFxArea pixels) finishes the pixels its taps alone touch straight
// into the gradient and stores the values of the others (a bit a pixel,
// ranked) into its own slot of a workspace; `fx_gather_kernel` adds, for
// each such element, the slot values of the near tiles whose footprint
// holds it (at most 15, a list a pixel), converts once and writes it: no
// accumulator to zero and read back, no global reduction.  A far tile
// adds into 64-bit global sums, which the gather reads where a far tile's
// tap touched the pixel.  The grouped warp keeps the default kernel's
// template: its box per unit (or group) holds 64-bit
// values, flushed with lanes over a pixel's contiguous channels, and a
// finish pass converts the global sums.  The flow and mask gradients are
// one thread's sums in a fixed order in both.
//
// Arithmetic is f32 with explicit round-to-nearest intrinsics (no FMA
// contraction); indices are clamped into range after conversion, as in
// warp.cu, so a NaN flow never reads or writes out of range; offsets are
// 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// N values of T at p as f32: one 16- or 8-byte load where N values are
// 16 or 8 bytes (p then aligned to them), else one load a value.
template <typename T, int N>
__device__ __forceinline__ void ld_n(const T* p, float* v) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(u[i]);
      } else {  // bf16 is the top half of an f32
        v[2 * i] = __uint_as_float(u[i] << 16);
        v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
  } else if constexpr (N * sizeof(T) == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    const uint32_t u[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(u[i]);
      } else {
        v[2 * i] = __uint_as_float(u[i] << 16);
        v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = ld(p, i);
  }
}

// two values of T at p (8-byte aligned f32, 4-byte aligned bf16)
__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 r = __ldg(reinterpret_cast<const float2*>(p));
  a = r.x;
  b = r.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float& a,
                                    float& b) {
  const uint32_t r = __ldg(reinterpret_cast<const unsigned int*>(p));
  a = __uint_as_float(r << 16);
  b = __uint_as_float(r & 0xffff0000u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Reductions into global f32 (16- and 8-byte aligned for .v4 and .v2).
__device__ __forceinline__ void red4(float* p, float a, float b, float c,
                                     float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}
__device__ __forceinline__ void red2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a),
               "f"(b)
               : "memory");
}

// The fixed-order variant's scale exponent s from the maxima mx[0..slots)
// (f32 bits of each, finite values only) and the most contributions k an
// element takes: k * prod(mx) * 2^s <= 2^62, s within f32's normal range.
__device__ __forceinline__ int fixed_exp(const unsigned* mx, int slots,
                                         long long k) {
  int e = 0;
  for (int i = 0; i < slots; ++i) {
    int ei;
    frexpf(__uint_as_float(mx[i]), &ei);  // mx < 2^ei (0 for 0)
    e += ei;
  }
  int lk = 0;
  while ((1LL << lk) < k) ++lk;
  const int s = 62 - lk - e;
  return s < -126 ? -126 : (s > 126 ? 126 : s);
}

// 2^s for s in [-126, 127]
__device__ __forceinline__ float pow2(int s) {
  return __int_as_float((s + 127) << 23);
}

// The fixed-order variant's non-finite contributions: a byte of flags an
// element (1 +inf, 2 -inf, 4 NaN) in 32-bit words, set by atomicOr.  Their
// f32 sum, which does not depend on the order, follows from the flags:
// NaN where a NaN or both infinities came, else the infinity that came.
constexpr unsigned kPosInf = 1u, kNegInf = 2u, kNaN = 4u;

__device__ __forceinline__ void nonfinite_add(unsigned* flags, int64_t i,
                                              float v) {
  const unsigned bit = isnan(v) ? kNaN : (v > 0.f ? kPosInf : kNegInf);
  atomicOr(flags + (i >> 2), bit << (8 * (int)(i & 3)));
}

// v into element i of the fixed-point sums q (scaled by `scale`), or of
// the non-finite flags
__device__ __forceinline__ void fixed_add(unsigned long long* q,
                                          unsigned* flags, int64_t i, float v,
                                          float scale) {
  if (v == 0.f) return;
  if (isfinite(v)) {
    atomicAdd(q + i,
              (unsigned long long)__float2ll_rn(__fmul_rn(v, scale)));
  } else {
    nonfinite_add(flags, i, v);
  }
}

// The largest finite |x[i]| into *out (as f32 bits, which order as
// unsigned integers for values >= 0); four values a load where x is 16-
// or 8-byte aligned (vec), the last n % 4 one at a time.
template <typename T>
__global__ void absmax_kernel(const T* __restrict__ x, int64_t n,
                              unsigned* __restrict__ out, int vec) {
  float m = 0.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t head = vec ? n / 4 * 4 : 0;
  for (int64_t i = first; i < head / 4; i += stride) {
    float v[4];
    ld_n<T, 4>(x + 4 * i, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = fabsf(v[k]);
      if (a <= FLT_MAX) m = fmaxf(m, a);  // not inf, not NaN
    }
  }
  for (int64_t i = head + first; i < n; i += stride) {
    const float v = fabsf(to_f32(x[i]));
    if (v <= FLT_MAX) m = fmaxf(m, v);
  }
  const unsigned b = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  if (threadIdx.x % 32 == 0 && b != 0) atomicMax(out, b);
}

// The finished value of a 64-bit fixed-point sum v (scaled by 1 / inv)
// with non-finite flags f (NaN as 0x7fc00000, bf16 0x7fc0): f32 rounded
// once; bf16 by way of f32 rounded to odd, which bf16's rounding then
// rounds as it would the exact value.
template <typename T>
__device__ __forceinline__ T finish_value(long long v, unsigned f,
                                          float inv) {
  if constexpr (sizeof(T) == 4) {
    return f == 0 ? __fmul_rn(__ll2float_rn(v), inv)
           : (f & kNaN) || f == (kPosInf | kNegInf)
               ? __int_as_float(0x7fc00000)
               : __int_as_float(f == kPosInf ? 0x7f800000 : 0xff800000);
  } else {
    if (f != 0) {
      return __ushort_as_bfloat16(
          (f & kNaN) || f == (kPosInf | kNegInf)
              ? (unsigned short)0x7fc0
              : (unsigned short)(f == kPosInf ? 0x7f80 : 0xff80));
    }
    float r = __ll2float_rz(v);
    if (__float2ll_rz(r) != v) r = __uint_as_float(__float_as_uint(r) | 1u);
    return __float2bfloat16_rn(__fmul_rn(r, inv));
  }
}

// out[i] = the finished value of the fixed-point sum q[i] with the flags
// of element i, four elements a thread where n, q, flags and out allow
// 16-byte loads (q: 32 bytes) and a store of four values.
template <typename T>
__global__ void fixed_finish_kernel(const long long* __restrict__ q,
                                    const unsigned char* __restrict__ flags,
                                    T* __restrict__ out, int64_t n,
                                    const unsigned* __restrict__ mx,
                                    int slots, long long k, int vec) {
  const float inv = pow2(-fixed_exp(mx, slots, k));
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (vec) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < n / 4; i += stride) {
      const longlong2 lo = reinterpret_cast<const longlong2*>(q)[2 * i];
      const longlong2 hi = reinterpret_cast<const longlong2*>(q)[2 * i + 1];
      const unsigned f = reinterpret_cast<const unsigned*>(flags)[i];
      const T r0 = finish_value<T>(lo.x, f & 0xffu, inv);
      const T r1 = finish_value<T>(lo.y, (f >> 8) & 0xffu, inv);
      const T r2 = finish_value<T>(hi.x, (f >> 16) & 0xffu, inv);
      const T r3 = finish_value<T>(hi.y, f >> 24, inv);
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<float4*>(out)[i] = make_float4(r0, r1, r2, r3);
      } else {
        uint2 packed;
        packed.x = (unsigned)__bfloat16_as_ushort(r0) |
                   ((unsigned)__bfloat16_as_ushort(r1) << 16);
        packed.y = (unsigned)__bfloat16_as_ushort(r2) |
                   ((unsigned)__bfloat16_as_ushort(r3) << 16);
        reinterpret_cast<uint2*>(out)[i] = packed;
      }
    }
    return;
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = finish_value<T>(q[i], flags[i], inv);
  }
}

// One axis of a sample: clip(pos + f, 0, size-1) -> (i0, i1, frac) as in
// warp.cu, and the clip's gradient factor, as torch.minimum(torch.maximum(
// p, 0), size-1) differentiates it (the JAX package's jnp.clip).
struct Axis {
  int i0, i1;
  float frac, dclip;
};

__device__ __forceinline__ Axis axis(float f, int pos, int size) {
  Axis a;
  const float hi = (float)(size - 1);
  float p = __fadd_rn((float)pos, f);
  // max(p, 0): 0 below, 1/2 on the tie, 1 above or NaN
  float d = p < 0.f ? 0.f : (p == 0.f ? 0.5f : 1.f);
  p = p < 0.f ? 0.f : p;
  // min(m, hi): 0 above, 1/2 on the tie, 1 below or NaN
  d *= p > hi ? 0.f : (p == hi ? 0.5f : 1.f);
  p = p > hi ? hi : p;
  const float p0 = floorf(p);
  a.frac = __fsub_rn(p, p0);
  int k = __float2int_rz(p0);  // NaN -> 0
  k = k < 0 ? 0 : (k > size - 1 ? size - 1 : k);
  a.i0 = k;
  a.i1 = k + 1 > size - 1 ? size - 1 : k + 1;
  a.dclip = d;
  return a;
}

// The gradient s through the clip of factor d: a sample outside the clip
// takes exactly 0, even where s is NaN (the bound's gradient is a select,
// in torch and in JAX alike).
__device__ __forceinline__ float clipped(float s, float d) {
  return d == 0.f ? 0.f : __fmul_rn(s, d);
}

// A box of source pixels: rows [y0, y0 + bh), columns [x0, x0 + bw).
struct Box {
  int y0, x0, bh, bw;
  __device__ __forceinline__ long long area() const {
    return (long long)bh * bw;
  }
  // box pixel of source pixel (y, x)
  __device__ __forceinline__ int at(int y, int x) const {
    return (y - y0) * bw + (x - x0);
  }
};

// The box of (ylo..yhi, xlo..xhi) over the lanes of a warp (each lane's
// own bounds; INT_MAX / -1 for a lane with none).
__device__ __forceinline__ void warp_bounds(int& ylo, int& yhi, int& xlo,
                                            int& xhi) {
  ylo = __reduce_min_sync(0xffffffffu, ylo);
  yhi = __reduce_max_sync(0xffffffffu, yhi);
  xlo = __reduce_min_sync(0xffffffffu, xlo);
  xhi = __reduce_max_sync(0xffffffffu, xhi);
}

// ---------------------------------------------------------------------------
// flow_warp_backward

constexpr int kFwRun = 2;  // pixels of a row a thread takes
constexpr int kFwG = 4;    // lanes a run: a pixel's units in turn
constexpr int kFwThreads = 256;
constexpr int kFwRunsPerBlock = kFwThreads / kFwG;
constexpr int kFwBlockPix = kFwRunsPerBlock * kFwRun;  // a row's pixels

// One source of flow_warp_backward: x (N, H, W, c), the output gradient g
// of the same shape, and gx, the f32 accumulator of x's gradient (null
// when x needs none).  c = 0: no source.  vec: units of 4 channels (c % 4
// == 0, x and g aligned to 4 elements, gx to 16 bytes), else of one
// channel.
template <typename T>
struct Src {
  const T* x;
  const T* g;
  float* gx;
  int c;
  int vec;
  __device__ __forceinline__ bool grad() const { return gx != nullptr; }
};

// A source column of a run's scatter: CHU channels added at rows y0 (top)
// and y1 (bot) of column x; top alone where y0 == y1.
template <int CHU>
struct Col {
  int x, y0, y1;
  float top[CHU], bot[CHU];
};

template <int CHU>
__device__ __forceinline__ void red_n(float* p, const float* v) {
  if constexpr (CHU == 4) {
    red4(p, v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < CHU; ++i) atomicAdd(p + i, v[i]);
  }
}

// A column's values into the source's gradient (channels ch.. of pixel
// rows of image row0) by f32 reductions.
template <int CHU, typename T>
__device__ __forceinline__ void col_out(const Col<CHU>& col, const Src<T>& s,
                                        int ch, int64_t row0, int w) {
  const int64_t i0 = ((row0 + col.y0) * w + col.x) * s.c + ch;
  const int64_t i1 = ((row0 + col.y1) * w + col.x) * s.c + ch;
  red_n<CHU>(s.gx + i0, col.top);
  if (col.y1 != col.y0) red_n<CHU>(s.gx + i1, col.bot);
}

// The samples of a thread's run of pixels.
struct Run {
  int x0[kFwRun], y0[kFwRun];
  float wx[kFwRun], wy[kFwRun], dx[kFwRun], dy[kFwRun];
};

// One source's part of a run: for each of the lane's units, the run's
// pixels in order, each pixel's two tap columns merged with the column
// pending from the pixel before where they meet, the flow gradient's terms
// into sx, sy (one entry per pixel).
template <typename T, int CHU>
__device__ __forceinline__ void fw_source(const Src<T>& s, const Run& r,
                                          int npx, int64_t row0, int iy,
                                          int xs, int h, int w,
                                          bool flow_grad, float* sx,
                                          float* sy) {
  if (s.c == 0 || (!s.grad() && !flow_grad)) return;
  const int units = s.c / CHU;
  for (int u = threadIdx.x % kFwG; u < units; u += kFwG) {
    const int ch = u * CHU;
    Col<CHU> pend;
    bool have = false;
#pragma unroll
    for (int i = 0; i < kFwRun; ++i) {
      if (i >= npx) break;
      const int64_t pix = (row0 + iy) * w + xs + i;
      const int x0 = r.x0[i], y0 = r.y0[i];
      const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
      const float wx = r.wx[i], wy = r.wy[i];
      const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
      float g[CHU];
      ld_n<T, CHU>(s.g + pix * s.c + ch, g);
      if (flow_grad) {
        const int64_t q[4] = {(row0 + y0) * w + x0, (row0 + y0) * w + x1,
                              (row0 + y1) * w + x0, (row0 + y1) * w + x1};
        float v[4][CHU];
#pragma unroll
        for (int t = 0; t < 4; ++t) ld_n<T, CHU>(s.x + q[t] * s.c + ch, v[t]);
#pragma unroll
        for (int k = 0; k < CHU; ++k) {
          const float gt = __fmul_rn(g[k], ay);  // the gradient of top
          const float gb = __fmul_rn(g[k], wy);  // of bot
          const float top =
              __fadd_rn(__fmul_rn(v[0][k], ax), __fmul_rn(v[1][k], wx));
          const float bot =
              __fadd_rn(__fmul_rn(v[2][k], ax), __fmul_rn(v[3][k], wx));
          sx[i] = __fadd_rn(
              sx[i], __fadd_rn(__fmul_rn(gt, __fsub_rn(v[1][k], v[0][k])),
                               __fmul_rn(gb, __fsub_rn(v[3][k], v[2][k]))));
          sy[i] = __fadd_rn(sy[i], __fmul_rn(g[k], __fsub_rn(bot, top)));
        }
      }
      if (!s.grad()) continue;
      Col<CHU> left{x0, y0, y1}, right{x1, y0, y1};
#pragma unroll
      for (int k = 0; k < CHU; ++k) {
        const float gt = __fmul_rn(g[k], ay);
        const float gb = __fmul_rn(g[k], wy);
        left.top[k] = __fmul_rn(gt, ax);
        left.bot[k] = __fmul_rn(gb, ax);
        right.top[k] = __fmul_rn(gt, wx);
        right.bot[k] = __fmul_rn(gb, wx);
        if (y1 == y0) {  // on the last row both rows are one
          left.top[k] = __fadd_rn(left.top[k], left.bot[k]);
          right.top[k] = __fadd_rn(right.top[k], right.bot[k]);
        }
        if (x1 == x0) {  // on the last column both columns are one
          left.top[k] = __fadd_rn(left.top[k], right.top[k]);
          left.bot[k] = __fadd_rn(left.bot[k], right.bot[k]);
        }
      }
      if (have && pend.x == x0 && pend.y0 == y0 && pend.y1 == y1) {
        // the previous pixel's right column is this one's left
#pragma unroll
        for (int k = 0; k < CHU; ++k) {
          left.top[k] = __fadd_rn(pend.top[k], left.top[k]);
          left.bot[k] = __fadd_rn(pend.bot[k], left.bot[k]);
        }
        have = false;
      }
      if (have) col_out<CHU>(pend, s, ch, row0, w);
      if (x1 != x0) {
        col_out<CHU>(left, s, ch, row0, w);
        pend = right;
      } else {
        pend = left;
      }
      have = true;
    }
    if (have) col_out<CHU>(pend, s, ch, row0, w);
  }
}

// Block: kFwBlockPix pixels of row blockIdx.y of image blockIdx.z from
// column blockIdx.x * kFwBlockPix; thread (run, lane) takes kFwRun pixels
// of them.  gflow (N, H, W, 2) f32, null when the flow needs no gradient.
template <typename T>
__global__ void __launch_bounds__(kFwThreads)
    flow_warp_backward_kernel(Src<T> a, Src<T> b,
                              const float* __restrict__ flow,
                              float* __restrict__ gflow, int h, int w) {
  const int iy = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * h;  // the image's first row
  const int xs = blockIdx.x * kFwBlockPix + threadIdx.x / kFwG * kFwRun;
  const int npx = min(kFwRun, w - xs);  // <= 0 past the row's end
  Run r;
#pragma unroll
  for (int i = 0; i < kFwRun; ++i) {
    if (i >= npx) break;
    const int64_t pix = (row0 + iy) * w + xs + i;
    const Axis ax = axis(__ldg(flow + 2 * pix), xs + i, w);
    const Axis ay = axis(__ldg(flow + 2 * pix + 1), iy, h);
    r.x0[i] = ax.i0;
    r.y0[i] = ay.i0;
    r.wx[i] = ax.frac;
    r.wy[i] = ay.frac;
    r.dx[i] = ax.dclip;
    r.dy[i] = ay.dclip;
  }
  const bool flow_grad = gflow != nullptr;
  float sx[kFwRun], sy[kFwRun];
#pragma unroll
  for (int i = 0; i < kFwRun; ++i) sx[i] = sy[i] = 0.f;
  if (a.vec) {
    fw_source<T, 4>(a, r, npx, row0, iy, xs, h, w, flow_grad, sx, sy);
  } else {
    fw_source<T, 1>(a, r, npx, row0, iy, xs, h, w, flow_grad, sx, sy);
  }
  if (b.vec) {
    fw_source<T, 4>(b, r, npx, row0, iy, xs, h, w, flow_grad, sx, sy);
  } else {
    fw_source<T, 1>(b, r, npx, row0, iy, xs, h, w, flow_grad, sx, sy);
  }
  if (!flow_grad) return;
#pragma unroll
  for (int i = 0; i < kFwRun; ++i) {
#pragma unroll
    for (int o = kFwG / 2; o > 0; o >>= 1) {
      sx[i] = __fadd_rn(sx[i], __shfl_xor_sync(0xffffffffu, sx[i], o));
      sy[i] = __fadd_rn(sy[i], __shfl_xor_sync(0xffffffffu, sy[i], o));
    }
    if (threadIdx.x % kFwG == 0 && i < npx) {
      const int64_t pix = (row0 + iy) * w + xs + i;
      reinterpret_cast<float2*>(gflow)[pix] =
          make_float2(clipped(sx[i], r.dx[i]), clipped(sy[i], r.dy[i]));
    }
  }
}

// ---------------------------------------------------------------------------
// flow_warp_backward_fixed: per-tile boxes of 64-bit sums, gathered

constexpr int kFxTw = 32, kFxTh = 8, kFxThreads = kFxTw * kFxTh;
constexpr int kFxCap = 8192;  // 64-bit values of a block's box: 64 KB
constexpr int kFxChunk = 16;  // channels of a source a pass of the box takes
// A tile is near where its footprint lies within kFxReachY rows and
// kFxReachX columns of the tile and covers at most kFxArea pixels: its box
// is stored in its slot of kFxArea pixels and gathered; the footprints of
// other tiles are far and add straight into the global sums.
constexpr int kFxReachY = 16, kFxReachX = 32, kFxArea = 1024;
// the most near tiles whose footprints can hold a pixel: 5 tile rows x 3
// tile columns
constexpr int kFxList = 16;
// a source pixel's cover: the near tiles whose taps touch it, and this bit
// where a far tile's tap does
constexpr int kFxFarBit = 1 << 30;
// the tiles whose footprints can hold a pixel of a gather block: 6 tile
// rows x 4 tile columns around its own tile
constexpr int kFxCand = 24;

// x into the 64-bit integer at p of shared memory, exactly, by two native
// 32-bit atomic adds (a 64-bit shared-memory add compiles to a
// compare-and-swap loop): the low word, and the high word with the carry
// out of the low one.  The sum of any adds in any order is their sum
// modulo 2^64.
__device__ __forceinline__ void smem_add64(unsigned long long* p,
                                           unsigned long long x) {
  unsigned* word = reinterpret_cast<unsigned*>(p);
  const unsigned lo = (unsigned)x, hi = (unsigned)(x >> 32);
  const unsigned old = atomicAdd(word, lo);
  const unsigned carry = old + lo < old ? 1u : 0u;
  if (hi + carry != 0) atomicAdd(word + 1, hi + carry);
}

// One source of the fixed-order variant: x (N, H, W, c), its output
// gradient g, the global fixed-point sums q, non-finite flags and tile
// slots of its gradient (null when x needs none), the gradient out; vec as
// in Src.
template <typename T>
struct FxSrc {
  const T* x;
  const T* g;
  unsigned long long* q;
  unsigned* flags;
  long long* slots;
  T* out;
  int c;
  int vec;
};

// A thread's pixel: its four taps (global pixel indices) and their
// places in the box, the sample's weights and clip factors.
struct FxPix {
  int64_t tap[4];
  int bq[4];
  float wx, wy, dx, dy;
  bool ok;
};

// Channels [c0, c0 + cw) of source s at the thread's pixel: each tap's
// value converted to a 64-bit integer on its own and added into the box
// (`boxed`, pixel-major with `stride` values a pixel) or straight into
// s.q; the flow gradient's terms added into sx, sy channel by channel.
// A non-finite value sets its flags and *nf.
template <typename T, int U>
__device__ __forceinline__ void fx_pass(const FxSrc<T>& s, const FxPix& px,
                                        int64_t pix, int c0, int cw,
                                        bool grad, bool flow_grad,
                                        unsigned long long* box, int stride,
                                        bool boxed, float scale, float& sx,
                                        float& sy, int* nf) {
  const float ax = __fsub_rn(1.f, px.wx), ay = __fsub_rn(1.f, px.wy);
  for (int k0 = 0; k0 < cw; k0 += U) {
    const int ch = c0 + k0;
    float g[U];
    ld_n<T, U>(s.g + pix * s.c + ch, g);
    if (flow_grad) {
      float v[4][U];
#pragma unroll
      for (int t = 0; t < 4; ++t) ld_n<T, U>(s.x + px.tap[t] * s.c + ch, v[t]);
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const float gt = __fmul_rn(g[k], ay);
        const float gb = __fmul_rn(g[k], px.wy);
        const float top =
            __fadd_rn(__fmul_rn(v[0][k], ax), __fmul_rn(v[1][k], px.wx));
        const float bot =
            __fadd_rn(__fmul_rn(v[2][k], ax), __fmul_rn(v[3][k], px.wx));
        sx = __fadd_rn(
            sx, __fadd_rn(__fmul_rn(gt, __fsub_rn(v[1][k], v[0][k])),
                          __fmul_rn(gb, __fsub_rn(v[3][k], v[2][k]))));
        sy = __fadd_rn(sy, __fmul_rn(g[k], __fsub_rn(bot, top)));
      }
    }
    if (!grad) continue;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const float gt = __fmul_rn(g[k], ay);
      const float gb = __fmul_rn(g[k], px.wy);
      const float tv[4] = {__fmul_rn(gt, ax), __fmul_rn(gt, px.wx),
                           __fmul_rn(gb, ax), __fmul_rn(gb, px.wx)};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float v = tv[t];
        if (v == 0.f) continue;
        if (!isfinite(v)) {
          nonfinite_add(s.flags, px.tap[t] * s.c + ch + k, v);
          *nf = 1;
          continue;
        }
        const unsigned long long iv =
            (unsigned long long)__float2ll_rn(__fmul_rn(v, scale));
        if (boxed) {
          smem_add64(box + px.bq[t] * stride + k0 + k, iv);
        } else {
          atomicAdd(s.q + px.tap[t] * s.c + ch + k, iv);
        }
      }
    }
  }
}

// A near tile's touched box pixels, by the cover of each: `excl` (its
// taps alone touch it) and `shared` (another tile's too), each in rank
// order (the box pixel of each rank) with its count.
struct FxOrder {
  const int* excl;
  const int* shared;
  int n_excl, n_shared;
};

// A near tile's part of `fx_flush`, U channels a thread (U = 4: one
// 16- or 8-byte store of the finished values, two 16-byte slot stores).
template <typename T, int U>
__device__ __forceinline__ void fx_flush_near(
    const FxSrc<T>& s, const Box& b, const FxOrder& ord, int64_t tile,
    int64_t row0, int w, int c0, int cw, unsigned long long* box, int stride,
    float inv, const int* nf) {
  const int units = cw / U;
  for (int i = threadIdx.x; i < ord.n_excl * units; i += kFxThreads) {
    const int r = i / units, k = (i - r * units) * U;
    const int bp = ord.excl[r];
    unsigned long long* p = box + bp * stride + k;
    const int by = bp / b.bw, bx = bp - by * b.bw;
    const int64_t e = ((row0 + b.y0 + by) * w + b.x0 + bx) * s.c + c0 + k;
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned f =
          *nf ? reinterpret_cast<const unsigned char*>(s.flags)[e + u] : 0u;
      v[u] = finish_value<T>((long long)p[u], f, inv);
      p[u] = 0;
    }
    if constexpr (U == 4 && sizeof(T) == 4) {
      *reinterpret_cast<float4*>(s.out + e) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
    } else if constexpr (U == 4) {
      uint2 packed;
      packed.x = (unsigned)__bfloat16_as_ushort(v[0]) |
                 ((unsigned)__bfloat16_as_ushort(v[1]) << 16);
      packed.y = (unsigned)__bfloat16_as_ushort(v[2]) |
                 ((unsigned)__bfloat16_as_ushort(v[3]) << 16);
      *reinterpret_cast<uint2*>(s.out + e) = packed;
    } else {
      s.out[e] = v[0];
    }
  }
  long long* slot = s.slots + tile * kFxArea * s.c + c0;
  for (int i = threadIdx.x; i < ord.n_shared * units; i += kFxThreads) {
    const int r = i / units, k = (i - r * units) * U;
    unsigned long long* p = box + ord.shared[r] * stride + k;
    long long* dst = slot + (int64_t)r * s.c + k;
    if constexpr (U == 4) {
      reinterpret_cast<longlong2*>(dst)[0] =
          make_longlong2((long long)p[0], (long long)p[1]);
      reinterpret_cast<longlong2*>(dst)[1] =
          make_longlong2((long long)p[2], (long long)p[3]);
    } else {
      dst[0] = (long long)p[0];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] = 0;
  }
}

// The box's values of channels [c0, c0 + cw), each set back to 0.  A near
// tile: a pixel only its taps touched is finished here (the gradient in
// out, its flags read where the block met a non-finite value, *nf); the
// others go to its slot, a pixel's c values at its rank among them.  A far
// tile: its nonzero values into s.q.  Lanes over (pixel, channel), so
// that a warp's stores and reductions fall on neighbouring pixels'
// contiguous channels.
template <typename T>
__device__ __forceinline__ void fx_flush(const FxSrc<T>& s, const Box& b,
                                         bool near, const FxOrder& ord,
                                         int64_t tile, int64_t row0, int w,
                                         int c0, int cw,
                                         unsigned long long* box, int stride,
                                         float inv, const int* nf) {
  if (near) {
    if (s.vec) {  // cw % 4 == 0: four channels a thread
      fx_flush_near<T, 4>(s, b, ord, tile, row0, w, c0, cw, box, stride, inv,
                          nf);
    } else {
      fx_flush_near<T, 1>(s, b, ord, tile, row0, w, c0, cw, box, stride, inv,
                          nf);
    }
    return;
  }
  const int n = b.bh * b.bw * cw;
  for (int i = threadIdx.x; i < n; i += kFxThreads) {
    const int bp = i / cw, k = i - bp * cw;
    unsigned long long* p = box + bp * stride + k;
    const unsigned long long v = *p;
    if (v != 0) {
      const int by = bp / b.bw, bx = bp - by * b.bw;
      atomicAdd(s.q + ((row0 + b.y0 + by) * w + b.x0 + bx) * s.c + c0 + k,
                v);
      *p = 0;
    }
  }
}

// The channels a pass of the box takes for a source of c channels whose
// footprint covers `area` pixels: the most (a multiple of 4 for vec, at
// most kFxChunk) whose box, an odd number of values a pixel (no two
// neighbouring pixels' values on one bank), fits kFxCap; 0: none fits.
__device__ __forceinline__ int fx_chunk(int c, bool vec, long long area) {
  int ch = min(c, kFxChunk);
  if (vec) ch &= ~3;
  while (ch > 0 && area * (ch | 1) > kFxCap) ch -= vec ? 4 : 1;
  return ch;
}

// One source of a block: its channels in passes of the box (or, where no
// box fits a far footprint, straight to global memory).
template <typename T>
__device__ void fx_source(const FxSrc<T>& s, const FxPix& px, int64_t pix,
                          const Box& b, bool near, const FxOrder& ord,
                          int64_t tile, int64_t row0, int w, bool flow_grad,
                          unsigned long long* box, float scale, float& sx,
                          float& sy, int* nf) {
  const bool grad = s.q != nullptr;
  if (s.c == 0 || (!grad && !flow_grad)) return;
  int ch = grad ? fx_chunk(s.c, s.vec, b.area()) : 0;
  const bool boxed = ch > 0;
  if (!boxed) ch = s.vec ? min(s.c, kFxChunk) & ~3 : min(s.c, kFxChunk);
  const int stride = ch | 1;
  for (int c0 = 0; c0 < s.c; c0 += ch) {
    const int cw = min(ch, s.c - c0);
    if (px.ok) {
      if (s.vec) {
        fx_pass<T, 4>(s, px, pix, c0, cw, grad, flow_grad, box, stride,
                      boxed, scale, sx, sy, nf);
      } else {
        fx_pass<T, 1>(s, px, pix, c0, cw, grad, flow_grad, box, stride,
                      boxed, scale, sx, sy, nf);
      }
    }
    if (boxed) {
      __syncthreads();
      fx_flush(s, b, near, ord, tile, row0, w, c0, cw, box, stride,
               1.f / scale, nf);
      __syncthreads();
    }
  }
}

// A tile of kFxTh rows x kFxTw columns of image blockIdx.z, a thread a
// pixel: the thread's sample (x, y), whether its pixel lies in the image,
// the box of the tile's taps (its footprint; the block's threads must all
// call it) and whether the tile is near.
struct FxTile {
  Axis ax, ay;
  Box box;
  bool ok, near;
};

__device__ __forceinline__ FxTile fx_tile(const float* __restrict__ flow,
                                          int h, int w, int* bounds) {
  FxTile tl;
  const int ty0 = blockIdx.y * kFxTh, tx0 = blockIdx.x * kFxTw;
  const int iy = ty0 + threadIdx.x / kFxTw;
  const int ix = tx0 + threadIdx.x % kFxTw;
  const int64_t pix = ((int64_t)blockIdx.z * h + iy) * w + ix;
  tl.ok = iy < h && ix < w;
  tl.ax = Axis{0, 0, 0.f, 0.f};
  tl.ay = Axis{0, 0, 0.f, 0.f};
  int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
  if (tl.ok) {
    tl.ax = axis(__ldg(flow + 2 * pix), ix, w);
    tl.ay = axis(__ldg(flow + 2 * pix + 1), iy, h);
    ylo = tl.ay.i0;
    yhi = tl.ay.i1;
    xlo = tl.ax.i0;
    xhi = tl.ax.i1;
  }
  if (threadIdx.x == 0) {
    bounds[0] = bounds[2] = INT_MAX;
    bounds[1] = bounds[3] = -1;
  }
  __syncthreads();
  warp_bounds(ylo, yhi, xlo, xhi);
  if (threadIdx.x % 32 == 0) {
    atomicMin(bounds, ylo);
    atomicMax(bounds + 1, yhi);
    atomicMin(bounds + 2, xlo);
    atomicMax(bounds + 3, xhi);
  }
  __syncthreads();
  tl.box = Box{bounds[0], bounds[2], bounds[1] - bounds[0] + 1,
               bounds[3] - bounds[2] + 1};
  tl.near = tl.box.area() <= kFxArea && tl.box.y0 >= ty0 - kFxReachY &&
            tl.box.y0 + tl.box.bh <= ty0 + kFxTh + kFxReachY &&
            tl.box.x0 >= tx0 - kFxReachX &&
            tl.box.x0 + tl.box.bw <= tx0 + kFxTw + kFxReachX;
  return tl;
}

// The box pixels a near tile's taps touch, a bit each (bits zeroed, the
// block's threads all calling it).
__device__ __forceinline__ void fx_touch(const FxTile& tl, unsigned* bits) {
  if (!tl.ok) return;
  const int ys[2] = {tl.ay.i0, tl.ay.i1}, xs[2] = {tl.ax.i0, tl.ax.i1};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int bq = tl.box.at(ys[t / 2], xs[t % 2]);
    atomicOr(bits + bq / 32, 1u << (bq % 32));
  }
}

// The first pass: each source pixel's cover, the near tiles whose taps
// touch it (one add a tile), with kFxFarBit where a far tile's tap does
// (cover zeroed before).
__global__ void __launch_bounds__(kFxThreads)
    fx_cover_kernel(const float* __restrict__ flow, int h, int w,
                    int* __restrict__ cover) {
  __shared__ int bounds[4];
  __shared__ unsigned bits[kFxArea / 32];
  const FxTile tl = fx_tile(flow, h, w, bounds);
  const int64_t row0 = (int64_t)blockIdx.z * h;
  if (!tl.near) {
    if (tl.ok) {
      const int ys[2] = {tl.ay.i0, tl.ay.i1}, xs[2] = {tl.ax.i0, tl.ax.i1};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        atomicOr(cover + (row0 + ys[t / 2]) * w + xs[t % 2], kFxFarBit);
      }
    }
    return;
  }
  if (threadIdx.x < kFxArea / 32) bits[threadIdx.x] = 0;
  __syncthreads();
  fx_touch(tl, bits);
  __syncthreads();
  for (int i = threadIdx.x; i < tl.box.area(); i += kFxThreads) {
    if ((bits[i / 32] >> (i % 32)) & 1u) {
      const int by = i / tl.box.bw, bx = i - by * tl.box.bw;
      atomicAdd(cover + (row0 + tl.box.y0 + by) * w + tl.box.x0 + bx, 1);
    }
  }
}

// Exclusive ranks of the set bits of bits[0..32) into ranks, by one warp
// (lanes 0-31 of the block); the count of set bits is returned to lane 0's
// ... every lane.
__device__ __forceinline__ int fx_ranks(const unsigned* bits, int* ranks) {
  const int lane = threadIdx.x;
  const int cnt = __popc(bits[lane]);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  ranks[lane] = incl - cnt;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// Block: a tile of kFxTh rows x kFxTw columns of image blockIdx.z, a
// thread a pixel; dynamic shared memory kFxCap 64-bit values, the box of
// the tile's footprint.  Each source's channels pass through the box
// kFxChunk at a time: every tap's value is converted to a 64-bit integer
// on its own (the plain version's contributions) and added with two
// native 32-bit shared-memory atomics.  A near tile then finishes the
// pixels only its taps touched (the cover says so) straight into the
// gradient, and stores the values of the others into its slot, with their
// bits and ranks for the gather; a far tile adds into the global sums with
// one reduction per value it reached.  The flow gradient is the thread's
// sum over a's then b's channels in order.  state[1] is set by a
// non-finite value.
template <typename T>
__global__ void __launch_bounds__(kFxThreads)
    flow_warp_backward_fixed_kernel(FxSrc<T> a, FxSrc<T> b,
                                    const float* __restrict__ flow,
                                    float* __restrict__ gflow,
                                    const int* __restrict__ cover,
                                    int4* tiles, unsigned* tile_bits,
                                    int* tile_ranks, int h, int w,
                                    unsigned* state) {
  extern __shared__ unsigned long long fx_box[];
  // a near tile's touched box pixels (a bit each), those of them another
  // tile touches too, ranks of each, and the box pixel of each rank
  __shared__ unsigned bits[kFxArea / 32], shared_bits[kFxArea / 32];
  __shared__ int excl_ranks[kFxArea / 32], shared_ranks[kFxArea / 32];
  __shared__ int excl[kFxArea], shared[kFxArea];
  __shared__ int counts[2];
  __shared__ int bounds[4];
  __shared__ int nf;
  const float scale = pow2(fixed_exp(state, 1, (long long)h * w));
  const int iy = blockIdx.y * kFxTh + threadIdx.x / kFxTw;
  const int ix = blockIdx.x * kFxTw + threadIdx.x % kFxTw;
  const int64_t row0 = (int64_t)blockIdx.z * h;
  const int64_t pix = (row0 + iy) * w + ix;
  const int64_t tile =
      ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) nf = 0;
  const FxTile tl = fx_tile(flow, h, w, bounds);
  const Box& box = tl.box;
  const bool near = tl.near;
  if (threadIdx.x == 0) {
    tiles[tile] = near ? make_int4(box.y0, box.x0, box.bh, box.bw)
                       : make_int4(0, 0, 0, 0);
  }
  const long long zero = min((long long)kFxCap, box.area() * (kFxChunk | 1));
  for (long long i = threadIdx.x; i < zero; i += kFxThreads) fx_box[i] = 0;
  if (threadIdx.x < kFxArea / 32) {
    bits[threadIdx.x] = shared_bits[threadIdx.x] = 0;
  }
  __syncthreads();
  FxPix px;
  px.ok = tl.ok;
  px.wx = tl.ax.frac;
  px.wy = tl.ay.frac;
  px.dx = tl.ax.dclip;
  px.dy = tl.ay.dclip;
  const int ys[2] = {tl.ay.i0, tl.ay.i1}, xs[2] = {tl.ax.i0, tl.ax.i1};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    px.tap[t] = (row0 + ys[t / 2]) * w + xs[t % 2];
    px.bq[t] = px.ok && box.area() <= kFxCap ? box.at(ys[t / 2], xs[t % 2])
                                              : 0;
  }
  FxOrder ord{excl, shared, 0, 0};
  if (near) {
    fx_touch(tl, bits);
    __syncthreads();
    for (int i = threadIdx.x; i < box.area(); i += kFxThreads) {
      if ((bits[i / 32] >> (i % 32)) & 1u) {
        const int by = i / box.bw, bx = i - by * box.bw;
        if (cover[(row0 + box.y0 + by) * w + box.x0 + bx] != 1) {
          atomicOr(shared_bits + i / 32, 1u << (i % 32));
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      bits[threadIdx.x] &= ~shared_bits[threadIdx.x];  // only this tile's
      const int n_excl = fx_ranks(bits, excl_ranks);
      const int n_shared = fx_ranks(shared_bits, shared_ranks);
      tile_bits[tile * 32 + threadIdx.x] = shared_bits[threadIdx.x];
      tile_ranks[tile * 32 + threadIdx.x] = shared_ranks[threadIdx.x];
      if (threadIdx.x == 0) {
        counts[0] = n_excl;
        counts[1] = n_shared;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < box.area(); i += kFxThreads) {
      const unsigned below = (1u << (i % 32)) - 1u;
      const unsigned we = bits[i / 32], ws = shared_bits[i / 32];
      if ((we >> (i % 32)) & 1u) {
        excl[excl_ranks[i / 32] + __popc(we & below)] = i;
      } else if ((ws >> (i % 32)) & 1u) {
        shared[shared_ranks[i / 32] + __popc(ws & below)] = i;
      }
    }
    __syncthreads();
    ord.n_excl = counts[0];
    ord.n_shared = counts[1];
  }
  const bool flow_grad = gflow != nullptr;
  float sx = 0.f, sy = 0.f;
  fx_source(a, px, pix, box, near, ord, tile, row0, w, flow_grad, fx_box,
            scale, sx, sy, &nf);
  fx_source(b, px, pix, box, near, ord, tile, row0, w, flow_grad, fx_box,
            scale, sx, sy, &nf);
  if (flow_grad && px.ok) {
    reinterpret_cast<float2*>(gflow)[pix] =
        make_float2(clipped(sx, px.dx), clipped(sy, px.dy));
  }
  __syncthreads();
  if (threadIdx.x == 0 && nf) atomicOr(state + 1, 1u);
}

// One source of the gather: lanes over (pixel, unit of U channels) of
// the block's pixels that are not done, each unit's values summed over its
// pixel's list of slot entries (U = 4: two 16-byte loads an entry), the
// global sums added where a far tile touched the pixel, finished and
// stored (U values at once).
template <typename T, int U>
__device__ __forceinline__ void fx_gather_source(
    const FxSrc<T>& s, int64_t img_tile0, const int (*list)[kFxList],
    const int* count, int ty0, int tx0, int h, int w, int64_t row0,
    bool nonfinite, float inv) {
  const long long* slots = s.slots + img_tile0 * kFxArea * s.c;
  const int units = s.c / U;
  for (int i = threadIdx.x; i < kFxThreads * units; i += kFxThreads) {
    const int p = i / units, k = (i - p * units) * U;
    const int y = ty0 + p / kFxTw, x = tx0 + p % kFxTw;
    if (y >= h || x >= w || count[p] < 0) continue;
    long long v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = 0;
    const int n = count[p] % (kFxList + 1);
    const bool far = count[p] > kFxList;
    // two entries at a time, their loads issued together
    for (int j = 0; j < n; j += 2) {
      const long long* src0 = slots + (int64_t)list[p][j] * s.c + k;
      const long long* src1 =
          j + 1 < n ? slots + (int64_t)list[p][j + 1] * s.c + k : nullptr;
      if constexpr (U == 4) {
        const longlong2 lo0 = *reinterpret_cast<const longlong2*>(src0);
        const longlong2 hi0 = *reinterpret_cast<const longlong2*>(src0 + 2);
        longlong2 lo1{0, 0}, hi1{0, 0};
        if (src1 != nullptr) {
          lo1 = *reinterpret_cast<const longlong2*>(src1);
          hi1 = *reinterpret_cast<const longlong2*>(src1 + 2);
        }
        v[0] += lo0.x + lo1.x;
        v[1] += lo0.y + lo1.y;
        v[2] += hi0.x + hi1.x;
        v[3] += hi0.y + hi1.y;
      } else {
        v[0] += *src0 + (src1 != nullptr ? *src1 : 0);
      }
    }
    const int64_t e = ((row0 + y) * w + x) * s.c + k;
    T r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long sum = far ? v[u] + (long long)s.q[e + u] : v[u];
      const unsigned f =
          nonfinite ? reinterpret_cast<const unsigned char*>(s.flags)[e + u]
                    : 0u;
      r[u] = finish_value<T>(sum, f, inv);
    }
    if constexpr (U == 4 && sizeof(T) == 4) {
      *reinterpret_cast<float4*>(s.out + e) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else if constexpr (U == 4) {
      uint2 packed;
      packed.x = (unsigned)__bfloat16_as_ushort(r[0]) |
                 ((unsigned)__bfloat16_as_ushort(r[1]) << 16);
      packed.y = (unsigned)__bfloat16_as_ushort(r[2]) |
                 ((unsigned)__bfloat16_as_ushort(r[3]) << 16);
      *reinterpret_cast<uint2*>(s.out + e) = packed;
    } else {
      s.out[e] = r[0];
    }
  }
}

// Each source gradient where the tile kernel left it: block (blockIdx.x,
// blockIdx.y) of image blockIdx.z takes the kFxTh x kFxTw source pixels of
// that tile's place.  A pixel that one near tile alone touched is done.
// For the others a thread lists the slot entries of the near tiles whose
// footprint holds its pixel (the tiles that can: within kFxReachY rows and
// kFxReachX columns, staged once for the block) and whether a far tile
// touched it; then lanes over (pixel, channels) add those entries and,
// where a far tile touched the pixel, the global sums, and write the
// finished value (its flags where a value was non-finite): 0 where no tap
// touched the pixel.
template <typename T>
__global__ void __launch_bounds__(kFxThreads)
    fx_gather_kernel(FxSrc<T> a, FxSrc<T> b, const int4* __restrict__ tiles,
                     const int* __restrict__ cover,
                     const unsigned* __restrict__ tile_bits,
                     const int* __restrict__ tile_ranks, int h, int w,
                     const unsigned* __restrict__ state) {
  __shared__ int list[kFxThreads][kFxList];
  // the pixel's list length, kFxList + 1 more where a far tile touched
  // it, -1 where one near tile alone did
  __shared__ int count[kFxThreads];
  // the tiles whose footprint can hold a pixel of the block: tile rows
  // blockIdx.y - 3 .. + 2, tile columns blockIdx.x - 2 .. + 1
  __shared__ int4 cand_box[kFxCand];
  __shared__ unsigned cand_bits[kFxCand][32];
  __shared__ int cand_rank[kFxCand][32];
  const float inv = pow2(-fixed_exp(state, 1, (long long)h * w));
  const bool nonfinite = state[1] != 0;
  const int ty0 = blockIdx.y * kFxTh, tx0 = blockIdx.x * kFxTw;
  const int iy = ty0 + threadIdx.x / kFxTw;
  const int ix = tx0 + threadIdx.x % kFxTw;
  const int tiles_y = gridDim.y, tiles_x = gridDim.x;
  const int64_t img_tile0 = (int64_t)blockIdx.z * tiles_y * tiles_x;
  const int64_t row0 = (int64_t)blockIdx.z * h;
  for (int i = threadIdx.x; i < kFxCand * 32; i += kFxThreads) {
    const int k = i / 32, word = i % 32;
    const int r = (int)blockIdx.y - 3 + k / 4, c = (int)blockIdx.x - 2 + k % 4;
    if (r < 0 || r >= tiles_y || c < 0 || c >= tiles_x) {
      if (word == 0) cand_box[k] = make_int4(0, 0, 0, 0);
      continue;
    }
    const int64_t t = img_tile0 + r * tiles_x + c;
    if (word == 0) cand_box[k] = tiles[t];
    cand_bits[k][word] = tile_bits[t * 32 + word];
    cand_rank[k][word] = tile_ranks[t * 32 + word];
  }
  __syncthreads();
  int found = -1;
  if (iy < h && ix < w) {
    const int cv = cover[(row0 + iy) * w + ix];
    if (cv != 1) {
      found = 0;
      for (int k = 0; k < kFxCand; ++k) {
        const int4 bx = cand_box[k];  // y0, x0, bh, bw
        if (iy >= bx.x && iy < bx.x + bx.z && ix >= bx.y &&
            ix < bx.y + bx.w && found < kFxList) {
          // the pixel's rank among the tile's box pixels that other tiles
          // touch too
          const int bp = (iy - bx.x) * bx.w + (ix - bx.y);
          const unsigned bitsw = cand_bits[k][bp / 32];
          if ((bitsw >> (bp % 32)) & 1u) {
            const int t = ((int)blockIdx.y - 3 + k / 4) * tiles_x +
                          (int)blockIdx.x - 2 + k % 4;
            list[threadIdx.x][found++] =
                t * kFxArea + cand_rank[k][bp / 32] +
                __popc(bitsw & ((1u << (bp % 32)) - 1u));
          }
        }
      }
      if (cv & kFxFarBit) found += kFxList + 1;
    }
  }
  count[threadIdx.x] = found;
  __syncthreads();
  if (a.q != nullptr && a.c > 0) {
    if (a.vec) {
      fx_gather_source<T, 4>(a, img_tile0, list, count, ty0, tx0, h, w, row0,
                             nonfinite, inv);
    } else {
      fx_gather_source<T, 1>(a, img_tile0, list, count, ty0, tx0, h, w, row0,
                             nonfinite, inv);
    }
  }
  if (b.q != nullptr && b.c > 0) {
    if (b.vec) {
      fx_gather_source<T, 4>(b, img_tile0, list, count, ty0, tx0, h, w, row0,
                             nonfinite, inv);
    } else {
      fx_gather_source<T, 1>(b, img_tile0, list, count, ty0, tx0, h, w, row0,
                             nonfinite, inv);
    }
  }
}

// ---------------------------------------------------------------------------
// grouped_warp_backward

constexpr int kGwTh = 8, kGwTw = 8, kGwPix = kGwTh * kGwTw;
constexpr int kGwThreads = 256, kGwWarps = kGwThreads / 32;
constexpr int kGwBox = 1536;  // box floats a warp: 6 KB
// the fixed-order variant's box: 960 64-bit values a warp (7.5 KB), 320
// pixels of 3 channels, so that two blocks fit an SM
constexpr int kGwBoxFixed = 1920;

struct GwArgs {
  const void* x;
  const void* g;
  const float* fx;
  const float* fy;
  const float* mask;
  float* gx;
  float* gfx;
  float* gfy;
  float* gmask;
  unsigned long long* gq;  // the fixed-order variant's sums of x's gradient
  unsigned* gflags;        // and its non-finite flags
  const unsigned* mx;      // its maxima: |g|, |mask|
  int h, w, c_src, go, gn;
  int gstride;  // elements of T a staged pixel of g
  int vec_g;    // g staged by 16-byte loads
  int vec_f;    // flows, mask and their gradients by 16-byte accesses
};

// The shapes of a block: the model's as constants, or the runtime ones.
template <bool MODEL>
struct GwShape {
  int c_src, go, gn, cg;
  __device__ __forceinline__ explicit GwShape(const GwArgs& a)
      : c_src(MODEL ? 48 : a.c_src),
        go(MODEL ? 32 : a.go),
        gn(MODEL ? 16 : a.gn),
        cg(MODEL ? 3 : a.c_src / a.gn) {}
};

// A lane's pixel of lane block lb (4 rows x 8 columns of the tile).
__device__ __forceinline__ int gw_pixel(int lb, int lane) {
  return lb * 32 + lane;
}

// The staged flows: plane a (0 fx, 1 fy, 2 mask) of tile pixel p, unit j.
__device__ __forceinline__ float* gw_f(float* fs, int fstride, int a, int p,
                                       int j) {
  return fs + (a * kGwPix + p) * fstride + j;
}

// Unit j's footprint over the tile: the box of its taps' clamped rows and
// columns, the same in every lane of the warp.
__device__ __forceinline__ Box gw_footprint(float* fs, int fstride, int j,
                                            int tx0, int ty0, int h, int w) {
  const int lane = threadIdx.x % 32;
  int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
#pragma unroll
  for (int lb = 0; lb < kGwPix / 32; ++lb) {
    const int p = gw_pixel(lb, lane);
    const int py = ty0 + p / kGwTw, px = tx0 + p % kGwTw;
    if (py < h && px < w) {
      const Axis ax = axis(*gw_f(fs, fstride, 0, p, j), px, w);
      const Axis ay = axis(*gw_f(fs, fstride, 1, p, j), py, h);
      ylo = min(ylo, ay.i0);
      yhi = max(yhi, ay.i1);
      xlo = min(xlo, ax.i0);
      xhi = max(xhi, ax.i1);
    }
  }
  warp_bounds(ylo, yhi, xlo, xhi);
  return Box{ylo, xlo, yhi - ylo + 1, xhi - xlo + 1};
}

// Group gr's 3 channels of pixel q in gx (the model's shape, 48 channels):
// a .v2 and a scalar reduction ordered by the group's alignment.  (One
// 16-byte reduction with a 0 beside the channels where they lie in one
// aligned chunk of 4 measured 0.7 ms slower at the 1080p smooth case.)
__device__ __forceinline__ void red_group3(float* gx, int64_t q, int gr,
                                           const float* v) {
  float* dst = gx + q * 48 + gr * 3;
  if ((gr & 1) == 0) {
    red2(dst, v[0], v[1]);
    atomicAdd(dst + 2, v[2]);
  } else {
    atomicAdd(dst, v[0]);
    red2(dst + 1, v[1], v[2]);
  }
}

// A tap's value v of group channel k (of cg) in the fixed-order variant:
// into the box (64-bit fixed point, pixel-major: box pixel bq's cg values
// side by side) or, with no box or a non-finite v, into the global sums
// (element e).
__device__ __forceinline__ void gw_fixed_tap(const GwArgs& args,
                                             float* box, int cg, int k,
                                             int bq, int64_t e, float v,
                                             float scale) {
  if (box != nullptr && isfinite(v)) {
    if (v != 0.f) {
      smem_add64(reinterpret_cast<unsigned long long*>(box) + bq * cg + k,
                 (unsigned long long)__float2ll_rn(__fmul_rn(v, scale)));
    }
  } else {
    fixed_add(args.gq, args.gflags, e, v, scale);
  }
}

// Unit j of group gr over the tile: its taps scattered into the warp's box
// (cg planes of b.area() floats, with shared-memory atomics; 64-bit
// integers in the fixed-order variant) or, with no box, into gx; its flow
// and mask gradients written over its staged flows and mask.
template <typename T, bool MODEL, bool FIXED>
__device__ void gw_unit(const GwArgs& args, const GwShape<MODEL>& sh,
                        const T* gs, float* fs, int fstride, float* box,
                        const Box& b, int j, int gr, int64_t img, int tx0,
                        int ty0, float scale) {
  const bool want_x = FIXED ? args.gq != nullptr : args.gx != nullptr;
  const int h = args.h, w = args.w;
  const T* x = static_cast<const T*>(args.x);
  const bool need_v =
      args.gfx != nullptr || args.gfy != nullptr || args.gmask != nullptr;
  const int lane = threadIdx.x % 32;
  const int area = box != nullptr ? b.bh * b.bw : 0;
  const int src0 = gr * sh.cg;
#pragma unroll
  for (int lb = 0; lb < kGwPix / 32; ++lb) {
    const int p = gw_pixel(lb, lane);
    const int py = ty0 + p / kGwTw, px = tx0 + p % kGwTw;
    if (py >= h || px >= w) continue;
    const Axis ax_ = axis(*gw_f(fs, fstride, 0, p, j), px, w);
    const Axis ay_ = axis(*gw_f(fs, fstride, 1, p, j), py, h);
    const float m = *gw_f(fs, fstride, 2, p, j);
    const float wx = ax_.frac, wy = ay_.frac;
    const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
    const int64_t r0 = (img * h + ay_.i0) * w, r1 = (img * h + ay_.i1) * w;
    const int64_t q[4] = {r0 + ax_.i0, r0 + ax_.i1, r1 + ax_.i0,
                          r1 + ax_.i1};
    int bq[4] = {0, 0, 0, 0};
    if (box != nullptr) {
      bq[0] = b.at(ay_.i0, ax_.i0);
      bq[1] = b.at(ay_.i0, ax_.i1);
      bq[2] = b.at(ay_.i1, ax_.i0);
      bq[3] = b.at(ay_.i1, ax_.i1);
    }
    const T* gp = gs + p * args.gstride + j;
    float sx = 0.f, sy = 0.f, sm = 0.f;
    if constexpr (MODEL) {
      // a group's 3 channels: one 2-channel and one 1-channel load,
      // ordered by the group's alignment (gr even: channels 0-1 then 2)
      const bool even = (gr & 1) == 0;
      float v[4][3];
      if (need_v) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const T* xp = x + q[t] * 48 + src0;
          if (even) {
            ld2(xp, v[t][0], v[t][1]);
            v[t][2] = ld(xp, 2);
          } else {
            v[t][0] = ld(xp, 0);
            ld2(xp + 1, v[t][1], v[t][2]);
          }
        }
      }
      float add[4][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float gk = to_f32(gp[k * 32]);
        const float gm = __fmul_rn(gk, m);  // the gradient of the warp
        const float gt = __fmul_rn(gm, ay);
        const float gb = __fmul_rn(gm, wy);
        add[0][k] = __fmul_rn(gt, ax);
        add[1][k] = __fmul_rn(gt, wx);
        add[2][k] = __fmul_rn(gb, ax);
        add[3][k] = __fmul_rn(gb, wx);
        if (need_v) {
          const float top = __fadd_rn(__fmul_rn(v[0][k], ax),
                                      __fmul_rn(v[1][k], wx));
          const float bot = __fadd_rn(__fmul_rn(v[2][k], ax),
                                      __fmul_rn(v[3][k], wx));
          const float warped = __fadd_rn(__fmul_rn(top, ay),
                                         __fmul_rn(bot, wy));
          sm = __fadd_rn(sm, __fmul_rn(gk, warped));
          sx = __fadd_rn(
              sx, __fadd_rn(__fmul_rn(gt, __fsub_rn(v[1][k], v[0][k])),
                            __fmul_rn(gb, __fsub_rn(v[3][k], v[2][k]))));
          sy = __fadd_rn(sy, __fmul_rn(gm, __fsub_rn(bot, top)));
        }
      }
      if (want_x) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if constexpr (FIXED) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              gw_fixed_tap(args, box, 3, k, bq[t], q[t] * 48 + src0 + k,
                           add[t][k], scale);
            }
          } else if (box != nullptr) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              atomicAdd(box + k * area + bq[t], add[t][k]);
            }
          } else {
            red_group3(args.gx, q[t], gr, add[t]);
          }
        }
      }
    } else {
      for (int k = 0; k < sh.cg; ++k) {
        const int c = src0 + k;
        const float gk = to_f32(gp[k * sh.go]);
        const float gm = __fmul_rn(gk, m);
        const float gt = __fmul_rn(gm, ay);
        const float gb = __fmul_rn(gm, wy);
        const float add[4] = {__fmul_rn(gt, ax), __fmul_rn(gt, wx),
                              __fmul_rn(gb, ax), __fmul_rn(gb, wx)};
        if (want_x) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if constexpr (FIXED) {
              gw_fixed_tap(args, box, sh.cg, k, bq[t], q[t] * sh.c_src + c,
                           add[t], scale);
            } else if (box != nullptr) {
              atomicAdd(box + k * area + bq[t], add[t]);
            } else {
              atomicAdd(args.gx + q[t] * sh.c_src + c, add[t]);
            }
          }
        }
        if (need_v) {
          const float v00 = ld(x, q[0] * sh.c_src + c);
          const float v01 = ld(x, q[1] * sh.c_src + c);
          const float v10 = ld(x, q[2] * sh.c_src + c);
          const float v11 = ld(x, q[3] * sh.c_src + c);
          const float top = __fadd_rn(__fmul_rn(v00, ax), __fmul_rn(v01, wx));
          const float bot = __fadd_rn(__fmul_rn(v10, ax), __fmul_rn(v11, wx));
          const float warped = __fadd_rn(__fmul_rn(top, ay),
                                         __fmul_rn(bot, wy));
          sm = __fadd_rn(sm, __fmul_rn(gk, warped));
          sx = __fadd_rn(sx, __fadd_rn(__fmul_rn(gt, __fsub_rn(v01, v00)),
                                       __fmul_rn(gb, __fsub_rn(v11, v10))));
          sy = __fadd_rn(sy, __fmul_rn(gm, __fsub_rn(bot, top)));
        }
      }
    }
    // the staged flows and mask of (p, j) are read: their gradients
    // take their place
    *gw_f(fs, fstride, 0, p, j) = clipped(sx, ax_.dclip);
    *gw_f(fs, fstride, 1, p, j) = clipped(sy, ay_.dclip);
    *gw_f(fs, fstride, 2, p, j) = sm;
  }
}

// A warp's box added to group gr's channels of x's gradient; values of 0
// are skipped.  f32: cg planes of b.area() floats into gx, lanes over box
// pixels.  The fixed-order variant: b.area() pixels of cg 64-bit values
// into gq, lanes over (pixel, channel), so that a warp's reductions fall
// on a pixel's contiguous channels.
template <bool MODEL, bool FIXED>
__device__ void gw_flush(const GwArgs& args, const GwShape<MODEL>& sh,
                         const float* box, const Box& b, int gr,
                         int64_t img) {
  const int area = b.bh * b.bw;
  if constexpr (FIXED) {
    const unsigned long long* bq =
        reinterpret_cast<const unsigned long long*>(box);
    for (int i = threadIdx.x % 32; i < area * sh.cg; i += 32) {
      const unsigned long long v = bq[i];
      if (v == 0) continue;
      const int bp = i / sh.cg, k = i - bp * sh.cg;
      const int by = bp / b.bw, bx = bp - by * b.bw;
      const int64_t q = (img * args.h + b.y0 + by) * args.w + b.x0 + bx;
      atomicAdd(args.gq + q * sh.c_src + gr * sh.cg + k, v);
    }
    return;
  }
  for (int bp = threadIdx.x % 32; bp < area; bp += 32) {
    const int by = bp / b.bw, bx = bp - by * b.bw;
    const int64_t q = (img * args.h + b.y0 + by) * args.w + b.x0 + bx;
    if constexpr (MODEL) {
      const float v[3] = {box[bp], box[area + bp], box[2 * area + bp]};
      if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f) {
        red_group3(args.gx, q, gr, v);
      }
    } else {
      float* dst = args.gx + q * sh.c_src + gr * sh.cg;
      for (int k = 0; k < sh.cg; ++k) {
        const float v = box[k * area + bp];
        if (v != 0.f) atomicAdd(dst + k, v);
      }
    }
  }
}

// A warp's box holds cg values of a footprint's pixels: at most kGwBox
// floats (kGwBoxFixed / 2 64-bit integers in the fixed-order variant).
template <bool FIXED>
__device__ __forceinline__ bool gw_fits(const Box& b, int cg) {
  return FIXED ? b.area() * cg * 2 <= kGwBoxFixed : b.area() * cg <= kGwBox;
}

// Block: tile (blockIdx.x, blockIdx.y) of image blockIdx.z; shared memory
// [3][kGwPix][go + 1] f32 staged flows and mask (then their gradients),
// [kGwWarps][kGwBox] f32 boxes ([kGwWarps][kGwBoxFixed] floats of 64-bit
// values in the fixed-order variant), [kGwPix][gstride] T staged g.
// FIXED: the fixed-order variant, scaled by the maxima mx[0] |g| and
// mx[1] |mask|.
template <typename T, bool MODEL, bool FIXED>
__global__ void __launch_bounds__(kGwThreads)
    grouped_warp_backward_kernel(GwArgs args) {
  const GwShape<MODEL> sh(args);
  float scale = 0.f;
  if constexpr (FIXED) {
    scale = pow2(fixed_exp(args.mx, 2, (long long)args.h * args.w *
                                           ((sh.go + sh.gn - 1) / sh.gn)));
  }
  const bool want_x = FIXED ? args.gq != nullptr : args.gx != nullptr;
  const int box_words = FIXED ? 2 : 1;  // floats a box value
  const int h = args.h, w = args.w, go = sh.go, cgo = sh.go * sh.cg;
  const int fstride = go + 1;
  extern __shared__ float4 gw_smem[];
  float* fs = reinterpret_cast<float*>(gw_smem);
  float* boxes = fs + 3 * kGwPix * fstride;
  constexpr int box_floats = FIXED ? kGwBoxFixed : kGwBox;
  T* gs = reinterpret_cast<T*>(boxes + kGwWarps * box_floats);
  const int tid = threadIdx.x;
  const int tx0 = blockIdx.x * kGwTw, ty0 = blockIdx.y * kGwTh;
  const int64_t img = blockIdx.z;
  const int ncols = min(kGwTw, w - tx0), nrows = min(kGwTh, h - ty0);
  // 1. stage g: a tile row's ncols pixels are contiguous in g
  const T* g = static_cast<const T*>(args.g);
  if (args.vec_g) {
    constexpr int per = 16 / sizeof(T);  // elements a 16-byte chunk
    const int cpp = cgo / per;           // chunks a pixel
    for (int i = tid; i < kGwPix * cpp; i += kGwThreads) {
      const int p = i / cpp, ck = i - p * cpp;
      const int r = p / kGwTw, pc = p % kGwTw;
      if (r >= nrows || pc >= ncols) continue;
      const int64_t pix = (img * h + ty0 + r) * w + tx0 + pc;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(g + pix * cgo) + ck);
      uint32_t* dst =
          reinterpret_cast<uint32_t*>(gs + p * args.gstride + ck * per);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int i = tid; i < kGwPix * cgo; i += kGwThreads) {
      const int p = i / cgo, c = i - p * cgo;
      const int r = p / kGwTw, pc = p % kGwTw;
      if (r >= nrows || pc >= ncols) continue;
      const int64_t pix = (img * h + ty0 + r) * w + tx0 + pc;
      gs[p * args.gstride + c] = g[pix * cgo + c];
    }
  }
  // 2. stage the flows and mask
  const float* fsrc[3] = {args.fx, args.fy, args.mask};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* src = fsrc[a];
    if (args.vec_f) {
      const int cpp = go / 4;
      for (int i = tid; i < kGwPix * cpp; i += kGwThreads) {
        const int p = i / cpp, ck = i - p * cpp;
        const int r = p / kGwTw, pc = p % kGwTw;
        if (r >= nrows || pc >= ncols) continue;
        const int64_t pix = (img * h + ty0 + r) * w + tx0 + pc;
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(src + pix * go) + ck);
        float* dst = gw_f(fs, fstride, a, p, 4 * ck);
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      for (int i = tid; i < kGwPix * go; i += kGwThreads) {
        const int p = i / go, j = i - p * go;
        const int r = p / kGwTw, pc = p % kGwTw;
        if (r >= nrows || pc >= ncols) continue;
        const int64_t pix = (img * h + ty0 + r) * w + tx0 + pc;
        *gw_f(fs, fstride, a, p, j) = __ldg(src + pix * go + j);
      }
    }
  }
  __syncthreads();
  // 3. a warp takes whole groups: the units j = gr, gr + gn, ...
  const int warp = tid / 32;
  float* box = boxes + warp * box_floats;
  for (int gr = warp; gr < sh.gn; gr += kGwWarps) {
    bool shared = false;
    Box u{0, 0, 0, 0};
    if (want_x && gr + sh.gn < go) {
      // the group's units share one box where their union is no larger
      // than their boxes together
      int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
      long long sum = 0;
      for (int j = gr; j < go; j += sh.gn) {
        const Box bj = gw_footprint(fs, fstride, j, tx0, ty0, h, w);
        ylo = min(ylo, bj.y0);
        yhi = max(yhi, bj.y0 + bj.bh - 1);
        xlo = min(xlo, bj.x0);
        xhi = max(xhi, bj.x0 + bj.bw - 1);
        sum += bj.area();
      }
      u = Box{ylo, xlo, yhi - ylo + 1, xhi - xlo + 1};
      shared = u.area() <= sum && gw_fits<FIXED>(u, sh.cg);
    }
    if (shared) {
      for (int i = tid % 32; i < box_words * sh.cg * u.bh * u.bw; i += 32) {
        box[i] = 0.f;
      }
      __syncwarp();
      for (int j = gr; j < go; j += sh.gn) {
        gw_unit<T, MODEL, FIXED>(args, sh, gs, fs, fstride, box, u, j, gr,
                                 img, tx0, ty0, scale);
      }
      __syncwarp();
      gw_flush<MODEL, FIXED>(args, sh, box, u, gr, img);
      __syncwarp();
      continue;
    }
    for (int j = gr; j < go; j += sh.gn) {
      Box bj{0, 0, 0, 0};
      bool boxed = false;
      if (want_x) {
        bj = gw_footprint(fs, fstride, j, tx0, ty0, h, w);
        boxed = gw_fits<FIXED>(bj, sh.cg);
      }
      if (boxed) {
        for (int i = tid % 32; i < box_words * sh.cg * bj.bh * bj.bw;
             i += 32) {
          box[i] = 0.f;
        }
        __syncwarp();
      }
      gw_unit<T, MODEL, FIXED>(args, sh, gs, fs, fstride,
                               boxed ? box : nullptr, bj, j, gr, img, tx0,
                               ty0, scale);
      if (boxed) {
        __syncwarp();
        gw_flush<MODEL, FIXED>(args, sh, box, bj, gr, img);
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // 4. the flow and mask gradients out, coalesced in the block layout
  float* outs[3] = {args.gfx, args.gfy, args.gmask};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float* dst = outs[a];
    if (dst == nullptr) continue;
    if (args.vec_f) {
      const int cpp = go / 4;
      for (int i = tid; i < kGwPix * cpp; i += kGwThreads) {
        const int p = i / cpp, ck = i - p * cpp;
        const int r = p / kGwTw, pc = p % kGwTw;
        if (r >= nrows || pc >= ncols) continue;
        const int64_t pix = (img * h + ty0 + r) * w + tx0 + pc;
        const float* sp = gw_f(fs, fstride, a, p, 4 * ck);
        reinterpret_cast<float4*>(dst + pix * go)[ck] =
            make_float4(sp[0], sp[1], sp[2], sp[3]);
      }
    } else {
      for (int i = tid; i < kGwPix * go; i += kGwThreads) {
        const int p = i / go, j = i - p * go;
        const int r = p / kGwTw, pc = p % kGwTw;
        if (r >= nrows || pc >= ncols) continue;
        const int64_t pix = (img * h + ty0 + r) * w + tx0 + pc;
        dst[pix * go + j] = *gw_f(fs, fstride, a, p, j);
      }
    }
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

int blocks_for(int64_t threads, int per_block) {
  const int64_t b = (threads + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : b);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// a source of flow_warp_backward; units of 4 channels need c % 4 == 0,
// x and g aligned to 4 elements and gx to 16 bytes
bool vec_src(const void* x, const void* g, int c, size_t elt) {
  const uintptr_t unit = 4 * elt;
  return c > 0 && c % 4 == 0 && (uintptr_t)x % unit == 0 &&
         (uintptr_t)g % unit == 0;
}

template <typename T>
Src<T> src(const void* x, const void* g, void* gx, int c) {
  return Src<T>{(const T*)x, (const T*)g, (float*)gx, c,
                vec_src(x, g, c, sizeof(T)) && aligned16(gx)};
}

// a source of the fixed-order pair; units of 4 channels need, besides
// src's, the gradient out aligned to 4 elements
template <typename T>
FxSrc<T> fx_src(const void* x, const void* g, void* q, void* flags,
                void* slots, void* out, int c) {
  return FxSrc<T>{(const T*)x,       (const T*)g,       (unsigned long long*)q,
                  (unsigned*)flags,  (long long*)slots, (T*)out,
                  c,                 vec_src(x, g, c, sizeof(T)) &&
                                         (uintptr_t)out % (4 * sizeof(T)) == 0};
}

// The fixed-order pair's workspace: the tiles' footprints (16 bytes a
// tile), the source pixels' cover (4 bytes a pixel, rounded up to 16),
// each tile's shared bits and ranks (32 words each), then each source's
// tile slots (kFxArea pixels of its c 64-bit values a tile).
int64_t fx_tiles(int64_t n, int h, int w) {
  return n * ((h + kFxTh - 1) / kFxTh) * ((w + kFxTw - 1) / kFxTw);
}

int64_t fx_cover_bytes(int64_t n, int h, int w) {
  return (n * h * w * 4 + 15) / 16 * 16;
}

// The largest finite |x| of n values of T into *mx (already 0 or lower).
template <typename T>
void absmax(const void* x, int64_t n, unsigned* mx, cudaStream_t s) {
  if (x == nullptr || n <= 0) return;
  const int vec = (uintptr_t)x % (4 * sizeof(T)) == 0;
  int blocks = blocks_for(vec ? n / 4 + 1 : n, 256);
  if (blocks > 132 * 8) blocks = 132 * 8;
  absmax_kernel<T><<<blocks, 256, 0, s>>>((const T*)x, n, mx, vec);
}

// out = the fixed-point sums q of n values, scaled by the maxima mx[0..
// slots) and at most k contributions a value (fixed_exp), or the
// non-finite sums their flags give; out null: nothing.
template <typename T>
void fixed_finish(const void* q, const void* flags, void* out, int64_t n,
                  const unsigned* mx, int slots, long long k,
                  cudaStream_t s) {
  if (out == nullptr || n <= 0) return;
  const int vec = n % 4 == 0 && (uintptr_t)q % 32 == 0 &&
                  (uintptr_t)flags % 4 == 0 &&
                  (uintptr_t)out % (4 * sizeof(T)) == 0;
  int blocks = blocks_for(vec ? n / 4 : n, 256);
  if (blocks > 132 * 64) blocks = 132 * 64;
  fixed_finish_kernel<T><<<blocks, 256, 0, s>>>(
      (const long long*)q, (const unsigned char*)flags, (T*)out, n, mx,
      slots, k, vec);
}

template <typename T>
int flow_backward(const void* a, const void* ga, void* gxa, int ca,
                  const void* b, const void* gb, void* gxb, int cb,
                  const void* flow, void* gflow, int64_t n, int h, int w,
                  cudaStream_t s) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  if (n > 65535 || h > 65535) return (int)cudaErrorInvalidValue;  // grid
  const dim3 grid((w + kFwBlockPix - 1) / kFwBlockPix, h, (unsigned)n);
  flow_warp_backward_kernel<T><<<grid, kFwThreads, 0, s>>>(
      src<T>(a, ga, gxa, ca), src<T>(b, gb, gxb, cb), (const float*)flow,
      (float*)gflow, h, w);
  return (int)cudaGetLastError();
}

// The fixed-order variant: the maximum of the output gradients that a
// source gradient is taken of (state[0]), the kernel into the tiles' slots
// (or, for far tiles, the fixed-point sums qa, qb) and the non-finite
// flags fa, fb, then the gather into each source gradient (outa, outb).
template <typename T>
int flow_backward_fixed(const void* a, const void* ga, void* qa, void* fa,
                        void* outa, int ca, const void* b, const void* gb,
                        void* qb, void* fb, void* outb, int cb,
                        const void* flow, void* gflow, unsigned* state,
                        void* ws, int64_t n, int h, int w, cudaStream_t s) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  if (n > 65535 || (h + kFxTh - 1) / kFxTh > 65535) {
    return (int)cudaErrorInvalidValue;  // grid
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      flow_warp_backward_fixed_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFxCap * (int)sizeof(unsigned long long));
  if (attr != cudaSuccess) return (int)attr;
  if (cb <= 0) qb = nullptr;
  const int64_t pix = n * h * w, tiles = fx_tiles(n, h, w);
  int4* tile_boxes = (int4*)ws;
  int* cover = (int*)(tile_boxes + tiles);
  unsigned* tile_bits = (unsigned*)((char*)cover + fx_cover_bytes(n, h, w));
  int* tile_ranks = (int*)(tile_bits + tiles * 32);
  char* slots = (char*)(tile_ranks + tiles * 32);
  void* slots_a = qa != nullptr ? slots : nullptr;
  void* slots_b = qb == nullptr ? nullptr
                                : slots + (qa != nullptr ? tiles * kFxArea *
                                                               ca * 8
                                                         : 0);
  if (qa != nullptr) absmax<T>(ga, pix * ca, state, s);
  if (qb != nullptr) absmax<T>(gb, pix * cb, state, s);
  const FxSrc<T> sa = fx_src<T>(a, ga, qa, fa, slots_a, outa, ca);
  const FxSrc<T> sb = fx_src<T>(b, gb, qb, fb, slots_b, outb, cb);
  const dim3 grid((w + kFxTw - 1) / kFxTw, (h + kFxTh - 1) / kFxTh,
                  (unsigned)n);
  cudaError_t err = cudaMemsetAsync(cover, 0, fx_cover_bytes(n, h, w), s);
  if (err != cudaSuccess) return (int)err;
  if (qa != nullptr || qb != nullptr) {
    fx_cover_kernel<<<grid, kFxThreads, 0, s>>>((const float*)flow, h, w,
                                                cover);
  }
  flow_warp_backward_fixed_kernel<T>
      <<<grid, kFxThreads, kFxCap * sizeof(unsigned long long), s>>>(
          sa, sb, (const float*)flow, (float*)gflow, cover, tile_boxes,
          tile_bits, tile_ranks, h, w, state);
  if (qa != nullptr || qb != nullptr) {
    fx_gather_kernel<T><<<grid, kFxThreads, 0, s>>>(
        sa, sb, tile_boxes, cover, tile_bits, tile_ranks, h, w, state);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool MODEL, bool FIXED>
int launch_grouped(const GwArgs& args, int64_t n, int smem, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_warp_backward_kernel<T, MODEL, FIXED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((args.w + kGwTw - 1) / kGwTw, (args.h + kGwTh - 1) / kGwTh,
                  (unsigned)n);
  grouped_warp_backward_kernel<T, MODEL, FIXED>
      <<<grid, kGwThreads, smem, s>>>(args);
  return (int)cudaGetLastError();
}

// Both modes: gx the f32 accumulator (gq, gflags, mx null), or, for the
// fixed-order variant, gq and gflags its sums and non-finite flags and mx
// its maxima (gx null).
template <typename T>
int grouped_backward(const void* x, const void* g, const void* fx,
                     const void* fy, const void* mask, void* gx, void* gfx,
                     void* gfy, void* gmask, void* gq, void* gflags,
                     unsigned* mx, int64_t n, int h, int w, int c_src,
                     int go, int group_num, cudaStream_t s) {
  if (n <= 0 || h <= 0 || w <= 0 || go <= 0) return (int)cudaGetLastError();
  if (n > 65535) return (int)cudaErrorInvalidValue;  // gridDim.z
  const int cg = c_src / group_num, cgo = go * cg;
  // a staged pixel of g: an odd number of 32-bit words, so that lanes over
  // pixels read different banks
  int words = (cgo * (int)sizeof(T) + 3) / 4;
  if (words % 2 == 0) ++words;
  const int gstride = words * 4 / (int)sizeof(T);
  const int64_t smem = (int64_t)3 * kGwPix * (go + 1) * 4 +
                       (int64_t)kGwWarps *
                           (mx != nullptr ? kGwBoxFixed : kGwBox) * 4 +
                       (int64_t)kGwPix * gstride * sizeof(T);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  GwArgs args{x,
              g,
              (const float*)fx,
              (const float*)fy,
              (const float*)mask,
              (float*)gx,
              (float*)gfx,
              (float*)gfy,
              (float*)gmask,
              (unsigned long long*)gq,
              (unsigned*)gflags,
              mx,
              h,
              w,
              c_src,
              go,
              group_num,
              gstride,
              0,
              0};
  args.vec_g = (cgo * sizeof(T)) % 16 == 0 && aligned16(g);
  args.vec_f = go % 4 == 0 && aligned16(fx) && aligned16(fy) &&
               aligned16(mask) && aligned16(gfx) && aligned16(gfy) &&
               aligned16(gmask);
  const bool model = c_src == 48 && go == 32 && group_num == 16 &&
                     aligned16(x) && aligned16(gx);
  if (mx != nullptr) {  // the fixed-order variant
    if (gq != nullptr) {
      absmax<T>(g, n * h * w * cgo, mx, s);
      absmax<float>(mask, n * h * w * go, mx + 1, s);
    }
    if (model) return launch_grouped<T, true, true>(args, n, (int)smem, s);
    return launch_grouped<T, false, true>(args, n, (int)smem, s);
  }
  if (model) return launch_grouped<T, true, false>(args, n, (int)smem, s);
  return launch_grouped<T, false, false>(args, n, (int)smem, s);
}

}  // namespace

// The gradient of the warp of a (N,H,W,ca) and, with cb > 0, b (N,H,W,cb)
// by one flow (N,H,W,2) f32.  ga, gb: the outputs' gradients in the
// sources' dtype (0 f32, 1 bf16).  gxa, gxb: zeroed f32 (N,H,W,c)
// accumulators, or null where a source needs no gradient; gflow: (N,H,W,2)
// f32, or null.
extern "C" int lssvc_flow_warp_backward(const void* a, const void* ga,
                                        void* gxa, int ca, const void* b,
                                        const void* gb, void* gxb, int cb,
                                        const void* flow, void* gflow,
                                        int64_t n, int h, int w, int dtype,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return flow_backward<float>(a, ga, gxa, ca, b, gb, gxb, cb, flow, gflow,
                                n, h, w, s);
  }
  return flow_backward<__nv_bfloat16>(a, ga, gxa, ca, b, gb, gxb, cb, flow,
                                      gflow, n, h, w, s);
}

// The gradient of the grouped warp: x (N,H,W,c_src), g (N,H,W,go*cg) in
// x's dtype; fx, fy, mask (N,H,W,go) f32; gx a zeroed f32 (N,H,W,c_src)
// accumulator; gfx, gfy, gmask (N,H,W,go) f32; each gradient may be null.
// Refused (cudaErrorInvalidValue) where a block's staged tile would pass
// the 226 KB of dynamic shared memory (go * cg past about 1,000 in f32).
extern "C" int lssvc_grouped_warp_backward(const void* x, const void* g,
                                           const void* fx, const void* fy,
                                           const void* mask, void* gx,
                                           void* gfx, void* gfy, void* gmask,
                                           int64_t n, int h, int w, int c_src,
                                           int go, int group_num, int dtype,
                                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return grouped_backward<float>(x, g, fx, fy, mask, gx, gfx, gfy, gmask,
                                   nullptr, nullptr, nullptr, n, h, w, c_src,
                                   go, group_num, s);
  }
  return grouped_backward<__nv_bfloat16>(
      x, g, fx, fy, mask, gx, gfx, gfy, gmask, nullptr, nullptr, nullptr, n,
      h, w, c_src, go, group_num, s);
}

// The fixed-order variant of lssvc_flow_warp_backward: the same inputs;
// qa, qb zeroed int64 (N,H,W,c) fixed-point sums and fa, fb zeroed bytes
// (N,H,W,c, rounded up to a multiple of 4) of non-finite flags of the
// sources' gradients (null where a source needs none), outa, outb those
// gradients in the sources' dtype; state two zeroed 32-bit words; ws a
// workspace of lssvc_flow_warp_backward_fixed_workspace bytes (any
// contents).  The source gradients are the same bits whatever order the
// threads run in: the integer sum of each tap's value round(v 2^s),
// converted once.
extern "C" int lssvc_flow_warp_backward_fixed(
    const void* a, const void* ga, void* qa, void* fa, void* outa, int ca,
    const void* b, const void* gb, void* qb, void* fb, void* outb, int cb,
    const void* flow, void* gflow, void* state, void* ws, int64_t n, int h,
    int w, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return flow_backward_fixed<float>(a, ga, qa, fa, outa, ca, b, gb, qb, fb,
                                      outb, cb, flow, gflow, (unsigned*)state,
                                      ws, n, h, w, s);
  }
  return flow_backward_fixed<__nv_bfloat16>(
      a, ga, qa, fa, outa, ca, b, gb, qb, fb, outb, cb, flow, gflow,
      (unsigned*)state, ws, n, h, w, s);
}

// The bytes of lssvc_flow_warp_backward_fixed's workspace for sources of
// ca and cb channels that take a gradient (0 for one that takes none).
extern "C" int64_t lssvc_flow_warp_backward_fixed_workspace(int64_t n, int h,
                                                            int w, int ca,
                                                            int cb) {
  const int64_t tiles = fx_tiles(n, h, w);
  return tiles * (int64_t)sizeof(int4) + fx_cover_bytes(n, h, w) +
         tiles * 32 * 8 + tiles * kFxArea * (int64_t)(ca + cb) * 8;
}

// The fixed-order variant of lssvc_grouped_warp_backward: qx zeroed int64
// (N,H,W,c_src) and fx_ zeroed bytes (N,H,W,c_src, rounded up to a
// multiple of 4) for x's gradient's sums and non-finite flags (null where
// x needs none), outx that gradient in x's dtype; mx two zeroed 32-bit
// words (the maxima |g| and |mask|).
extern "C" int lssvc_grouped_warp_backward_fixed(
    const void* x, const void* g, const void* fx, const void* fy,
    const void* mask, void* qx, void* fx_, void* outx, void* gfx, void* gfy,
    void* gmask, void* mx, int64_t n, int h, int w, int c_src, int go,
    int group_num, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long k =
      (long long)h * w * ((go + group_num - 1) / (group_num > 0 ? group_num : 1));
  const int64_t elems = n * h * w * c_src;
  int err;
  if (dtype == 0) {
    err = grouped_backward<float>(x, g, fx, fy, mask, nullptr, gfx, gfy,
                                  gmask, qx, fx_, (unsigned*)mx, n, h, w,
                                  c_src, go, group_num, s);
    if (err == 0 && qx != nullptr) {
      fixed_finish<float>(qx, fx_, outx, elems, (unsigned*)mx, 2, k, s);
    }
  } else {
    err = grouped_backward<__nv_bfloat16>(x, g, fx, fy, mask, nullptr, gfx,
                                          gfy, gmask, qx, fx_, (unsigned*)mx,
                                          n, h, w, c_src, go, group_num, s);
    if (err == 0 && qx != nullptr) {
      fixed_finish<__nv_bfloat16>(qx, fx_, outx, elems, (unsigned*)mx, 2, k,
                                  s);
    }
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

// dst[i] = bf16(src[i]), rounded to nearest even: a bf16 source's gradient
// from its f32 accumulator.
extern "C" int lssvc_f32_to_bf16(const void* src, void* dst, int64_t n,
                                 void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int blocks = blocks_for(n, 256);
  if (blocks > 132 * 64) blocks = 132 * 64;
  f32_to_bf16_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)src, (__nv_bfloat16*)dst, n);
  return (int)cudaGetLastError();
}

// Bilinear backward-warp kernels for Hopper (sm_90a), plain C interface.
//
// flow_warp stands for the JAX package's Pallas warp kernels
//   lssvc_tpu/ops/warp_pallas.py  _warp_kernel_cblock  (via
//     _flow_warp_pallas_cblock: the tiny tier of flow_warp_auto, |flow| <= 2;
//     its A/B forms _warp_kernel_cblock_roll and _warp_kernel_cblock_wide)
//   lssvc_tpu/ops/warp_pallas.py  _warp_kernel         (via
//     _flow_warp_pallas: the windowed tier, |fy| <= 26, |fx| <= 62)
//   lssvc_tpu/ops/warp_pallas.py  _warp_kernel_smallflow (the tap-sum tier)
// and for the XLA fallback lssvc_tpu/ops/warp.py flow_warp_lowmem.
// lssvc_flow_warp_pair is warp_pallas.py flow_warp_pair: two sources warped
// by one flow, which the JAX package runs as concat, warp, split.
// lssvc_flow_warp_pair_packed is the packed store of _warp_kernel_cblock
// (nhwc_out="p", via flow_warp_auto(packed_out=True)) on the pair
// [ref_el, f1] that models/lssvc.py:159-178 concatenates first: both sources
// warped into ONE (N, H, W, ca+cb) output, a at channel 0 and b at channel
// ca of each pixel.  pack_width of a C-contiguous NHWC tensor is a pure
// reshape, so that buffer already is the width-packed (N, H, W/2,
// 2(ca+cb)) layout, channel (w%2)(ca+cb) + c: the packed store writes
// that buffer, with no concat of the sources.
// The grouped warp's packed store (_grouped_warp_kernel_cblock with
// nhwc_out="p") is the same bytes as its plain output, so it needs nothing
// here: the wrapper views the output.
//
// grouped_warp stands for
//   lssvc_tpu/ops/warp_pallas.py  _grouped_warp_kernel_cblock  (via
//     _grouped_warp_pallas_cblock: the tiny b=2 and mid b=12 tiers of
//     grouped_warp_auto)
//   lssvc_tpu/ops/warp_pallas.py  _grouped_warp_kernel  (via
//     _grouped_warp_pallas: the windowed tier)
//   lssvc_tpu/ops/warp_pallas.py  _grouped_warp_kernel_smallflow
// and for the XLA fallback lssvc_tpu/ops/warp.py grouped_warp_lowmem.
//
// The TPU needed those tiers because XLA:TPU lowers gathers to scalar loops
// and a VMEM window bounds how far a sample may move.  On Hopper a
// data-dependent load from L2/HBM is native, so one gather kernel is exact
// for every flow magnitude and there is no tier dispatch.
//
// Bound: bytes.  Each kernel does ~20 flops per output element and must
// move x read once, the flows (and mask) read once and the output written
// once; at 3.35 TB/s that is the least time (EL pair 1x1152x1920x(3+48)
// f32: 0.275 ms; grouped 1x1152x1920x48 -> 96: 0.634 ms).
//
// The packed pair store.  Its first design was flow_warp_kernel with the
// output's pixel stride and channel offset: a 51-channel row (204 bytes f32,
// 102 bf16) is no whole 16-byte chunks, so both sources fell to the scalar
// path, one thread a pixel, a warp's lanes 192 bytes apart in b and 204
// bytes apart in out, each load and store touching 32 sectors: 17x (f32) and
// 8.5x (bf16) the plain pair.  Only the store was misaligned, so now the
// gather and the store are apart (flow_warp_packed_kernel): a source takes
// the vector path by its own layout (b's 48 channels: lanes over its 16-byte
// chunks, four 16-byte loads each, as in flow_warp), the warped values go to
// a shared-memory copy of the block's output span (64 pixels of a row are
// one contiguous span of 64 * 51 elements), and the block writes the span
// out with 16-byte stores, coalesced, where the span starts 16 bytes aligned
// (64 pixels are 816 16-byte chunks in f32, 408 in bf16) and with single
// elements at a misaligned start or end.
//
// flow_warp.  The first design ran one thread per output element in a flat
// grid-stride loop: three runtime integer divisions to split the index,
// both axes' coordinates recomputed for every channel, and 4-byte loads,
// about 100 instructions an element, so it was bound by instruction issue
// at half its byte bound; a pair went through a torch.cat of its sources
// first.  Now a 3-D grid (column tile, row, image) and a 2-D block (unit,
// pixel) need no division.  A thread computes its pixel's coordinates once
// and warps one unit of it: a 16-byte chunk of channels (4 f32 or 8 bf16:
// four 16-byte loads, one 16-byte store) when a pixel's channels are whole
// chunks and both pointers are 16-byte aligned (the vector path), else all
// channels of the pixel with scalar loads (the scalar path, e.g. RGB).  A
// pair warps both sources from the same coordinates in one launch: the
// source with more units takes the block's (unit, pixel) layout; a source of
// one unit a pixel gets warps of its own past them, one pixel a thread, so
// the two paths do not share a warp.  32 registers a thread let an SM hold
// 2048 threads, which the gathers need to keep L2 busy.
//
// grouped_warp.  The first design ran one thread per (pixel, unit) with
// runtime divisions and gathered each of a group's channels with its own
// 4-byte load: 12 loads per (pixel, unit), each scattered over up to 32
// sectors (the 32 lanes are 32 units with their own flows), the same sector
// requested once per channel where a group's 12 bytes straddle two.  Lanes
// are still units, so the flow and mask reads and the block-layout writes
// stay 128-byte coalesced; a thread computes a (pixel, unit)'s indices and
// weights once and fetches a group's 3 channels (12 bytes f32 / 6 bytes
// bf16, at byte 12g / 6g of the pixel) as one 2-channel and one 1-channel
// load ordered by the group's alignment: 8 loads per (pixel, unit), each
// tap's sectors requested once.  A thread takes 4 rows of one column, all
// their taps in flight before any arithmetic; a pixel's lower taps are
// mostly the upper taps of the pixel below, which then come from L1.  The
// model's shape (3 channels a group, 32 units, 16 groups) is a template
// instance with no runtime division; other shapes, or a source not aligned
// for the 2-channel loads, take the same kernel with runtime constants and
// one load per channel.
//
// Arithmetic follows lssvc_tpu_torch/ops/warp.py (and lssvc_tpu/ops/warp.py)
// operation for operation, with explicit round-to-nearest intrinsics so that
// nvcc does not contract them into FMAs, and a bf16 result rounded once at
// the end: the result equals the plain PyTorch version bit for bit.  Integer
// indices are clamped into range after conversion, so a NaN flow yields NaN
// and never an out-of-range read.  Offsets are 32-bit while every tensor
// has fewer than 2^31 elements, else 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 to_f32(float2 v) { return v; }
__device__ __forceinline__ float2 to_f32(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// clip(pos + f, 0, size-1) -> (i0, i1, frac); NaN passes the clip as NaN
// (like torch.clamp), converts to index 0, and poisons frac.
__device__ __forceinline__ void coords(float f, int pos, int size, int* i0,
                                       int* i1, float* frac) {
  float hi = (float)(size - 1);
  float p = __fadd_rn((float)pos, f);
  p = p < 0.f ? 0.f : p;
  p = p > hi ? hi : p;
  float p0 = floorf(p);
  *frac = __fsub_rn(p, p0);
  int k = __float2int_rz(p0);  // NaN -> 0
  k = k < 0 ? 0 : (k > size - 1 ? size - 1 : k);
  *i0 = k;
  *i1 = k + 1 > size - 1 ? size - 1 : k + 1;
}

// top = v00*(1-wx) + v01*wx; bot likewise; top*(1-wy) + bot*wy
__device__ __forceinline__ float lerp2(float v00, float v01, float v10,
                                       float v11, float wx, float wy) {
  float ax = __fsub_rn(1.f, wx);
  float ay = __fsub_rn(1.f, wy);
  float top = __fadd_rn(__fmul_rn(v00, ax), __fmul_rn(v01, wx));
  float bot = __fadd_rn(__fmul_rn(v10, ax), __fmul_rn(v11, wx));
  return __fadd_rn(__fmul_rn(top, ay), __fmul_rn(bot, wy));
}

// The four taps of one output pixel as pixel indices, and its weights.
template <typename I>
struct Taps {
  I p00, p01, p10, p11;
  float wx, wy;
};

// Taps of pixel (iy, ix) of the image whose first pixel is img, moved by
// (fx, fy).
template <typename I>
__device__ __forceinline__ Taps<I> taps(float fx, float fy, int ix, int iy,
                                        int h, int w, I img) {
  int x0, x1, y0, y1;
  Taps<I> t;
  coords(fx, ix, w, &x0, &x1, &t.wx);
  coords(fy, iy, h, &y0, &y1, &t.wy);
  const I r0 = img + (I)y0 * w, r1 = img + (I)y1 * w;
  t.p00 = r0 + x0;
  t.p01 = r0 + x1;
  t.p10 = r1 + x0;
  t.p11 = r1 + x1;
  return t;
}

// ---------------------------------------------------------------------------
// flow_warp

// One tensor to warp: x (N, H, W, c), and its output at channel `oo` of
// pixels `os` elements apart (os = c, oo = 0 for an output of its own).
// units: 16-byte chunks a pixel on the vector path, 1 on the scalar path, 0
// for no tensor.
template <typename T>
struct Source {
  const T* x;
  T* out;
  int c;
  int os;
  int oo;
  int units;
  bool vec;
};

// value i of a 16-byte chunk of T held as four 32-bit words, in f32
template <typename T>
__device__ __forceinline__ float chunk_value(const uint4& v, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[i]);
  } else {  // bf16 is the top half of an f32
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Chunk u of one pixel, warped: four 16-byte loads, the 16 bytes of T out.
template <typename T, typename I>
__device__ __forceinline__ uint4 chunk_bits(const Source<T>& s,
                                            const Taps<I>& t, int u) {
  const int k = u * (16 / (int)sizeof(T));  // 16 bytes of T
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(s.x + t.p00 * s.c + k));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(s.x + t.p01 * s.c + k));
  const uint4 c = __ldg(reinterpret_cast<const uint4*>(s.x + t.p10 * s.c + k));
  const uint4 d = __ldg(reinterpret_cast<const uint4*>(s.x + t.p11 * s.c + k));
  auto value = [&](int i) {
    return lerp2(chunk_value<T>(a, i), chunk_value<T>(b, i),
                 chunk_value<T>(c, i), chunk_value<T>(d, i), t.wx, t.wy);
  };
  uint4 o;
  uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(T) == 4) {
      ow[q] = __float_as_uint(value(q));
    } else {
      ow[q] = bf16_bits(value(2 * q)) | bf16_bits(value(2 * q + 1)) << 16;
    }
  }
  return o;
}

// Chunk u of one pixel: four 16-byte loads, one 16-byte store.
template <typename T, typename I>
__device__ __forceinline__ void warp_chunk(const Source<T>& s,
                                           const Taps<I>& t, I pix, int u) {
  const int k = u * (16 / (int)sizeof(T));
  *reinterpret_cast<uint4*>(s.out + pix * s.os + s.oo + k) =
      chunk_bits(s, t, u);
}

// All c channels of one pixel of x (N, H, W, c) into o[0..c), one value
// per load.
template <typename T, typename I>
__device__ __forceinline__ void warp_channels_to(const T* x, int c,
                                                 const Taps<I>& t, T* o) {
  const T* x00 = x + t.p00 * c;
  const T* x01 = x + t.p01 * c;
  const T* x10 = x + t.p10 * c;
  const T* x11 = x + t.p11 * c;
#pragma unroll 4
  for (int k = 0; k < c; ++k) {
    o[k] = from_f32<T>(lerp2(to_f32(__ldg(x00 + k)), to_f32(__ldg(x01 + k)),
                             to_f32(__ldg(x10 + k)), to_f32(__ldg(x11 + k)),
                             t.wx, t.wy));
  }
}

template <typename T, typename I>
__device__ __forceinline__ void warp_channels(const Source<T>& s,
                                              const Taps<I>& t, I pix) {
  warp_channels_to(s.x, s.c, t, s.out + pix * s.os + s.oo);
}

template <typename T, typename I>
__device__ __forceinline__ void warp_unit(const Source<T>& s,
                                          const Taps<I>& t, I pix, int u) {
  if (s.vec) {
    warp_chunk(s, t, pix, u);
  } else {
    warp_channels(s, t, pix);
  }
}

// Block (unit, pixel): rows 0..tile-1 of the block take `tile` pixels of
// row blockIdx.y of image blockIdx.z from column blockIdx.x * tile, one
// unit of `major` (the source with the most units a pixel) per thread, and
// the units of a `minor` source of several units; the rows past `tile`
// take a minor source of one unit, thread i of them pixel i.  flow
// (N, H, W, 2) f32.  At most 256 threads a block and 32 registers a thread,
// so that an SM holds its full 2048 threads: the gathers wait on L2, and the
// more of them in flight the better (on an H100 every step up in registers
// made the EL pair slower).
template <typename T, typename I>
__global__ void __launch_bounds__(256, 8)
    flow_warp_kernel(Source<T> major, Source<T> minor,
                     const float* __restrict__ flow, int h, int w, int tile) {
  const int iy = blockIdx.y;
  const I img = (I)blockIdx.z * h * w;  // the image's first pixel
  const I row = img + (I)iy * w;
  const int x_tile = blockIdx.x * tile;
  if (threadIdx.y < tile) {
    const int ix = x_tile + threadIdx.y;
    if (ix >= w) return;
    const I pix = row + ix;
    const Taps<I> t =
        taps<I>(flow[2 * pix], flow[2 * pix + 1], ix, iy, h, w, img);
    for (int u = threadIdx.x; u < major.units; u += blockDim.x) {
      warp_unit(major, t, pix, u);
    }
    for (int u = threadIdx.x; minor.units > 1 && u < minor.units;
         u += blockDim.x) {
      warp_unit(minor, t, pix, u);
    }
  } else {
    const int i = (threadIdx.y - tile) * blockDim.x + threadIdx.x;
    const int ix = x_tile + i;
    if (i >= tile || ix >= w) return;
    const I pix = row + ix;
    warp_unit(minor,
              taps<I>(flow[2 * pix], flow[2 * pix + 1], ix, iy, h, w, img),
              pix, 0);
  }
}

// x and its own output.  The vector path needs whole 16-byte chunks at
// 16-byte aligned addresses in x and out.
template <typename T>
Source<T> source(const void* x, void* out, int c) {
  Source<T> s{(const T*)x, (T*)out, c, c, 0, 0, false};
  if (c > 0) {
    s.vec = (c * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
            (uintptr_t)out % 16 == 0;
    s.units = s.vec ? (int)(c * sizeof(T) / 16) : 1;
  }
  return s;
}

template <typename T>
int launch_flow_warp(Source<T> a, Source<T> b, const void* flow, int64_t n,
                     int h, int w, cudaStream_t st) {
  if (n <= 0 || h <= 0 || w <= 0 || (a.units == 0 && b.units == 0)) {
    return (int)cudaGetLastError();
  }
  if (n > 65535 || h > 65535) return (int)cudaErrorInvalidValue;  // grid
  if (b.units > a.units) {
    const Source<T> t = a;
    a = b;
    b = t;
  }
  // the largest power of two of pixels a tile whose rows, with the rows
  // for a one-unit minor source, keep the block within 256 threads
  const int bx = a.units < 32 ? a.units : 32;
  auto rows_for = [&](int tile) {
    return tile + (b.units == 1 ? (tile + bx - 1) / bx : 0);
  };
  int tile = 1;
  while (rows_for(2 * tile) * bx <= 256) tile *= 2;
  const int rows = rows_for(tile);
  const dim3 block(bx, rows);
  const dim3 grid((w + tile - 1) / tile, h, (unsigned)n);
  // the widest row of any tensor: the sources, the outputs, the flow
  const int widths[4] = {a.c, b.c, a.os, b.os};
  int most = 2;
  for (int i = 0; i < 4; ++i) most = widths[i] > most ? widths[i] : most;
  if (n * h * w * most < (int64_t(1) << 31)) {
    flow_warp_kernel<T, uint32_t><<<grid, block, 0, st>>>(
        a, b, (const float*)flow, h, w, tile);
  } else {
    flow_warp_kernel<T, int64_t><<<grid, block, 0, st>>>(
        a, b, (const float*)flow, h, w, tile);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The packed pair store

// Pixels a block of the packed store, fewer where their output span and
// taps would pass kPackedSmemMax bytes of shared memory.
constexpr int kPackedTile = 64;
constexpr int kPackedSmemMax = 48 * 1024;

// A block's shared memory: the taps of its pixels, then the copy of its
// output span, which starts as many bytes past a 16-byte boundary as the
// span does in out (hence 16 bytes more).
template <typename I>
__host__ __device__ constexpr int packed_taps_bytes(int tile) {
  return (tile * (int)sizeof(Taps<I>) + 15) / 16 * 16;
}

template <typename T, typename I>
int packed_smem_bytes(int tile, int c_out) {
  return packed_taps_bytes<I>(tile) + 16 + tile * c_out * (int)sizeof(T);
}

// The 16 bytes of a warped chunk into shared memory at any element offset:
// four 4-byte stores of f32, eight 2-byte stores of bf16.
template <typename T>
__device__ __forceinline__ void stage_chunk(const uint4& v, T* dst) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  if constexpr (sizeof(T) == 4) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = w[q];
  } else {
    uint16_t* d = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d[2 * q] = (uint16_t)(w[q] & 0xffffu);
      d[2 * q + 1] = (uint16_t)(w[q] >> 16);
    }
  }
}

// Block (unit, pixel) over `tile` pixels of row blockIdx.y of image
// blockIdx.z from column blockIdx.x * tile; a and b share out (their os is
// the output's pixel stride c_out, oo their channel offset).  The block's
// output is one contiguous span of npix * c_out elements, staged in shared
// memory:
//   1. thread i < npix computes pixel i's taps, keeps them in shared
//      memory, and warps the sources of the scalar path into the span;
//   2. thread (u, p) warps chunk u of pixel p, p = threadIdx.y,
//      threadIdx.y + blockDim.y, ..., of each source of the vector path
//      (its channels whole 16-byte chunks, x aligned to 16 bytes: the
//      loads' path depends on the source alone) into the span;
//   3. all threads write the span out, 16 bytes a store from its first
//      16-byte boundary in out to its last, single elements around them.
// The same 32-register bound as flow_warp_kernel.
template <typename T, typename I>
__global__ void __launch_bounds__(256, 8)
    flow_warp_packed_kernel(Source<T> a, Source<T> b,
                            const float* __restrict__ flow, int h, int w,
                            int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  Taps<I>* const taps_s = reinterpret_cast<Taps<I>*>(smem);
  const int c_out = a.os;
  const int iy = blockIdx.y;
  const I img = (I)blockIdx.z * h * w;
  const I row = img + (I)iy * w;
  const int x_tile = blockIdx.x * tile;
  const int npix = min(tile, w - x_tile);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  T* const gout = a.out + (row + x_tile) * c_out;
  const int mis = (int)((uintptr_t)gout % 16);  // a multiple of sizeof(T)
  // span[i] lies at the same offset from a 16-byte boundary as gout[i]
  T* const span =
      reinterpret_cast<T*>(smem + packed_taps_bytes<I>(tile) + mis);

  if (tid < npix) {
    const int ix = x_tile + tid;
    const I pix = row + ix;
    const Taps<I> t =
        taps<I>(flow[2 * pix], flow[2 * pix + 1], ix, iy, h, w, img);
    taps_s[tid] = t;
    T* const o = span + tid * c_out;
    if (a.units && !a.vec) warp_channels_to(a.x, a.c, t, o + a.oo);
    if (b.units && !b.vec) warp_channels_to(b.x, b.c, t, o + b.oo);
  }
  __syncthreads();

  constexpr int E = 16 / (int)sizeof(T);  // elements a chunk
  if (a.vec || b.vec) {  // the same in every thread
    for (int p = threadIdx.y; p < npix; p += blockDim.y) {
      const Taps<I> t = taps_s[p];
      T* const o = span + p * c_out;
      for (int u = threadIdx.x; a.vec && u < a.units; u += blockDim.x) {
        stage_chunk(chunk_bits(a, t, u), o + a.oo + u * E);
      }
      for (int u = threadIdx.x; b.vec && u < b.units; u += blockDim.x) {
        stage_chunk(chunk_bits(b, t, u), o + b.oo + u * E);
      }
    }
    __syncthreads();
  }

  const int n = npix * c_out;
  int head = ((16 - mis) % 16) / (int)sizeof(T);  // elements to a boundary
  head = head < n ? head : n;
  const int chunks = (n - head) / E;
  const uint4* src = reinterpret_cast<const uint4*>(span + head);
  uint4* dst = reinterpret_cast<uint4*>(gout + head);
  for (int j = tid; j < chunks; j += nthreads) dst[j] = src[j];
  for (int j = tid; j < head; j += nthreads) gout[j] = span[j];
  for (int j = head + chunks * E + tid; j < n; j += nthreads) {
    gout[j] = span[j];
  }
}

// The loads' path of a source of the packed store: the vector path needs
// whole 16-byte chunks in x alone, since the store goes through shared
// memory.
template <typename T>
Source<T> packed_source(const void* x, void* out, int c, int os, int oo) {
  Source<T> s{(const T*)x, (T*)out, c, os, oo, 0, false};
  if (c > 0) {
    s.vec = (c * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
    s.units = s.vec ? (int)(c * sizeof(T) / 16) : 1;
  }
  return s;
}

template <typename T, typename I>
int launch_packed(const Source<T>& a, const Source<T>& b, const void* flow,
                  int64_t n, int h, int w, cudaStream_t st) {
  int tile = kPackedTile;
  while (tile > 1 && packed_smem_bytes<T, I>(tile, a.os) > kPackedSmemMax) {
    tile /= 2;
  }
  const int smem = packed_smem_bytes<T, I>(tile, a.os);
  if (smem > kPackedSmemMax) return (int)cudaErrorInvalidValue;
  // lanes over the chunks of the source with the most, at most 32; rows up
  // to 256 threads, at most one a pixel.  bx * by >= tile: step 1 has a
  // thread for each pixel.
  const int ua = a.vec ? a.units : 0, ub = b.vec ? b.units : 0;
  const int units = ua > ub ? ua : ub;
  const int bx = units < 1 ? 1 : (units < 32 ? units : 32);
  int by = 1;
  while (2 * by * bx <= 256 && by < tile) by *= 2;
  const dim3 grid((w + tile - 1) / tile, h, (unsigned)n);
  flow_warp_packed_kernel<T, I><<<grid, dim3(bx, by), smem, st>>>(
      a, b, (const float*)flow, h, w, tile);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flow_warp_packed(const Source<T>& a, const Source<T>& b,
                            const void* flow, int64_t n, int h, int w,
                            cudaStream_t st) {
  if (n <= 0 || h <= 0 || w <= 0 || (a.units == 0 && b.units == 0)) {
    return (int)cudaGetLastError();
  }
  if (n > 65535 || h > 65535) return (int)cudaErrorInvalidValue;  // grid
  const int widths[3] = {a.c, b.c, a.os};
  int most = 2;
  for (int i = 0; i < 3; ++i) most = widths[i] > most ? widths[i] : most;
  if (n * h * w * most < (int64_t(1) << 31)) {
    return launch_packed<T, uint32_t>(a, b, flow, n, h, w, st);
  }
  return launch_packed<T, int64_t>(a, b, flow, n, h, w, st);
}

// ---------------------------------------------------------------------------
// grouped_warp

constexpr int kPixelsPerThread = 4;

template <typename T>
struct Two;  // two neighbouring channels of T in one load
template <>
struct Two<float> {
  using type = float2;
};
template <>
struct Two<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

// Block (unit lane, column): thread (j, y) warps units j, j + blockDim.x,
// ... at kPixelsPerThread consecutive rows, from row blockIdx.y *
// kPixelsPerThread, of column blockIdx.x * blockDim.y + y of image
// blockIdx.z.  A pixel's lower taps are mostly the upper taps of the pixel
// below it, so the thread's next loads find them in L1.  x (N,H,W,cg*gn);
// fx, fy, mask (N,H,W,go) f32; out (N,H,W,go*cg) with out[..., k*go + j] =
// mask_j * warp_j(x[..., (j % gn)*cg + k]).  CG, GO, GN: the shape as
// template constants (CG == 3: one 2-channel and one 1-channel load per
// tap, which needs x aligned to two channels), or 0 to take the runtime
// cg, go, gn.  At most 80 registers a thread, 3 blocks an SM: 4 pixels of
// taps in flight a thread, with no spill in the model's 32-bit instances.
template <typename T, typename I, int CG, int GO, int GN>
__global__ void __launch_bounds__(256, 3)
    grouped_warp_kernel(const T* __restrict__ x, const float* __restrict__ fx,
                        const float* __restrict__ fy,
                        const float* __restrict__ mask, T* __restrict__ out,
                        int h, int w, int cg_, int go_, int gn_) {
  constexpr int P = kPixelsPerThread;
  const int cg = CG ? CG : cg_;
  const int go = GO ? GO : go_;
  const int gn = GN ? GN : gn_;
  const int c_src = cg * gn;
  const int c_out = go * cg;
  const int ix = blockIdx.x * blockDim.y + threadIdx.y;
  const int iy0 = blockIdx.y * P;
  if (ix >= w) return;
  const I img = (I)blockIdx.z * h * w;
  for (int j = threadIdx.x; j < go; j += blockDim.x) {
    const int g = j % gn;  // once a thread and unit, not a pixel
    Taps<I> t[P];
    I pix[P];
    float m[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      // past the last row: warp it again and store nothing
      const int iy = iy0 + i < h ? iy0 + i : h - 1;
      pix[i] = img + (I)iy * w + ix;
      const I e = pix[i] * go + j;
      t[i] = taps<I>(fx[e], fy[e], ix, iy, h, w, img);
      m[i] = mask[e];
    }
    if constexpr (CG == 3) {
      // channels 0,1 | 2 of an even group, 0 | 1,2 of an odd one: the pair
      // starts at an even channel of the pixel, so it is aligned
      using T2 = typename Two<T>::type;
      const int odd = g & 1;
      const int e2 = 3 * g + odd, e1 = 3 * g + 2 - 2 * odd;
      T2 v2[P][4];
      T v1[P][4];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const I p[4] = {t[i].p00, t[i].p01, t[i].p10, t[i].p11};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v2[i][q] = __ldg(reinterpret_cast<const T2*>(x + p[q] * c_src + e2));
          v1[i][q] = __ldg(x + p[q] * c_src + e1);
        }
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (iy0 + i >= h) continue;
        const float2 a = to_f32(v2[i][0]), b = to_f32(v2[i][1]);
        const float2 c = to_f32(v2[i][2]), d = to_f32(v2[i][3]);
        const float wx = t[i].wx, wy = t[i].wy;
        const float s0 = lerp2(a.x, b.x, c.x, d.x, wx, wy);
        const float s1 = lerp2(a.y, b.y, c.y, d.y, wx, wy);
        const float s2 = lerp2(to_f32(v1[i][0]), to_f32(v1[i][1]),
                               to_f32(v1[i][2]), to_f32(v1[i][3]), wx, wy);
        T* o = out + pix[i] * c_out + j;
        o[0] = from_f32<T>(__fmul_rn(odd ? s2 : s0, m[i]));
        o[go] = from_f32<T>(__fmul_rn(odd ? s0 : s1, m[i]));
        o[2 * go] = from_f32<T>(__fmul_rn(odd ? s1 : s2, m[i]));
      }
    } else {
      const int src = g * cg;
      for (int k = 0; k < cg; ++k) {
        T v[P][4];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const I p[4] = {t[i].p00, t[i].p01, t[i].p10, t[i].p11};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[i][q] = __ldg(x + p[q] * c_src + src + k);
          }
        }
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (iy0 + i >= h) continue;
          const float r = lerp2(to_f32(v[i][0]), to_f32(v[i][1]),
                                to_f32(v[i][2]), to_f32(v[i][3]), t[i].wx,
                                t[i].wy);
          out[pix[i] * c_out + k * go + j] = from_f32<T>(__fmul_rn(r, m[i]));
        }
      }
    }
  }
}

template <typename T, typename I, int CG, int GO, int GN>
void launch_grouped(const void* x, const void* fx, const void* fy,
                    const void* mask, void* out, int64_t n, int h, int w,
                    int cg, int go, int gn, cudaStream_t st) {
  const int bx = go < 32 ? go : 32;
  const int by = 256 / bx;
  const int rows = kPixelsPerThread;
  grouped_warp_kernel<T, I, CG, GO, GN>
      <<<dim3((w + by - 1) / by, (h + rows - 1) / rows, (unsigned)n),
         dim3(bx, by), 0, st>>>((const T*)x, (const float*)fx,
                                (const float*)fy, (const float*)mask, (T*)out,
                                h, w, cg, go, gn);
}

template <typename T, typename I>
void launch_grouped_shape(const void* x, const void* fx, const void* fy,
                          const void* mask, void* out, int64_t n, int h, int w,
                          int cg, int go, int gn, cudaStream_t st) {
  // the model's shape, with x aligned to two channels for the paired loads
  if (cg == 3 && go == 32 && gn == 16 &&
      (uintptr_t)x % (2 * sizeof(T)) == 0) {
    launch_grouped<T, I, 3, 32, 16>(x, fx, fy, mask, out, n, h, w, cg, go,
                                    gn, st);
  } else {
    launch_grouped<T, I, 0, 0, 0>(x, fx, fy, mask, out, n, h, w, cg, go, gn,
                                  st);
  }
}

template <typename T>
int launch_grouped_warp(const void* x, const void* fx, const void* fy,
                        const void* mask, void* out, int64_t n, int h, int w,
                        int c_src, int go, int gn, cudaStream_t st) {
  if (n <= 0 || h <= 0 || w <= 0 || go <= 0) return (int)cudaGetLastError();
  if (n > 65535 || h > 65535) return (int)cudaErrorInvalidValue;  // grid
  const int cg = c_src / gn;
  const int64_t most = c_src > go * cg ? c_src : go * cg;
  if (n * h * w * most < (int64_t(1) << 31)) {
    launch_grouped_shape<T, uint32_t>(x, fx, fy, mask, out, n, h, w, cg, go,
                                      gn, st);
  } else {
    launch_grouped_shape<T, int64_t>(x, fx, fy, mask, out, n, h, w, cg, go,
                                     gn, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  Returns a CUDA error code.
extern "C" int lssvc_flow_warp(const void* x, const void* flow, void* out,
                               int64_t n, int h, int w, int c, int dtype,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_flow_warp<float>(source<float>(x, out, c),
                                   source<float>(nullptr, nullptr, 0), flow,
                                   n, h, w, s);
  }
  return launch_flow_warp<__nv_bfloat16>(
      source<__nv_bfloat16>(x, out, c),
      source<__nv_bfloat16>(nullptr, nullptr, 0), flow, n, h, w, s);
}

// a (N,H,W,ca) and b (N,H,W,cb) warped by the same flow into out_a, out_b.
extern "C" int lssvc_flow_warp_pair(const void* a, const void* b,
                                    const void* flow, void* out_a,
                                    void* out_b, int64_t n, int h, int w,
                                    int ca, int cb, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_flow_warp<float>(source<float>(a, out_a, ca),
                                   source<float>(b, out_b, cb), flow, n, h, w,
                                   s);
  }
  return launch_flow_warp<__nv_bfloat16>(
      source<__nv_bfloat16>(a, out_a, ca),
      source<__nv_bfloat16>(b, out_b, cb), flow, n, h, w, s);
}

// a (N,H,W,ca) and b (N,H,W,cb) warped by the same flow into one
// (N,H,W,ca+cb) output: a's channels first, then b's (the packed pair).
extern "C" int lssvc_flow_warp_pair_packed(const void* a, const void* b,
                                           const void* flow, void* out,
                                           int64_t n, int h, int w, int ca,
                                           int cb, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int os = ca + cb;
  if (dtype == 0) {
    return launch_flow_warp_packed<float>(
        packed_source<float>(a, out, ca, os, 0),
        packed_source<float>(b, out, cb, os, ca), flow, n, h, w, s);
  }
  return launch_flow_warp_packed<__nv_bfloat16>(
      packed_source<__nv_bfloat16>(a, out, ca, os, 0),
      packed_source<__nv_bfloat16>(b, out, cb, os, ca), flow, n, h, w, s);
}

extern "C" int lssvc_grouped_warp(const void* x, const void* fx,
                                  const void* fy, const void* mask, void* out,
                                  int64_t n, int h, int w, int c_src, int go,
                                  int group_num, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_grouped_warp<float>(x, fx, fy, mask, out, n, h, w, c_src,
                                      go, group_num, s);
  }
  return launch_grouped_warp<__nv_bfloat16>(x, fx, fy, mask, out, n, h, w,
                                            c_src, go, group_num, s);
}

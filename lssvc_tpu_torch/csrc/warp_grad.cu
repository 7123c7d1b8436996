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
// source gradient and the flow (and mask) gradients once: at the training
// crop (EL pair 1x256x256x(3+48) f32) about 40 MB, 12 us at 3.35 TB/s.
//
// Design (a simple kernel that is right first).  The source gradient is a
// scatter: taps of neighbouring outputs meet on one source pixel, so it is
// summed with f32 atomicAdd into a zeroed f32 buffer (for a bf16 source a
// second kernel rounds it to bf16 once: "accumulated in f32").  The flow
// and mask gradients belong to one output pixel (one unit) each and need
// no atomics, so two runs give the same bits.  flow_warp_backward gives a
// pixel a group of G lanes (G = 4, 8, 16 or 32 by the channel count): the
// lanes take the pixel's channels of both sources in turn, so loads, the
// output gradient's reads and the atomics of a group fall on contiguous
// channels, and the group sums its flow gradient with shuffles.
// grouped_warp_backward gives one thread to a (pixel, unit): neighbouring
// lanes are neighbouring units, so the reads of the flows, mask and output
// gradient and the writes of the flow and mask gradients are coalesced;
// its source taps and atomics scatter with the units' own flows.
// Arithmetic is f32 with explicit round-to-nearest intrinsics (no FMA
// contraction); indices are clamped into range after conversion, as in
// warp.cu, so a NaN flow never reads or writes out of range; offsets are
// 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
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

// The four taps of output pixel `pix` (pixel index into (N, H, W)).
struct Sample {
  int64_t q00, q01, q10, q11;
  float wx, wy, dx, dy;
};

__device__ __forceinline__ Sample sample(float fx, float fy, int64_t pix,
                                         int h, int w) {
  const int64_t hw = (int64_t)h * w;
  const int64_t img = pix / hw;
  const int64_t rem = pix - img * hw;
  const int iy = (int)(rem / w);
  const int ix = (int)(rem - (int64_t)iy * w);
  const Axis ax = axis(fx, ix, w);
  const Axis ay = axis(fy, iy, h);
  Sample s;
  const int64_t r0 = img * hw + (int64_t)ay.i0 * w;
  const int64_t r1 = img * hw + (int64_t)ay.i1 * w;
  s.q00 = r0 + ax.i0;
  s.q01 = r0 + ax.i1;
  s.q10 = r1 + ax.i0;
  s.q11 = r1 + ax.i1;
  s.wx = ax.frac;
  s.wy = ay.frac;
  s.dx = ax.dclip;
  s.dy = ay.dclip;
  return s;
}

// One source of flow_warp_backward: x (N, H, W, c), the output gradient g
// of the same shape, and gx, the f32 accumulator of x's gradient (null when
// x needs none).  c = 0: no source.
template <typename T>
struct Src {
  const T* x;
  const T* g;
  float* gx;
  int c;
};

// One channel of one source at one sample: scatter g's share into gx and
// add the channel's terms of the flow gradient to (sx, sy).
template <typename T>
__device__ __forceinline__ void channel(const Src<T>& s, const Sample& t,
                                        int64_t pix, int c, bool flow_grad,
                                        float& sx, float& sy) {
  const float g = ld(s.g, pix * s.c + c);
  const float ax = __fsub_rn(1.f, t.wx);
  const float ay = __fsub_rn(1.f, t.wy);
  const float gt = __fmul_rn(g, ay);    // the gradient of top
  const float gb = __fmul_rn(g, t.wy);  // of bot
  if (s.gx != nullptr) {
    atomicAdd(s.gx + t.q00 * s.c + c, __fmul_rn(gt, ax));
    atomicAdd(s.gx + t.q01 * s.c + c, __fmul_rn(gt, t.wx));
    atomicAdd(s.gx + t.q10 * s.c + c, __fmul_rn(gb, ax));
    atomicAdd(s.gx + t.q11 * s.c + c, __fmul_rn(gb, t.wx));
  }
  if (flow_grad) {
    const float v00 = ld(s.x, t.q00 * s.c + c);
    const float v01 = ld(s.x, t.q01 * s.c + c);
    const float v10 = ld(s.x, t.q10 * s.c + c);
    const float v11 = ld(s.x, t.q11 * s.c + c);
    const float top = __fadd_rn(__fmul_rn(v00, ax), __fmul_rn(v01, t.wx));
    const float bot = __fadd_rn(__fmul_rn(v10, ax), __fmul_rn(v11, t.wx));
    sx = __fadd_rn(sx, __fadd_rn(__fmul_rn(gt, __fsub_rn(v01, v00)),
                                 __fmul_rn(gb, __fsub_rn(v11, v10))));
    sy = __fadd_rn(sy, __fmul_rn(g, __fsub_rn(bot, top)));
  }
}

// A group of G lanes per output pixel; lanes past the last pixel still
// join the shuffles.  gflow (N, H, W, 2) f32, null when the flow needs no
// gradient.
template <typename T, int G>
__global__ void __launch_bounds__(256)
    flow_warp_backward_kernel(Src<T> a, Src<T> b,
                              const float* __restrict__ flow,
                              float* __restrict__ gflow, int64_t npix, int h,
                              int w) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(tid % G);
  const int64_t pix = tid / G;
  const bool valid = pix < npix;
  const bool flow_grad = gflow != nullptr;
  float sx = 0.f, sy = 0.f, dx = 0.f, dy = 0.f;
  if (valid) {
    const Sample t = sample(flow[2 * pix], flow[2 * pix + 1], pix, h, w);
    dx = t.dx;
    dy = t.dy;
    for (int c = lane; c < a.c; c += G) {
      channel(a, t, pix, c, flow_grad, sx, sy);
    }
    for (int c = lane; c < b.c; c += G) {
      channel(b, t, pix, c, flow_grad, sx, sy);
    }
  }
  if (!flow_grad) return;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    sx = __fadd_rn(sx, __shfl_xor_sync(0xffffffffu, sx, o));
    sy = __fadd_rn(sy, __shfl_xor_sync(0xffffffffu, sy, o));
  }
  if (valid && lane == 0) {
    gflow[2 * pix] = clipped(sx, dx);
    gflow[2 * pix + 1] = clipped(sy, dy);
  }
}

// One thread per (pixel, unit j) of x (N, H, W, c_src) warped into go
// units of cg = c_src / group_num channels.  g (N, H, W, go*cg) in x's
// dtype; fx, fy, mask (N, H, W, go) f32; gx the f32 accumulator of x's
// gradient; gfx, gfy, gmask (N, H, W, go) f32.  Any gradient pointer may
// be null (not needed).
template <typename T>
__global__ void __launch_bounds__(256)
    grouped_warp_backward_kernel(const T* __restrict__ x,
                                 const T* __restrict__ g,
                                 const float* __restrict__ fx,
                                 const float* __restrict__ fy,
                                 const float* __restrict__ mask, float* gx,
                                 float* __restrict__ gfx,
                                 float* __restrict__ gfy,
                                 float* __restrict__ gmask, int64_t total,
                                 int h, int w, int c_src, int go,
                                 int group_num) {
  const int cg = c_src / group_num;
  const bool need_v = gfx != nullptr || gfy != nullptr || gmask != nullptr;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t pix = t / go;
    const int j = (int)(t - pix * go);
    const Sample s = sample(fx[t], fy[t], pix, h, w);
    const float m = mask[t];
    const float ax = __fsub_rn(1.f, s.wx);
    const float ay = __fsub_rn(1.f, s.wy);
    const int src0 = (j % group_num) * cg;
    float sx = 0.f, sy = 0.f, sm = 0.f;
    for (int k = 0; k < cg; ++k) {
      const int c = src0 + k;
      const float gk = ld(g, pix * ((int64_t)go * cg) + (int64_t)k * go + j);
      const float gm = __fmul_rn(gk, m);  // the gradient of the warp
      const float gt = __fmul_rn(gm, ay);
      const float gb = __fmul_rn(gm, s.wy);
      if (gx != nullptr) {
        atomicAdd(gx + s.q00 * c_src + c, __fmul_rn(gt, ax));
        atomicAdd(gx + s.q01 * c_src + c, __fmul_rn(gt, s.wx));
        atomicAdd(gx + s.q10 * c_src + c, __fmul_rn(gb, ax));
        atomicAdd(gx + s.q11 * c_src + c, __fmul_rn(gb, s.wx));
      }
      if (need_v) {
        const float v00 = ld(x, s.q00 * c_src + c);
        const float v01 = ld(x, s.q01 * c_src + c);
        const float v10 = ld(x, s.q10 * c_src + c);
        const float v11 = ld(x, s.q11 * c_src + c);
        const float top = __fadd_rn(__fmul_rn(v00, ax), __fmul_rn(v01, s.wx));
        const float bot = __fadd_rn(__fmul_rn(v10, ax), __fmul_rn(v11, s.wx));
        const float warped = __fadd_rn(__fmul_rn(top, ay),
                                       __fmul_rn(bot, s.wy));
        sm = __fadd_rn(sm, __fmul_rn(gk, warped));
        sx = __fadd_rn(sx, __fadd_rn(__fmul_rn(gt, __fsub_rn(v01, v00)),
                                     __fmul_rn(gb, __fsub_rn(v11, v10))));
        sy = __fadd_rn(sy, __fmul_rn(gm, __fsub_rn(bot, top)));
      }
    }
    if (gfx != nullptr) gfx[t] = clipped(sx, s.dx);
    if (gfy != nullptr) gfy[t] = clipped(sy, s.dy);
    if (gmask != nullptr) gmask[t] = sm;
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

template <typename T, int G>
void launch_flow(Src<T> a, Src<T> b, const float* flow, float* gflow,
                 int64_t npix, int h, int w, cudaStream_t s) {
  flow_warp_backward_kernel<T, G>
      <<<blocks_for(npix * G, 256), 256, 0, s>>>(a, b, flow, gflow, npix, h,
                                                  w);
}

template <typename T>
int flow_backward(const void* a, const void* ga, void* gxa, int ca,
                  const void* b, const void* gb, void* gxb, int cb,
                  const void* flow, void* gflow, int64_t n, int h, int w,
                  cudaStream_t s) {
  const int64_t npix = n * h * w;
  if (npix <= 0) return (int)cudaGetLastError();
  const Src<T> sa{(const T*)a, (const T*)ga, (float*)gxa, ca};
  const Src<T> sb{(const T*)b, (const T*)gb, (float*)gxb, cb};
  const float* f = (const float*)flow;
  float* gf = (float*)gflow;
  const int c = ca > cb ? ca : cb;
  if (c <= 4) {
    launch_flow<T, 4>(sa, sb, f, gf, npix, h, w, s);
  } else if (c <= 8) {
    launch_flow<T, 8>(sa, sb, f, gf, npix, h, w, s);
  } else if (c <= 16) {
    launch_flow<T, 16>(sa, sb, f, gf, npix, h, w, s);
  } else {
    launch_flow<T, 32>(sa, sb, f, gf, npix, h, w, s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int grouped_backward(const void* x, const void* g, const void* fx,
                     const void* fy, const void* mask, void* gx, void* gfx,
                     void* gfy, void* gmask, int64_t n, int h, int w,
                     int c_src, int go, int group_num, cudaStream_t s) {
  const int64_t total = n * h * w * go;
  if (total <= 0) return (int)cudaGetLastError();
  int blocks = blocks_for(total, 256);
  if (blocks > 132 * 64) blocks = 132 * 64;
  grouped_warp_backward_kernel<T><<<blocks, 256, 0, s>>>(
      (const T*)x, (const T*)g, (const float*)fx, (const float*)fy,
      (const float*)mask, (float*)gx, (float*)gfx, (float*)gfy,
      (float*)gmask, total, h, w, c_src, go, group_num);
  return (int)cudaGetLastError();
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
                                   n, h, w, c_src, go, group_num, s);
  }
  return grouped_backward<__nv_bfloat16>(x, g, fx, fy, mask, gx, gfx, gfy,
                                         gmask, n, h, w, c_src, go,
                                         group_num, s);
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

// Fused conv-chain kernel for Hopper (sm_90a), plain C interface.
//
// Stands for the JAX package's Pallas kernel
//   lssvc_tpu/ops/conv_chain.py  _chain_kernel  (via _conv_chain_call,
//     conv_chain_specs, conv_chain)
// and computes what it computes: a chain of 3x3 convs (conv3), 1x1 convs
// (conv1) and depthwise 3x3 convs (dw3), each with an optional f32 bias and
// leaky ReLU, standalone leaky ReLUs (act), residual adds of a saved tensor
// (add_saved) and side-branch convs, where every conv sees zero padding at
// the true image border.  Operands are stored in the compute dtype (f32 or
// bf16); products accumulate in f32; every layer's result is rounded once
// to the compute dtype.
//
// The TPU kernel keeps 8-row strips of every layer in ~120 MB of VMEM.  A
// Hopper block has 227 KB of shared memory, so the layout here is a 2-D
// tile: each block owns a th x tw output tile, loads the input region with
// L pixels of halo on every side (L = the chain's spatial depth; outside the
// image the region is zero), and runs the whole chain on it, each spatial
// layer on a region one pixel smaller per side than its input.  After every
// conv layer each position outside the true image is set to exactly 0 (the
// TPU kernel's mask_valid): without it a halo position would hold
// leaky(bias) and the next layer would read it as padding.
//
// Intermediates live in "slots", each holding one layer's region: the host
// assigns logical layer buffers to slots by liveness (an op never writes a
// slot it reads).  The slots sit in dynamic shared memory when they fit in
// 227 KB; otherwise in a per-block scratch slice of global memory (grid
// capped to a few blocks per SM, so the slices stay small and mostly in L2).
// No full-size intermediate tensor exists.  One launch runs the whole chain
// for one image.
//
// Bound: operations.  A 48-channel 3x3 layer does 2*9*48*48 FLOP per pixel
// against ~200 bytes of input and output per pixel; on the CUDA cores (f32,
// 67 TFLOP/s) or the bf16 tensor cores (989 TFLOP/s) the FLOPs dominate.
// This version runs on the CUDA cores.  A slot stores its region channel by
// channel (planar, with an odd plane stride), so a warp's 32 lanes read 32
// consecutive pixels of one channel plane without bank conflicts.  Each
// warp takes 32*kP output pixels against one group of kQ output channels:
// its weights are uniform across the warp (two float4 broadcasts per tap
// and input channel), and each lane's kP x kQ register tile turns kP + 2
// loads into kP*kQ FMAs.  The halo is recomputed by every tile.  Tensor
// cores (wgmma), TMA and halo reuse are later work.
//
// Weights arrive repacked on the host, in f32 holding compute-dtype values,
// each row padded with zeros to a multiple of kQ output channels: conv3
// (9*Ci, Co') with row (dy*3+dx)*Ci + ci, conv1 (Ci, Co'), dw3 (9, C').
// Offsets into global memory are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOps = 64;
constexpr int kOpInts = 12;  // ints per op record from the host
constexpr int kThreads = 512;
constexpr int kP = 4;  // output pixels per lane (32 apart)
constexpr int kQ = 8;  // output channels per warp item; weight rows pad to it

enum Kind { kConv3 = 0, kConv1 = 1, kDw3 = 2, kAct = 3, kAdd = 4 };

struct Op {
  int kind, src, dst, sav;  // slots
  int cin, cout;
  int m_src, m_dst, m_sav;  // halo margins of the stored regions
  int has_slope, woff, boff;
  float slope;
};

struct Chain {
  Op ops[kMaxOps];
  int n_ops, h, w, c_in, c_out;
  int L, th, tw;
  int in_slot, out_slot, m_out, n_slots;
  int64_t slot_elems;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// A region of margin m is (th+2m) x (tw+2m) pixels, stored channel by
// channel: pixel p of channel c at c*plane(m) + p.
struct Tile {
  int th, tw, ty0, tx0, h, w;
  __device__ int cols(int m) const { return tw + 2 * m; }
  __device__ int npix(int m) const { return (th + 2 * m) * (tw + 2 * m); }
  __device__ int plane(int m) const { return npix(m) | 1; }  // odd stride
  // is local pixel (r, c) of a region with margin m inside the image?
  __device__ bool inside(int m, int r, int c) const {
    const int gy = ty0 - m + r, gx = tx0 - m + c;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  }
};

// bias added by the caller; leaky ReLU, zero outside the image, round to T
template <typename T>
__device__ __forceinline__ T epilogue(const Op& op, float a, bool in) {
  if (op.has_slope) a = a >= 0.f ? a : a * op.slope;
  return from_f32<T>(in ? a : 0.f);
}

// conv3 (KS=3) and conv1 (KS=1).  A warp item is 32*kP output pixels (lane
// l holds pixels l, l+32, ...) against kQ output channels.
template <typename T, int KS>
__device__ void conv_layer(const Op& op, const Tile& t, const T* src, T* dst,
                           const float* __restrict__ wts,
                           const float* __restrict__ bias) {
  const int mo = op.m_dst, ws = t.cols(op.m_src), wo = t.cols(mo);
  const int ps = t.plane(op.m_src), pd = t.plane(mo);
  const int off = op.m_src - mo - KS / 2;
  const int npix = t.npix(mo), ci_n = op.cin, co_n = op.cout;
  const int co_pad = (co_n + kQ - 1) / kQ * kQ;
  const int n_qg = co_pad / kQ, n_chunks = (npix + 32 * kP - 1) / (32 * kP);
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int u = threadIdx.x >> 5; u < n_chunks * n_qg; u += n_warps) {
    const int co0 = (u % n_qg) * kQ, p0 = (u / n_qg) * 32 * kP + lane;
    int sidx[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int p = min(p0 + 32 * i, npix - 1);
      const int r = p / wo, c = p - r * wo;
      sidx[i] = (r + off) * ws + c + off;
    }
    float acc[kP][kQ];
#pragma unroll
    for (int i = 0; i < kP; ++i)
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[i][j] = 0.f;
    const float* wq = wts + op.woff + co0;
    for (int ci = 0; ci < ci_n; ++ci) {
      const T* pl = src + ci * ps;
#pragma unroll
      for (int tap = 0; tap < KS * KS; ++tap) {
        const int dy = tap / KS, dx = tap - dy * KS;
        const float4* wp = reinterpret_cast<const float4*>(
            wq + (int64_t)(tap * ci_n + ci) * co_pad);
        const float4 wa = __ldg(wp), wb = __ldg(wp + 1);
        const float wv[kQ] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          const float v = to_f32(pl[sidx[i] + dy * ws + dx]);
#pragma unroll
          for (int j = 0; j < kQ; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int p = p0 + 32 * i;
      if (p >= npix) break;
      const int r = p / wo, c = p - r * wo;
      const bool in = t.inside(mo, r, c);
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int co = co0 + j;
        if (co < co_n)
          dst[co * pd + p] =
              epilogue<T>(op, acc[i][j] + bias[op.boff + co], in);
      }
    }
  }
}

// dw3, act and add_saved: one item per (channel, pixel), pixels fastest
template <typename T>
__device__ void elementwise_layer(const Op& op, const Tile& t, const T* src,
                                  const T* sav, T* dst,
                                  const float* __restrict__ wts,
                                  const float* __restrict__ bias) {
  const int mo = op.m_dst, ws = t.cols(op.m_src), wo = t.cols(mo);
  const int c_n = op.cout, npix = t.npix(mo);
  const int ps = t.plane(op.m_src), pd = t.plane(mo);
  const int off = op.m_src - mo - (op.kind == kDw3 ? 1 : 0);
  for (int e = threadIdx.x; e < npix * c_n; e += blockDim.x) {
    const int ch = e / npix, p = e - ch * npix;
    const int r = p / wo, c = p - r * wo;
    const int s = ch * ps + (r + off) * ws + c + off;
    float a;
    if (op.kind == kDw3) {
      const int co_pad = (c_n + kQ - 1) / kQ * kQ;
      const float* W = wts + op.woff + ch;
      a = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - dy * 3;
        a = fmaf(to_f32(src[s + dy * ws + dx]), __ldg(W + tap * co_pad), a);
      }
      dst[ch * pd + p] =
          epilogue<T>(op, a + bias[op.boff + ch], t.inside(mo, r, c));
    } else if (op.kind == kAct) {
      a = to_f32(src[s]);
      dst[ch * pd + p] = from_f32<T>(a >= 0.f ? a : a * op.slope);
    } else {  // kAdd: f32 sum, rounded once
      const int so = op.m_sav - mo, wsv = t.cols(op.m_sav);
      const float b =
          to_f32(sav[ch * t.plane(op.m_sav) + (r + so) * wsv + c + so]);
      dst[ch * pd + p] = from_f32<T>(to_f32(src[s]) + b);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_chain_kernel(const __grid_constant__ Chain ch,
                      const T* __restrict__ x, T* __restrict__ out,
                      const float* __restrict__ wts,
                      const float* __restrict__ bias, T* scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slots = scratch != nullptr
                 ? scratch + (int64_t)blockIdx.x * ch.n_slots * ch.slot_elems
                 : reinterpret_cast<T*>(smem_raw);
  const int tiles_x = (ch.w + ch.tw - 1) / ch.tw;
  const int tiles = tiles_x * ((ch.h + ch.th - 1) / ch.th);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t{ch.th, ch.tw, (tile / tiles_x) * ch.th,
                 (tile % tiles_x) * ch.tw, ch.h, ch.w};
    {  // input region with L px of halo, zero outside the image; channels
       // fastest, so the reads of x coalesce
      T* dst = slots + ch.in_slot * ch.slot_elems;
      const int wi = t.cols(ch.L), c_n = ch.c_in, pd = t.plane(ch.L);
      for (int e = threadIdx.x; e < t.npix(ch.L) * c_n; e += blockDim.x) {
        const int p = e / c_n, c = e - p * c_n;
        const int r = p / wi, cc = p - r * wi;
        const int gy = t.ty0 - ch.L + r, gx = t.tx0 - ch.L + cc;
        dst[c * pd + p] = t.inside(ch.L, r, cc)
                              ? x[((int64_t)gy * ch.w + gx) * c_n + c]
                              : from_f32<T>(0.f);
      }
    }
    __syncthreads();
    for (int i = 0; i < ch.n_ops; ++i) {
      const Op& op = ch.ops[i];
      const T* src = slots + op.src * ch.slot_elems;
      T* dst = slots + op.dst * ch.slot_elems;
      if (op.kind == kConv3) {
        conv_layer<T, 3>(op, t, src, dst, wts, bias);
      } else if (op.kind == kConv1) {
        conv_layer<T, 1>(op, t, src, dst, wts, bias);
      } else {
        const T* sav = op.kind == kAdd ? slots + op.sav * ch.slot_elems : src;
        elementwise_layer<T>(op, t, src, sav, dst, wts, bias);
      }
      __syncthreads();
    }
    {  // the tile's own pixels of the last layer, channels fastest
      const T* src = slots + ch.out_slot * ch.slot_elems;
      const int m = ch.m_out, ws = t.cols(m), ps = t.plane(m);
      const int c_n = ch.c_out;
      for (int e = threadIdx.x; e < t.th * t.tw * c_n; e += blockDim.x) {
        const int p = e / c_n, c = e - p * c_n;
        const int r = p / t.tw, cc = p - r * t.tw;
        const int gy = t.ty0 + r, gx = t.tx0 + cc;
        if (gy < ch.h && gx < ch.w)
          out[((int64_t)gy * ch.w + gx) * c_n + c] =
              src[c * ps + (r + m) * ws + cc + m];
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const Chain& ch, const void* x, void* out, const float* wts,
           const float* bias, void* scratch, int grid, int smem_bytes,
           cudaStream_t s) {
  auto kernel = conv_chain_kernel<T>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem_bytes, s>>>(ch, (const T*)x, (T*)out, wts,
                                            bias, (T*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// One image.  ops: n_ops records of kOpInts ints (kind, src, dst, sav, cin,
// cout, m_src, m_dst, m_sav, has_slope, woff, boff) and n_ops slopes, in
// host memory.  scratch: null for shared-memory slots, else grid * n_slots *
// slot_elems elements of global memory.  dtype: 0 = float32, 1 = bfloat16
// (x, out and the slots).  Returns a CUDA error code, 0 on success.
extern "C" int lssvc_conv_chain(const void* x, void* out, const void* wts,
                                const void* bias, void* scratch,
                                const int* ops, const float* slopes,
                                int n_ops, int h, int w, int c_in, int c_out,
                                int L, int th, int tw, int in_slot,
                                int out_slot, int m_out, int n_slots,
                                int64_t slot_elems, int grid, int smem_bytes,
                                int dtype, void* stream) {
  if (n_ops < 0 || n_ops > kMaxOps) return (int)cudaErrorInvalidValue;
  Chain ch;
  for (int i = 0; i < n_ops; ++i) {
    const int* o = ops + i * kOpInts;
    ch.ops[i] = Op{o[0], o[1], o[2], o[3], o[4],  o[5],
                   o[6], o[7], o[8], o[9], o[10], o[11], slopes[i]};
  }
  ch.n_ops = n_ops;
  ch.h = h;
  ch.w = w;
  ch.c_in = c_in;
  ch.c_out = c_out;
  ch.L = L;
  ch.th = th;
  ch.tw = tw;
  ch.in_slot = in_slot;
  ch.out_slot = out_slot;
  ch.m_out = m_out;
  ch.n_slots = n_slots;
  ch.slot_elems = slot_elems;
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* wf = (const float*)wts;
  const float* bf = (const float*)bias;
  if (dtype == 0)
    return launch<float>(ch, x, out, wf, bf, scratch, grid, smem_bytes, s);
  return launch<__nv_bfloat16>(ch, x, out, wf, bf, scratch, grid, smem_bytes,
                               s);
}

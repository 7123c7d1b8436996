// Bilinear backward-warp kernels for Hopper (sm_90a), plain C interface.
//
// flow_warp stands for the JAX package's Pallas warp kernels
//   lssvc_tpu/ops/warp_pallas.py  _warp_kernel_cblock  (via
//     _flow_warp_pallas_cblock: the tiny tier of flow_warp_auto, |flow| <= 2)
//   lssvc_tpu/ops/warp_pallas.py  _warp_kernel         (via
//     _flow_warp_pallas: the windowed tier, |fy| <= 26, |fx| <= 62)
// and for the XLA fallback lssvc_tpu/ops/warp.py flow_warp_lowmem.
//
// grouped_warp stands for
//   lssvc_tpu/ops/warp_pallas.py  _grouped_warp_kernel_cblock  (via
//     _grouped_warp_pallas_cblock: the tiny b=2 and mid b=12 tiers of
//     grouped_warp_auto)
//   lssvc_tpu/ops/warp_pallas.py  _grouped_warp_kernel  (via
//     _grouped_warp_pallas: the windowed tier)
// and for the XLA fallback lssvc_tpu/ops/warp.py grouped_warp_lowmem.
//
// The TPU needed those tiers because XLA:TPU lowers gathers to scalar loops
// and a VMEM window bounds how far a sample may move.  On Hopper a
// data-dependent load from L2/HBM is native, so one gather kernel is exact
// for every flow magnitude and there is no tier dispatch.
//
// Bound: bytes.  Each kernel does ~20 flops per output element and must
// move x read once, the flows (and mask) read once and the output written
// once; at 3.35 TB/s that is the least time (EL pair 1x1152x1920x51 f32:
// 0.275 ms; grouped 1x1152x1920x48 -> 96: 0.634 ms).  The design keeps the
// reads of x coalesced along the channel axis (neighbouring threads hold
// neighbouring channels of the same pixel, or neighbouring units whose
// source channels and writes are adjacent), reads each flow value from L1
// after the first thread of a pixel fetched it, and writes the output once.
// The four taps of a sample re-read x through L2; with smooth flows the
// taps of neighbouring pixels share cache lines.  Shared-memory staging of
// source tiles and 16-byte vector loads are later work.
//
// Arithmetic follows lssvc_tpu_torch/ops/warp.py (and lssvc_tpu/ops/warp.py)
// operation for operation, with explicit round-to-nearest intrinsics so that
// nvcc does not contract them into FMAs: the result equals the plain
// PyTorch version bit for bit.  Integer indices are clamped into range after
// conversion, so a NaN flow yields NaN and never an out-of-range read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
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

// Launch shapes, each the faster of the variants tried on an H100:
// flow_warp runs a grid-stride loop over the flat output on a grid capped at
// a few waves of the card; its index type I is 32-bit unsigned when the
// tensor has fewer than 2^31 elements, else 64-bit (splitting a flat index
// into image, row, column and channel is several times cheaper in 32 bits).
// grouped_warp runs one block row per image row (blockIdx.y) with 32-bit
// indices inside the row and 64-bit offsets.

// One thread per (pixel, channel): x (N,H,W,C), flow (N,H,W,2) f32.
template <typename T, typename I>
__global__ void flow_warp_kernel(const T* __restrict__ x,
                                 const float* __restrict__ flow,
                                 T* __restrict__ out, I total, int h, int w,
                                 int c) {
  const I hw = (I)h * w;
  for (I e = blockIdx.x * (I)blockDim.x + threadIdx.x; e < total;
       e += (I)gridDim.x * blockDim.x) {
    const I pix = e / c;
    const int ch = (int)(e - pix * c);
    const I base = pix / hw * hw;  // first pixel of this image
    const int rem = (int)(pix - base);
    const int iy = rem / w;
    const int ix = rem - iy * w;
    int x0, x1, y0, y1;
    float wx, wy;
    coords(flow[2 * pix], ix, w, &x0, &x1, &wx);
    coords(flow[2 * pix + 1], iy, h, &y0, &y1, &wy);
    const I r0 = (base + (I)y0 * w) * c + ch;
    const I r1 = (base + (I)y1 * w) * c + ch;
    float v00 = load_f32(x, r0 + (I)x0 * c);
    float v01 = load_f32(x, r0 + (I)x1 * c);
    float v10 = load_f32(x, r1 + (I)x0 * c);
    float v11 = load_f32(x, r1 + (I)x1 * c);
    store(out, e, lerp2(v00, v01, v10, v11, wx, wy));
  }
}

// One thread per (pixel, unit j): x (N,H,W,C_src); fx, fy, mask (N,H,W,go)
// f32; out (N,H,W,go*cg) with out[..., k*go + j] = mask_j * warp_j(
// x[..., (j % group_num)*cg + k]).  For fixed k, neighbouring units write
// neighbouring addresses.
template <typename T>
__global__ void grouped_warp_kernel(const T* __restrict__ x,
                                    const float* __restrict__ fx,
                                    const float* __restrict__ fy,
                                    const float* __restrict__ mask,
                                    T* __restrict__ out, int rows, int h,
                                    int w, int c_src, int go, int group_num) {
  const int cg = c_src / group_num;
  const int row_elems = w * go;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int img = row / h;
    const int iy = row - img * h;
    const int64_t img_base = (int64_t)img * h * w;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < row_elems;
         i += gridDim.x * blockDim.x) {
      const int ix = i / go;
      const int j = i - ix * go;
      const int64_t pix = img_base + (int64_t)iy * w + ix;
      const int64_t e = pix * go + j;
      int x0, x1, y0, y1;
      float wx, wy;
      coords(fx[e], ix, w, &x0, &x1, &wx);
      coords(fy[e], iy, h, &y0, &y1, &wy);
      const float m = mask[e];
      const int src = (j % group_num) * cg;
      const int64_t r0 = (img_base + (int64_t)y0 * w) * c_src + src;
      const int64_t r1 = (img_base + (int64_t)y1 * w) * c_src + src;
      const int64_t o = pix * go * cg + j;
      for (int k = 0; k < cg; ++k) {
        float v00 = load_f32(x, r0 + (int64_t)x0 * c_src + k);
        float v01 = load_f32(x, r0 + (int64_t)x1 * c_src + k);
        float v10 = load_f32(x, r1 + (int64_t)x0 * c_src + k);
        float v11 = load_f32(x, r1 + (int64_t)x1 * c_src + k);
        store(out, o + (int64_t)k * go,
              __fmul_rn(lerp2(v00, v01, v10, v11, wx, wy), m));
      }
    }
  }
}

constexpr int kThreads = 256;

unsigned grid_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 64;  // 132 SMs on an H100 SXM; ~8 waves
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <typename T>
void launch_flow_warp(const void* x, const void* flow, void* out,
                      int64_t total, int h, int w, int c, cudaStream_t s) {
  // under 2^31 elements, 32-bit indices cannot wrap: e + stride < 2^32
  if (total < (int64_t(1) << 31)) {
    flow_warp_kernel<T, uint32_t><<<grid_for(total), kThreads, 0, s>>>(
        (const T*)x, (const float*)flow, (T*)out, (uint32_t)total, h, w, c);
  } else {
    flow_warp_kernel<T, int64_t><<<grid_for(total), kThreads, 0, s>>>(
        (const T*)x, (const float*)flow, (T*)out, total, h, w, c);
  }
}

dim3 grid_rows(int rows, int row_elems) {
  int bx = (row_elems + kThreads - 1) / kThreads;
  return dim3(bx < 65535 ? bx : 65535, rows < 65535 ? rows : 65535);
}

template <typename T>
void launch_grouped_warp(const void* x, const void* fx, const void* fy,
                         const void* mask, void* out, int rows, int h, int w,
                         int c_src, int go, int group_num, cudaStream_t s) {
  grouped_warp_kernel<T><<<grid_rows(rows, w * go), kThreads, 0, s>>>(
      (const T*)x, (const float*)fx, (const float*)fy, (const float*)mask,
      (T*)out, rows, h, w, c_src, go, group_num);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  Returns cudaGetLastError().
extern "C" int lssvc_flow_warp(const void* x, const void* flow, void* out,
                               int64_t n, int h, int w, int c, int dtype,
                               void* stream) {
  const int64_t total = n * h * w * c;
  cudaStream_t s = (cudaStream_t)stream;
  if (total > 0) {
    if (dtype == 0) {
      launch_flow_warp<float>(x, flow, out, total, h, w, c, s);
    } else {
      launch_flow_warp<__nv_bfloat16>(x, flow, out, total, h, w, c, s);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int lssvc_grouped_warp(const void* x, const void* fx,
                                  const void* fy, const void* mask, void* out,
                                  int64_t n, int h, int w, int c_src, int go,
                                  int group_num, int dtype, void* stream) {
  const int rows = (int)(n * h);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows > 0 && w * go > 0) {
    if (dtype == 0) {
      launch_grouped_warp<float>(x, fx, fy, mask, out, rows, h, w, c_src, go,
                                 group_num, s);
    } else {
      launch_grouped_warp<__nv_bfloat16>(x, fx, fy, mask, out, rows, h, w,
                                         c_src, go, group_num, s);
    }
  }
  return (int)cudaGetLastError();
}

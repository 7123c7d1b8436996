// Fused conv-chain kernel for Hopper (sm_90a) on the tensor cores, plain C
// interface.
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
// Tiling.  The TPU kernel keeps 8-row strips of every layer in ~120 MB of
// VMEM; a Hopper block has 227 KB of shared memory.  So each block owns a
// th x tw output tile, loads the input region with L pixels of halo on
// every side (L = the chain's spatial depth; zero outside the image) and
// runs the whole chain on it, each spatial layer on a region one pixel
// smaller per side.  After every conv each position outside the true image
// is set to exactly 0 (the TPU kernel's mask_valid).  Intermediates live in
// "slots" (the host assigns layer buffers to slots by liveness); the last
// layer writes the tile's own pixels straight to `out`.  Slots sit in
// shared memory when they fit beside the weight ring, else in a per-block
// scratch slice of global memory.  One launch runs the whole chain for one
// image, on a persistent grid of one 384-thread block (3 warpgroups) per
// SM that walks the tiles.
//
// Bound: operations.  A 48-channel 3x3 layer does 2*9*48*48 FLOP per pixel
// against ~200 bytes of input and output per pixel.  bf16: 989 TFLOP/s on
// the tensor cores (the bench chain's 366.9 GFLOP: 0.371 ms on an H100 SXM
// at 700 W).  f32: three TF32 products per product at 495 TFLOP/s, 165
// TFLOP/s effective (2.224 ms).  At N = 48 a wgmma reads 2 KB of A and
// 1.5 KB of B from shared memory per 24 tensor-core cycles, so shared
// memory bandwidth (128 B/cycle) holds it to about 85% of the bf16 peak.
//
// This design replaces a CUDA-core one (register tiles of FMAs over
// channel-planar slots).  What it does about that design's four costs:
// 1. Tensor cores.  conv3 and conv1 are implicit GEMMs, M = the layer
//    region's pixels in 64-row tiles, N = Co padded to 16 (chunks of <= 64),
//    K = taps x Ci padded to 16 with zero weights and zero channels, through
//    wgmma.mma_async m64nNk16 (bf16) or m64nNk8 (.tf32) with f32
//    accumulators.  f32 splits each operand into hi = tf32(a) and lo =
//    tf32(a - hi) (cvt.rna; the host splits the weights) and accumulates
//    hi*hi + hi*lo + lo*hi, about 2^-21 relative per product, so f32 keeps
//    f32 accuracy without TF32 semantics.  The tensor cores' f32
//    accumulation truncates, so f32 (and bf16 from 64 input channels)
//    adds the accumulator into an f32 total every tap and 6 k-steps.
// 2. Loads.  Slots are chunk-planar: a plane per 16-byte chunk of channels
//    (8 bf16 or 4 f32), pixel after pixel.  Eight consecutive pixels of a
//    plane are one 8-row x 16-byte core matrix at any 16-byte start, so:
//    bf16 A comes straight from the slot by a shared-memory descriptor
//    (SBO = 128 bytes, LBO = the plane stride), the M rows running at the
//    source region's pitch so that a tap is one offset for the whole tile
//    (implicit im2col; a one-pixel shift moves the start by 16 bytes).
//    f32 A, which must be split in registers, comes by ldmatrix, whose
//    eight 16-byte rows are one such core matrix, free of bank conflicts.
//    Register A makes ptxas wait for the tensor cores before the registers
//    are rewritten, so those products run in groups of 2 k-steps.  B (the
//    weights, packed on the host in the compute dtype in wgmma's K-major
//    core-matrix layout) streams per layer through a ring of two K-slice
//    stages (1, 3 or 9 taps, the most that fit) loaded with cp.async while
//    the previous stage multiplies.  dw3, act and add_saved run on the CUDA
//    cores over 16-byte chunks.
// 3. Halo.  The host plan picks the tile and stage size that minimise the
//    tensor-core work per output pixel (halo, 64-row padding and pitch
//    columns included) among those whose slots and ring fit; the input of
//    a block's next tile is loaded with cp.async (zero-fill outside the
//    image) during its current tile's last layer when that layer leaves the
//    input slot free.
// 4. Occupancy.  Three warpgroups each take every third M tile, up to four
//    tiles (two with totals) per pass with an accumulator each, and keep up
//    to three k-step groups in flight.
//
// Deterministic: no atomics and no split-K, so a batch equals its images
// launched one by one.  Offsets into global memory are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {


constexpr int kMaxOps = 64;
constexpr int kOpInts = 13;  // ints per op record from the host
constexpr int kGroups = 3;   // warpgroups per block
constexpr int kThreads = 128 * kGroups;
constexpr int kChunk = 64;   // output channels of one wgmma at most

enum Kind { kConv3 = 0, kConv1 = 1, kDw3 = 2, kAct = 3, kAdd = 4 };

struct Op {
  int kind, src, dst, sav;  // slots; dst < 0: the chain's output, in `out`
  int cin, cout_p;          // padded channels read and written
  int m_src, m_dst, m_sav;  // halo margins of the stored regions
  int has_slope, woff, boff;
  int taps;  // conv3 taps per weight stage (1, 3 or 9)
  float slope;
};

struct Chain {
  Op ops[kMaxOps];
  int n_ops, h, w, c_in, c_out, cin_p;
  int L, th, tw, in_slot, n_slots, ring_bytes, prefetch;
  int64_t slot_elems;
};

template <typename T>
struct Vec;  // the 32-bit pair and the 16-byte vector of a dtype
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void put2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void put2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
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

// A region of margin m is (th+2m) x (tw+2m) pixels, stored chunk-planar:
// 16-byte chunks of channels (8 bf16 or 4 f32), each chunk's plane pixel
// by pixel, plane(m) pixels apart.  With bf16 a plane is kPlanePad pixels
// longer than the region: a GEMM's last M tile, read by descriptor, reads
// up to 65 pixels past it.
constexpr int kPlanePad = 72;
struct Tile {
  int th, tw, ty0, tx0, h, w, pad;
  __device__ int rows(int m) const { return th + 2 * m; }
  __device__ int cols(int m) const { return tw + 2 * m; }
  __device__ int npix(int m) const { return (th + 2 * m) * (tw + 2 * m); }
  __device__ int plane(int m) const { return npix(m) + pad; }
  // is local pixel (r, c) of a region with margin m inside the image?
  __device__ bool inside(int m, int r, int c) const {
    const int gy = ty0 - m + r, gx = tx0 - m + c;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  }
  // the offset in `out` of local pixel (r, c) if it is one of the tile's
  // own pixels inside the image, else -1
  __device__ int64_t own(int m, int r, int c) const {
    const int y = r - m, x = c - m;
    if (y < 0 || y >= th || x < 0 || x >= tw || ty0 + y >= h || tx0 + x >= w)
      return -1;
    return (int64_t)(ty0 + y) * w + tx0 + x;
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all of this thread's copies landed, and (after a barrier) everyone's are
// visible to wgmma, which reads shared memory through the async proxy
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile(
      "cp.async.wait_all;\n"
      "fence.proxy.async.shared::cta;\n" ::: "memory");
}

// this thread's shared-memory stores become visible to wgmma (the async
// proxy) after the next barrier
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8x8 b16 matrices; lane l gives the address of row l%8 of matrix l/8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// shared-memory matrix descriptor, no swizzle (8-row x 16-byte core
// matrices): lbo = bytes between core matrices along K, sbo = along N
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of r across this point
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// round to TF32 (10 mantissa bits), nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the wgmma products with A from registers, B from a shared-memory descriptor
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                               uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  // A from a shared-memory descriptor too
  static __device__ __forceinline__ void bf16_ss(float* d, uint64_t da,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                               uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  // A from a shared-memory descriptor too
  static __device__ __forceinline__ void bf16_ss(float* d, uint64_t da,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                               uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  // A from a shared-memory descriptor too
  static __device__ __forceinline__ void bf16_ss(float* d, uint64_t da,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                               uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  // A from a shared-memory descriptor too
  static __device__ __forceinline__ void bf16_ss(float* d, uint64_t da,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The input region of tile t (margin L) into slot `dst`, zero outside the
// image and in the pad channels.  With whole 16-byte chunks in shared
// memory the copies are cp.async (zero-filled outside the image) and land
// by the next cp_async_wait_all, so a tile's input can load while the
// previous tile runs.
template <typename T, bool kSmem>
__device__ void load_input(const Chain& ch, const Tile& t,
                           const T* __restrict__ x, T* dst) {
  constexpr int kV = Vec<T>::kN;
  const int wi = t.cols(ch.L), npix = t.npix(ch.L), cs = t.plane(ch.L) * kV;
  if (ch.c_in == ch.cin_p) {  // whole chunks
    const int nv = ch.c_in / kV;
    for (int e = threadIdx.x; e < npix * nv; e += blockDim.x) {
      const int p = e / nv, v = e - p * nv;
      const int r = p / wi, c = p - r * wi;
      const bool in = t.inside(ch.L, r, c);
      const T* s = in ? x + ((int64_t)(t.ty0 - ch.L + r) * ch.w + t.tx0 -
                             ch.L + c) * ch.c_in + v * kV
                      : x;
      T* d = dst + v * cs + p * kV;
      if constexpr (kSmem) {
        cp_async16(smem_addr(d), s, in ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(d) =
            in ? *reinterpret_cast<const uint4*>(s) : make_uint4(0, 0, 0, 0);
      }
    }
    if constexpr (kSmem) cp_async_commit();
  } else {
    const int cp = ch.cin_p;
    for (int e = threadIdx.x; e < npix * cp; e += blockDim.x) {
      const int p = e / cp, c = e - p * cp;
      const int r = p / wi, cc = p - r * wi;
      dst[(c / kV) * cs + p * kV + c % kV] =
          t.inside(ch.L, r, cc) && c < ch.c_in
              ? x[((int64_t)(t.ty0 - ch.L + r) * ch.w + t.tx0 - ch.L + cc) *
                      ch.c_in + c]
              : from_f32<T>(0.f);
    }
  }
}

// Weight stage s (rows [s*kst, (s+1)*kst) of K) of one chunk block: its hi
// part, then in f32 its lo part, with cp.async into a ring buffer.
template <typename T>
__device__ void load_stage(T* buf, const T* __restrict__ w, int K, int nc,
                           int kst, int s, int parts) {
  constexpr int kV = 16 / sizeof(T);
  const int n = kst * nc / kV;  // vectors per part
  for (int e = threadIdx.x; e < parts * n; e += blockDim.x) {
    const int part = e / n, v = e - part * n;
    cp_async16(smem_addr(buf + part * kst * nc + v * kV),
               w + (int64_t)part * K * nc + (int64_t)s * kst * nc + v * kV,
               16);
  }
  cp_async_commit();
}

// One pass over output channels [n0, n0 + N) of a conv3 or conv1 layer, as
// an implicit GEMM: K = taps x cin, N, and M = the output region's pixels.
// In this pass warpgroup g takes the MT M tiles m0 + g, m0 + g + 3, ...,
// with an f32 accumulator each; a tile past the region repeats the last
// one and is not stored.  A k-step is 16 bf16 or 8 TF32 channels of one
// tap, two 16-byte chunks of the slot:
// - bf16 in shared memory: A straight from the slot by a descriptor (eight
//   consecutive pixels of a chunk plane are one 8-row core matrix, the
//   next eight 128 bytes on, at any 16-byte start), B from the stage; up
//   to three k-step groups in flight.  The M rows run at the source
//   region's pitch ws (the last ws - wo columns of each row are computed
//   and not stored), so that row v of tap (dy, dx) reads source pixel
//   v + (off + dy) * ws + off + dx: one offset for the whole 64-row tile.
// - otherwise A through registers, 2 k-steps x MT tiles per group: ldmatrix
//   in shared memory, plain loads in global memory.  In f32 each A value is
//   split into TF32 hi + lo and each k-step runs hi*hi + hi*lo + lo*hi.
// The tensor cores' f32 accumulation truncates, so with kTot (f32, wide
// bf16) the accumulator is added into an f32 total (round to nearest) and
// restarted every tap and every kFlush k-steps.  The weights stream through
// a ring of two stage buffers, the next stage loading while this one
// multiplies.
template <typename T, bool kSmem, int N, int MT, bool kTot>
__device__ void conv_pass(const Chain& ch, const Op& op, const Tile& t,
                          const T* src, T* dst, T* __restrict__ out,
                          const T* __restrict__ w,
                          const float* __restrict__ bias, T* ring, int n0,
                          int m0, int nmt) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr bool kShared = kSmem && !kF32;  // A by descriptor
  constexpr int kV = Vec<T>::kN;          // channels per 16-byte chunk
  constexpr int kK = 2 * kV;              // channels per k-step
  constexpr int kParts = kF32 ? 2 : 1;    // B as TF32 hi (and lo)
  constexpr int kFlush = 6;  // k-steps per accumulator run, at most
  constexpr uint32_t kNB = N / 8;         // 8-column core matrices of B
  constexpr uint64_t kDesc = (2 * kNB * 128) >> 4;  // B: next k-step
  const int KS = op.kind == kConv3 ? 3 : 1, cin = op.cin;
  const int mo = op.m_dst, ws = t.cols(op.m_src), wo = t.cols(mo);
  const int ho = t.rows(mo), off = op.m_src - mo - KS / 2;
  const int pitch = kShared ? ws : wo;  // of the M rows (conv_passes')
  const int base = off * (ws + 1);
  const int cs = t.plane(op.m_src) * kV;  // elements between chunk planes
  const int taps = KS == 3 ? op.taps : 1, nst = KS * KS / taps;
  const int kst = taps * cin, K = KS * KS * cin;
  const int ring_elems = ch.ring_bytes / (int)sizeof(T);
  const uint32_t lo_bytes = kst * N * sizeof(T);
  const int grp = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const T* wc = w + op.woff + (int64_t)kParts * K * n0;  // the chunk's block
  // source pixel at tap 0 of each M tile's first row (descriptor A), or
  // of this lane's ldmatrix row, or of its rows g and g + 8 (global; row
  // g + 8 is 8 pixels on, or clamped with row g past the region's end)
  int row[MT], row8[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // a tile past the region repeats the last one's rows, which stay
    // inside the padded planes
    const int v0 = min(m0 + mt * kGroups + grp, nmt - 1) * 64;
    if constexpr (kShared) {
      row[mt] = v0 + base;
    } else {
      const int lr = kSmem ? (lane & 7) + ((lane >> 3) & 1) * 8 : g;
      const int v = min(v0 + 16 * warp + lr, ho * wo - 1);
      const int py = v / wo;
      row[mt] = (py + off) * ws + v - py * wo + off;
      const int v8 = min(v0 + 16 * warp + g + 8, ho * wo - 1);
      const int py8 = v8 / wo;
      row8[mt] = (py8 + off) * ws + v8 - py8 * wo + off;
    }
  }
  // descriptor A: each tile's first row at tap 0, chunk 0
  uint64_t a_desc[MT];
  if constexpr (kShared) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      a_desc[mt] = desc_kmajor(smem_addr(src + row[mt] * kV),
                               cs * (int)sizeof(T), 128);
  }
  float acc[MT][N / 2], tot[MT][N / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = tot[mt][i] = 0.f;
  auto pin_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) pin(acc[mt][i]);
  };
  auto flush = [&]() {  // all products done; with kTot, into the total
    wgmma_wait<0>();
    pin_acc();
    if constexpr (kTot) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          tot[mt][i] += acc[mt][i];
          acc[mt][i] = 0.f;
        }
    }
  };
  // A through registers: KB k-steps as one group, their A tiles gathered
  // first (ptxas waits for the tensor cores before A registers are
  // rewritten, so one wait per group).  k-step k of the group reads chunks
  // c + 2k and c + 2k + 1 at pixel offset e, B at desc + k * kDesc.
  auto group = [&](auto kb, int c, int e, uint64_t desc) {
    constexpr int KB = decltype(kb)::value;
    uint32_t afr[KB][MT][kParts][4];
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < KB; ++k)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t raw[4];
        if constexpr (kSmem) {
          ldmatrix_x4(raw, smem_addr(src + (c + 2 * k + (lane >> 4)) * cs +
                                     (row[mt] + e) * kV));
        } else {
          const T* p0 = src + (int64_t)(c + 2 * k) * cs +
                        (int64_t)(row[mt] + e) * kV + (kF32 ? q : 2 * q);
          const T* p1 = src + (int64_t)(c + 2 * k) * cs +
                        (int64_t)(row8[mt] + e) * kV + (kF32 ? q : 2 * q);
          raw[0] = *reinterpret_cast<const uint32_t*>(p0);
          raw[1] = *reinterpret_cast<const uint32_t*>(p1);
          raw[2] = *reinterpret_cast<const uint32_t*>(p0 + cs);
          raw[3] = *reinterpret_cast<const uint32_t*>(p1 + cs);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kF32) {
            const float v = __uint_as_float(raw[i]);
            afr[k][mt][0][i] = tf32_rna(v);
            afr[k][mt][1][i] = tf32_rna(v - __uint_as_float(afr[k][mt][0][i]));
          } else {
            afr[k][mt][0][i] = raw[i];
          }
        }
      }
    pin_acc();
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KB; ++k)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint64_t d = desc + k * kDesc;
        if constexpr (kF32) {
          Wgmma<N>::tf32(acc[mt], afr[k][mt][0], d);
          Wgmma<N>::tf32(acc[mt], afr[k][mt][0], d + (lo_bytes >> 4));
          Wgmma<N>::tf32(acc[mt], afr[k][mt][1], d);
        } else {
          Wgmma<N>::bf16(acc[mt], afr[k][mt][0], d);
        }
      }
    wgmma_commit();
  };
  // k-steps per register group: 2 where they divide a tap's
  const int kb = cin / kK % 2 == 0 ? 2 : 1;
  __syncthreads();  // every warpgroup is done with the ring
  load_stage(ring, wc, K, N, kst, 0, kParts);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < nst)
      load_stage(ring + ((s + 1) & 1) * ring_elems, wc, K, N, kst, s + 1,
                 kParts);
    // B of k-step j at j * 2 core matrices along K
    uint64_t desc =
        desc_kmajor(smem_addr(ring + (s & 1) * ring_elems), kNB * 128, 128);
    for (int tp = 0; tp < taps; ++tp) {
      const int tap = s * taps + tp, dy = tap / KS;
      const int shift = dy * ws + tap - dy * KS;
      if constexpr (kShared) {
        pin_acc();
        wgmma_fence();
        int run = 0;
        for (int c = 0; c < cin / kV; c += 2) {
          // chunk c of the tap's pixels, in 16-byte units past a_desc
          const uint64_t e = (uint64_t)(c * (cs / kV) + shift);
          wgmma_wait<2>();  // at most three groups in flight
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            Wgmma<N>::bf16_ss(acc[mt], a_desc[mt] + e, desc);
          wgmma_commit();
          desc += kDesc;
          if (kTot && ++run == kFlush && c + 2 < cin / kV) {
            flush();
            wgmma_fence();
            run = 0;
          }
        }
      } else {
        int run = 0;
        for (int c = 0; c < cin / kV; c += 2 * kb) {
          if (kb == 2)
            group(std::integral_constant<int, 2>{}, c, shift, desc);
          else
            group(std::integral_constant<int, 1>{}, c, shift, desc);
          desc += kb * kDesc;
          run += kb;
          if (kTot && run >= kFlush && c + 2 * kb < cin / kV) {
            flush();
            run = 0;
          }
        }
      }
      if (kTot || tp + 1 == taps) flush();
    }
  }
  // the bias of this thread's columns, loaded together
  float bv[N / 4];
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    bv[2 * nb] = bias[op.boff + n0 + nb * 8 + 2 * q];
    bv[2 * nb + 1] = bias[op.boff + n0 + nb * 8 + 2 * q + 1];
  }
  const bool has_slope = op.has_slope;
  const float slope = op.slope;
  const int c_out = ch.c_out, cd = t.plane(mo) * kV;
  // dst offset of this thread's column pair nb*8 + 2q: its chunk's plane
  // and place in the chunk (n0 is a multiple of 16)
  int col[N / 8];
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
    col[nb] = (n0 / kV + nb * 8 / kV + 2 * q / kV) * cd + 2 * q % kV;
  float(&res)[MT][N / 2] = kTot ? tot : acc;
  // epilogue from the fragments: + bias, leaky ReLU, zero outside the
  // image, one rounding, into the next slot (or the tile's own pixels into
  // `out`).  res[mt][i] is row 16*warp + g + 8*((i>>1)&1), column
  // (i>>2)*8 + 2q + (i&1) of the M tile.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int tm = m0 + mt * kGroups + grp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = tm * 64 + 16 * warp + g + 8 * h;
      const int py = v / pitch, px = v - py * pitch;
      if (py >= ho || px >= wo) continue;
      const int p = py * wo + px;
      const bool in = t.inside(mo, py, px);
      const int64_t o = dst ? -1 : t.own(mo, py, px);
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb) {
        const int c = n0 + nb * 8 + 2 * q;
        float v0 = res[mt][nb * 4 + 2 * h] + bv[2 * nb];
        float v1 = res[mt][nb * 4 + 2 * h + 1] + bv[2 * nb + 1];
        if (has_slope) {
          v0 = v0 >= 0.f ? v0 : v0 * slope;
          v1 = v1 >= 0.f ? v1 : v1 * slope;
        }
        if (dst) {
          Vec<T>::put2(dst + p * kV + col[nb], in ? v0 : 0.f, in ? v1 : 0.f);
        } else if (o >= 0) {
          if (c < c_out) out[o * c_out + c] = from_f32<T>(v0);
          if (c + 1 < c_out) out[o * c_out + c + 1] = from_f32<T>(v1);
        }
      }
    }
  }
}

// The most M tiles a warpgroup takes per pass: its accumulators (and
// totals) must leave registers for the rest.
template <int N, bool kTot>
constexpr int kMaxTiles = N == 64 ? (kTot ? 1 : 2) : (kTot ? 2 : 4);

template <typename T, bool kSmem, int N, bool kTot>
__device__ void conv_passes(const Chain& ch, const Op& op, const Tile& t,
                            const T* src, T* dst, T* out, const T* w,
                            const float* bias, T* ring, int n0) {
  constexpr int kMax = kMaxTiles<N, kTot>;
  // M tiles of the region: its rows at the source region's pitch where A
  // comes by descriptor (bf16 in shared memory), else at its own
  const int pitch =
      t.cols(kSmem && sizeof(T) == 2 ? op.m_src : op.m_dst);
  const int nmt = (t.rows(op.m_dst) * pitch + 63) / 64;
  for (int m0 = 0; m0 < nmt;) {
    const int mt = min(kMax, (nmt - m0 + kGroups - 1) / kGroups);
#define CC_PASS(M)                                                         \
  if constexpr (kMax >= M)                                                 \
    if (mt == M)                                                           \
      conv_pass<T, kSmem, N, M, kTot>(ch, op, t, src, dst, out, w, bias,   \
                                      ring, n0, m0, nmt);
    CC_PASS(1)
    CC_PASS(2)
    CC_PASS(3)
    CC_PASS(4)
#undef CC_PASS
    m0 += kGroups * mt;
  }
}

// f32 layers, and bf16 layers of 64 input channels or more, accumulate in
// runs into an f32 total
template <typename T, bool kSmem, int N>
__device__ void conv_chunk(const Chain& ch, const Op& op, const Tile& t,
                           const T* src, T* dst, T* out, const T* w,
                           const float* bias, T* ring, int n0) {
  if (sizeof(T) == 4 || op.cin >= 64)
    conv_passes<T, kSmem, N, true>(ch, op, t, src, dst, out, w, bias, ring,
                                   n0);
  else
    conv_passes<T, kSmem, N, false>(ch, op, t, src, dst, out, w, bias, ring,
                                    n0);
}

template <typename T, bool kSmem>
__device__ void conv_layer(const Chain& ch, const Op& op, const Tile& t,
                           const T* src, T* dst, T* out, const T* w,
                           const float* bias, T* ring) {
  for (int n0 = 0; n0 < op.cout_p; n0 += kChunk) {
    switch (min(kChunk, op.cout_p - n0)) {
      case 16:
        conv_chunk<T, kSmem, 16>(ch, op, t, src, dst, out, w, bias, ring, n0);
        break;
      case 32:
        conv_chunk<T, kSmem, 32>(ch, op, t, src, dst, out, w, bias, ring, n0);
        break;
      case 48:
        conv_chunk<T, kSmem, 48>(ch, op, t, src, dst, out, w, bias, ring, n0);
        break;
      default:
        conv_chunk<T, kSmem, 64>(ch, op, t, src, dst, out, w, bias, ring, n0);
    }
  }
}

// dw3, act and add_saved on the CUDA cores: one item per (16-byte chunk,
// pixel), pixels fastest, in f32, rounded once.
template <typename T>
__device__ void elementwise_layer(const Chain& ch, const Op& op,
                                  const Tile& t, const T* src, const T* sav,
                                  T* dst, T* __restrict__ out,
                                  const float* __restrict__ wdw,
                                  const float* __restrict__ bias) {
  constexpr int kV = Vec<T>::kN;
  const int mo = op.m_dst;
  const int ws = t.cols(op.m_src), wo = t.cols(mo), wsv = t.cols(op.m_sav);
  const int cs = t.plane(op.m_src) * kV, cv = t.plane(op.m_sav) * kV;
  const int cd = t.plane(mo) * kV;
  const int off = op.m_src - mo - (op.kind == kDw3 ? 1 : 0);
  const int so = op.m_sav - mo, npix = t.npix(mo);
  for (int e = threadIdx.x; e < npix * (op.cout_p / kV); e += blockDim.x) {
    const int k = e / npix, p = e - k * npix, c0 = k * kV;
    const int r = p / wo, c = p - r * wo;
    const T* sp = src + k * cs + ((r + off) * ws + c + off) * kV;
    float a[kV];
    uint4 raw = *reinterpret_cast<const uint4*>(sp);
    const T* v = reinterpret_cast<const T*>(&raw);
    if (op.kind == kDw3) {
      const float* W = wdw + op.woff + c0;
#pragma unroll
      for (int j = 0; j < kV; ++j) a[j] = bias[op.boff + c0 + j];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - dy * 3;
        raw = *reinterpret_cast<const uint4*>(sp + (dy * ws + dx) * kV);
#pragma unroll
        for (int j = 0; j < kV; ++j)
          a[j] = fmaf(to_f32(v[j]), __ldg(W + tap * op.cout_p + j), a[j]);
      }
      const bool in = t.inside(mo, r, c);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        if (op.has_slope) a[j] = a[j] >= 0.f ? a[j] : a[j] * op.slope;
        if (!in) a[j] = 0.f;
      }
    } else if (op.kind == kAct) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        a[j] = to_f32(v[j]);
        a[j] = a[j] >= 0.f ? a[j] : a[j] * op.slope;
      }
    } else {  // kAdd: f32 sum, rounded once
      const uint4 sraw = *reinterpret_cast<const uint4*>(
          sav + k * cv + ((r + so) * wsv + c + so) * kV);
      const T* sv = reinterpret_cast<const T*>(&sraw);
#pragma unroll
      for (int j = 0; j < kV; ++j) a[j] = to_f32(v[j]) + to_f32(sv[j]);
    }
    if (dst) {
      uint4 o;
      T* ot = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < kV; ++j) ot[j] = from_f32<T>(a[j]);
      *reinterpret_cast<uint4*>(dst + k * cd + p * kV) = o;
    } else {
      const int64_t o = t.own(mo, r, c);
      if (o >= 0)
#pragma unroll
        for (int j = 0; j < kV; ++j)
          if (c0 + j < ch.c_out) out[o * ch.c_out + c0 + j] = from_f32<T>(a[j]);
    }
  }
}

// A persistent grid: each block walks tiles blockIdx.x, + gridDim.x, ...
// and runs the whole chain on each.  Shared memory holds the weight ring,
// then the slots (when they fit).
template <typename T, bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
    conv_chain_kernel(const __grid_constant__ Chain ch,
                      const T* __restrict__ x, T* __restrict__ out,
                      const T* __restrict__ wmm, const float* __restrict__ wdw,
                      const float* __restrict__ bias, T* scratch) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* slots = kSmem ? reinterpret_cast<T*>(smem_raw + 2 * ch.ring_bytes)
                   : scratch + (int64_t)blockIdx.x * ch.n_slots * ch.slot_elems;
  T* in = slots + ch.in_slot * ch.slot_elems;
  const int tiles_x = (ch.w + ch.tw - 1) / ch.tw;
  const int tiles = tiles_x * ((ch.h + ch.th - 1) / ch.th);
  auto tile_at = [&](int i) {
    return Tile{ch.th, ch.tw, (i / tiles_x) * ch.th, (i % tiles_x) * ch.tw,
                ch.h, ch.w, sizeof(T) == 2 ? kPlanePad : 0};
  };
  bool loaded = false;  // this tile's input was prefetched
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = tile_at(tile);
    if (!loaded) load_input<T, kSmem>(ch, t, x, in);
    cp_async_wait_all();
    __syncthreads();
    loaded = false;
    for (int i = 0; i < ch.n_ops; ++i) {
      const Op& op = ch.ops[i];
      // the last op reads no slot the input lives in: load the next
      // tile's input meanwhile
      if (i == ch.n_ops - 1 && ch.prefetch && tile + gridDim.x < tiles) {
        load_input<T, kSmem>(ch, tile_at(tile + gridDim.x), x, in);
        loaded = true;
      }
      const T* src = slots + op.src * ch.slot_elems;
      T* dst = op.dst >= 0 ? slots + op.dst * ch.slot_elems : nullptr;
      if (op.kind == kConv3 || op.kind == kConv1)
        conv_layer<T, kSmem>(ch, op, t, src, dst, out, wmm, bias, ring);
      else
        elementwise_layer<T>(ch, op, t, src, slots + op.sav * ch.slot_elems,
                             dst, out, wdw, bias);
      fence_async();  // the slot is read by wgmma next
      __syncthreads();
    }
  }
}

template <typename T, bool kSmem>
int launch(const Chain& ch, const void* x, void* out, const void* wmm,
           const float* wdw, const float* bias, void* scratch, int grid,
           int smem_bytes, cudaStream_t s) {
  auto kernel = conv_chain_kernel<T, kSmem>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem_bytes, s>>>(ch, (const T*)x, (T*)out,
                                            (const T*)wmm, wdw, bias,
                                            (T*)scratch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Chain& ch, const void* x, void* out, const void* wmm,
           const float* wdw, const float* bias, void* scratch, int grid,
           int smem_bytes, cudaStream_t s) {
  return scratch == nullptr
             ? launch<T, true>(ch, x, out, wmm, wdw, bias, scratch, grid,
                               smem_bytes, s)
             : launch<T, false>(ch, x, out, wmm, wdw, bias, scratch, grid,
                                smem_bytes, s);
}

}  // namespace

// One image.  ops: n_ops records of kOpInts ints (kind, src, dst, sav, cin,
// cout_p, m_src, m_dst, m_sav, has_slope, woff, boff, taps; the last
// op's dst is -1: it writes `out`) and
// n_ops slopes, in host memory.  wmm: the conv weights packed for wgmma in
// the compute dtype; wdw: dw3 weights (f32); bias: f32, padded per layer.
// scratch: null for shared-memory slots, else grid * n_slots * slot_elems
// elements of global memory.  dtype: 0 = float32, 1 = bfloat16 (x, out,
// wmm and the slots).  Returns a CUDA error code, 0 on success.
extern "C" int lssvc_conv_chain(const void* x, void* out, const void* wmm,
                                const void* wdw, const void* bias,
                                void* scratch, const int* ops,
                                const float* slopes, int n_ops, int h, int w,
                                int c_in, int c_out, int cin_p, int L, int th,
                                int tw, int in_slot, int n_slots,
                                int ring_bytes, int prefetch,
                                int64_t slot_elems, int grid, int smem_bytes,
                                int dtype, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps) return (int)cudaErrorInvalidValue;
  Chain ch;
  for (int i = 0; i < n_ops; ++i) {
    const int* o = ops + i * kOpInts;
    ch.ops[i] = Op{o[0], o[1], o[2], o[3],  o[4],  o[5],  o[6],
                   o[7], o[8], o[9], o[10], o[11], o[12], slopes[i]};
  }
  ch.n_ops = n_ops;
  ch.h = h;
  ch.w = w;
  ch.c_in = c_in;
  ch.c_out = c_out;
  ch.cin_p = cin_p;
  ch.L = L;
  ch.th = th;
  ch.tw = tw;
  ch.in_slot = in_slot;
  ch.n_slots = n_slots;
  ch.ring_bytes = ring_bytes;
  ch.prefetch = prefetch;
  ch.slot_elems = slot_elems;
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* wd = (const float*)wdw;
  const float* b = (const float*)bias;
  if (dtype == 0)
    return launch<float>(ch, x, out, wmm, wd, b, scratch, grid, smem_bytes, s);
  return launch<__nv_bfloat16>(ch, x, out, wmm, wd, b, scratch, grid,
                               smem_bytes, s);
}

"""The rates of the reductions the backward kernels' fixed-order variants
are built from, on the GPU.

    python -m lssvc_tpu_torch.tools.atomics_bench

Each pattern adds `COUNT` values into a buffer of `COUNT` 8-byte slots (1
GiB: past L2, so every line is read and written back as in the kernels'
sums), each slot once, with CUDA events around one launch:
- `u64_contiguous`: 64-bit integer reductions, a warp's 32 lanes on 256
  contiguous bytes (the pair's flush: a pixel's channels side by side);
- `u64_group3`: 64-bit reductions, a warp's lanes over 3 of a pixel's 48
  channels at a time (the grouped warp's flush: ~11 pixels a warp, 384
  bytes apart);
- `u64_sector`: 64-bit reductions, one lane a pixel 384 bytes apart (the
  parent's grouped flush: a sector a lane);
- `u64_spread4`: 64-bit reductions, lanes 4 to a unit of 4 channels, a
  warp's k-th reduction on 8 units 32 bytes apart (the parent's pair);
- `f32v4_contiguous`: `red.global.add.v4.f32`, a warp on 512 contiguous
  bytes (the default path's pair), for scale;
- `smem_u64` and `smem_u64_pairs`: 64-bit shared-memory atomic adds (a
  block's box), each lane its own slot, or two lanes a slot (neighbouring
  pixels' taps on one source pixel);
- `smem_u32`: 32-bit shared-memory atomic adds, each lane its own slot.
One JSON line: each pattern's G values/s, then the card.  The SASS
instructions each pattern compiles to are printed to stderr
(`cuobjdump -sass`), so a shared-memory 64-bit add shows whether it is one
instruction or a compare-and-swap loop.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from .. import build
from .timing import card, require_cuda

COUNT = 1 << 27  # slots, 8 bytes each
THREADS = 256
SMEM_ROUNDS = 4096  # shared-memory adds a thread

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" __global__ void u64_contiguous(unsigned long long* p, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    atomicAdd(p + i, 1ull);
  }
}

// lanes over (pixel, channel) of 3 channels of 48-channel pixels
extern "C" __global__ void u64_group3(unsigned long long* p, int64_t n) {
  const int64_t pixels = n / 48;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < pixels * 48; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t group = i / (3 * pixels), j = i % (3 * pixels);
    atomicAdd(p + (j / 3) * 48 + group * 3 + j % 3, 1ull);
  }
}

// one lane a pixel, 48 channels (384 bytes) apart
extern "C" __global__ void u64_sector(unsigned long long* p, int64_t n) {
  const int64_t pixels = n / 48;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < pixels * 48; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t ch = i / pixels, px = i % pixels;
    atomicAdd(p + px * 48 + ch, 1ull);
  }
}

// 4 lanes a unit of 4 channels; a warp's k-th reduction on 8 units
extern "C" __global__ void u64_spread4(unsigned long long* p, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < n / 4; i += (int64_t)gridDim.x * blockDim.x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) atomicAdd(p + 4 * i + k, 1ull);
  }
}

extern "C" __global__ void f32v4_contiguous(float* p, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < n / 4; i += (int64_t)gridDim.x * blockDim.x) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %1, %1, %1};" ::"l"(
                     p + 4 * i), "f"(1.f) : "memory");
  }
}

// each lane `rounds` adds into its own slot (pairs: two lanes a slot)
template <typename T, bool PAIRS>
__device__ void smem_adds(T* out, int rounds) {
  __shared__ T box[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) box[i] = 0;
  __syncthreads();
  const int slot = PAIRS ? threadIdx.x / 2 : threadIdx.x;
  for (int r = 0; r < rounds; ++r) {
    atomicAdd(box + (slot + 17 * r) % 4096, (T)1);
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(out, box[0]);
}

extern "C" __global__ void smem_u64(unsigned long long* out, int rounds) {
  smem_adds<unsigned long long, false>(out, rounds);
}
extern "C" __global__ void smem_u64_pairs(unsigned long long* out,
                                          int rounds) {
  smem_adds<unsigned long long, true>(out, rounds);
}
extern "C" __global__ void smem_u32(unsigned* out, int rounds) {
  smem_adds<unsigned, false>(out, rounds);
}

extern "C" int launch(const char* name, void* p, int64_t n, int blocks,
                      int threads, int rounds, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const char* names[] = {"u64_contiguous", "u64_group3", "u64_sector",
                         "u64_spread4", "f32v4_contiguous", "smem_u64",
                         "smem_u64_pairs", "smem_u32"};
  int k = 0;
  while (k < 8) {
    const char* a = names[k];
    const char* b = name;
    while (*a && *a == *b) { ++a; ++b; }
    if (*a == 0 && *b == 0) break;
    ++k;
  }
  switch (k) {
    case 0: u64_contiguous<<<blocks, threads, 0, s>>>(
                (unsigned long long*)p, n); break;
    case 1: u64_group3<<<blocks, threads, 0, s>>>(
                (unsigned long long*)p, n); break;
    case 2: u64_sector<<<blocks, threads, 0, s>>>(
                (unsigned long long*)p, n); break;
    case 3: u64_spread4<<<blocks, threads, 0, s>>>(
                (unsigned long long*)p, n); break;
    case 4: f32v4_contiguous<<<blocks, threads, 0, s>>>((float*)p, n);
            break;
    case 5: smem_u64<<<blocks, threads, 0, s>>>(
                (unsigned long long*)p, rounds); break;
    case 6: smem_u64_pairs<<<blocks, threads, 0, s>>>(
                (unsigned long long*)p, rounds); break;
    case 7: smem_u32<<<blocks, threads, 0, s>>>((unsigned*)p, rounds);
            break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
"""

GLOBAL = ("u64_contiguous", "u64_group3", "u64_sector", "u64_spread4",
          "f32v4_contiguous")
SHARED = ("smem_u64", "smem_u64_pairs", "smem_u32")


def _library():
    """The patterns' library, built into the package's build directory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "atomics_bench.cu"
    src.write_text(SOURCE)
    lib = build.BUILD_DIR / "libatomics_bench.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    sass = subprocess.run(["cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    return ctypes.CDLL(str(lib)), sass


def _atomic_lines(sass):
    """{kernel: its atomic and reduction instructions} from the SASS."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name and any(op in line for op in ("ATOM", "RED", "CAS")):
            out[name].append(line.split(";")[0].split("*/")[-1].strip())
    return out


def main():
    dev = require_cuda()
    lib, sass = _library()
    lib.launch.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
    for name, ops in _atomic_lines(sass).items():
        print(f"{name}: {sorted(set(ops))}", file=sys.stderr)
    buf = torch.zeros(COUNT, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    rates = {}
    for name in GLOBAL + SHARED:
        shared = name in SHARED
        grid = blocks if shared else blocks * 4
        values = (grid * THREADS * SMEM_ROUNDS if shared
                  else COUNT * (2 if name == "f32v4_contiguous" else 1))

        def call():
            err = lib.launch(name.encode(), buf.data_ptr(),
                             COUNT * (2 if name == "f32v4_contiguous" else 1),
                             grid, THREADS, SMEM_ROUNDS, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        call()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        rates[name] = values / (start.elapsed_time(end) * 1e-3) / 1e9
    print(json.dumps({"g_values_per_s": rates, "slots": COUNT}), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Device: CUDA must be available; prints the card's name and power limit.
2. Build: compiles the kernels of lssvc_tpu_torch/csrc with nvcc (sm_90a)
   and its rANS coder with g++, one compiler per source, all at once.
   While conv_chain.cu and int8_conv.cu build (phase 2's window), the
   checks that time nothing and need only the warp kernels run: phase 18
   (a)-(c) and phase 19 (a)'s plain `--stage spynet` run in this process,
   phase 19 (a)'s torchrun run and (f)'s dry run in the background; the
   late builds and both runs are waited for before phase 3, so nothing
   runs beside a timed phase.  Then it
   counts the tensor-core instructions (HGMMA, HMMA) in conv_chain's SASS
   and the integer wgmma (IGMMA) in int8_conv's (cuobjdump), and fails
   without HGMMA or IGMMA; prints ptxas's report (registers, shared
   memory, spills) of the int8 kernels.
3. Main path: LSSVC from the port's random init, fp32 (TF32 off in the
   model's scope), offset cap
   10 px, EL 1152x1920 / BL 576x960 from a random decoded-picture buffer.
   A warm-up frame records the shape of every kernel launch (flow_warp,
   its pair entry point, grouped_warp); then a chain of K=3 frames runs
   with the launch counts set to 0 just before it, and they must read 14*K
   flow_warp (pairs included) and K grouped_warp launches after it.
   Prints s/frame, peak memory and the launch counts.
4. Kernels: each CUDA kernel bit for bit against its plain PyTorch version
   on the card, at every shape the warm-up frame launched it with (which
   must be tools/warp_bench.py's), plus edge cases (unaligned rows, batch
   2, bf16, flows and offsets far past the borders, NaN flows, a data
   pointer one element past alignment, and tensors past 2^31 elements,
   where the kernels offset in 64 bits).  Then warp_bench's times: each
   launch of a frame on its own line with its bound, their sum, the EL
   pair as one whole flow_warp_pair call, grouped_warp on smooth and on
   random flows, beside the plain versions and the one PyTorch call
   computing the same function where one exists (for the EL pair in f32
   and bf16).
5. Whole path, CPU against card: one two-layer P-frame at EL 128x128 /
   BL 64x64 from the same weights on both devices (plain warps on the CPU,
   kernels on the card); bits within 3e-3 relative, recon within 5%
   relative RMS.
6. Conv-chain path: the port's conv-chain bench (tools/convchain_bench.py)
   at its defaults, 1x1152x1920x48, 4 layers, in bf16 and in fp32, with the
   conv_chain count set to 0 just before and read just after; each call
   must launch once.  Then edge chains, each against conv_chain_plain with
   one launch per image: a mixed spec chain with biases at 1x576x960x64,
   the bench chain at 1x1150x1918 (unaligned), at 2x576x960 (batch 2, equal
   to its images one by one), and at 128 channels (its f32 slots outgrow
   shared memory), and a 3-channel head conv into a 16-channel mixed chain
   at 1x576x960 (K padded to 16).  f32: max |err| <= 1e-5 max|ref|; bf16:
   relative RMS <= 1e-3 and max |err| <= 2^-5 max|ref|.  Times the kernel,
   the plain version and the unfused cuDNN chain; prints each mode's
   executed-work factor (the kernel's tensor-core products, halo and
   padding included, over the chain's) and executed TFLOP/s.
7. Warp-tier path: the port's warp tier bench (tools/warp_tier_bench.py),
   every variant of the JAX one at its shapes, with the warp counts set to
   0 just before and read just after; each variant through flow_warp /
   grouped_warp launches its kernel once and equals the plain version
   within check_equal's tolerance; then each kernel's plain version,
   library call and bound at those shapes, and its time, bound and (for
   flow_warp, F.grid_sample) library call in bf16.
8. GOP path: the port's CLI, `lssvc_tpu_torch.test.main(argv)` called
   in-process with `--ratios x2` on its default device, codes a synthetic
   1080p sequence (1920x1080 8-bit 4:2:0, 6 frames of a smooth texture
   moving 2x4 px a frame, gop 4: I P P P I P; EL padded to 1152x1920, BL
   540x960 padded to 576x960) from `.pth` checkpoints of the port's init,
   with estimated bits.  The warp counts are set to 0 just before and
   must read 56 flow_warp and 4 grouped_warp after; the three result
   JSONs must carry the published keys, 2 I- and 4 P-frames, finite bits
   and PSNRs.  Prints device seconds per I- and P-frame (CUDA events
   around the models' calls), wall seconds per frame (run_test, host
   metrics included), the card's idle share over run_test (1 - the
   models' device spans / its wall time), the host seconds per frame of
   the metrics and of the YUV -> RGB conversion, peak memory and the
   I-frame's FLOPs counted from its conv shapes.
9. I-frame, CPU against card: one IntraSS frame at EL 128x128 / BL 64x64
   from the same weights on both devices; bits within 3e-3 relative,
   reconstructions within 5% relative RMS.
10. Stream path, on phase 8's sequence and checkpoints (cap 10 px):
   (a) the CLI in a subprocess, `python -m lssvc_tpu_torch.test ...
   --write_stream 1 --decoding_profiling 1`: a BL and an EL .bin per
   frame, each layer's bits in its JSON 8 x the sum of its files, encode
   and decode seconds > 0, both layers' decode-profiling keys the JAX
   package's stage names; (b) the same frames in this process through the
   models (`run_test`, which calls `encode_decode`), with the warp counts
   set to 0 just before and read just after (20 flow_warp and 2
   grouped_warp launches per P-frame: the encoder's and the decoder's),
   its bins byte-equal to the CLI's, its clamped DPB pictures kept as
   8-bit 4:2:0 frames (`decode.yuv_frame`); (c) `python -m
   lssvc_tpu_torch.decode` in a fresh subprocess on the CLI's bins, its EL
   and BL YUV byte-equal to (b)'s frames; (d) at 1080p, for one I-frame
   and the P-frame after it, the encoder's closed-loop DPB (`compress`)
   equal to the decoder's (`decompress`), bit for bit.  Prints encode and
   decode seconds per I- and P-frame, each split into host rANS seconds
   (the C coder's calls) and the rest (device work, its launches and the
   host copies), symbols per frame, real against phase 8's estimated bits,
   peak memory and the launches per P-frame.

11. Modes: the bench twin (`python -m lssvc_tpu_torch.bench`) at 1080p,
   K=3, in fp32, high, bf16, bf16_f32out, bf16_packed (without and with
   LSSVC_PACKED_CTX=1) and bf16_einsum, the warp counts set to 0 just
   before each run and read just after: both warps launch in every run,
   the packed pair store once a frame in the packed-ctx run and in no
   other.  Prints s/frame, peak memory, bits and launches of each.
12. Precision gates at 128x128 (the size of phases 5 and 9): bf16 and high
   P-frames and I-frames on the card against the CPU in the same
   precision with the CPU tests' tolerances, high against fp32 on the card
   (printed), fp32 at packed width 2 (with and without the packed pair
   warp) against fp32 plain within 2e-4 for all but 0.5% of elements.
13. Packed stores: the fused packed pair warp (3 + 48 channels at
   1152x1920) and grouped_warp's packed store (48 -> 96) bit for bit
   against their plain versions in f32 and bf16; the packed pair also
   with its sources one element past 16-byte alignment, into an output one
   element past it, and with a source past 2^31 elements (64-bit offsets);
   then warp_bench's `packed_run` with the counts set to 0 just before and
   read just after; times beside the byte bound, the plain versions and
   F.grid_sample, in f32 and bf16.
14. bf16 stream path: the first 3 frames (I P P) of phase 8's sequence
   through the CLI in process with `--precision bf16 --write_stream 1`;
   `python -m lssvc_tpu_torch.decode --precision bf16` in a fresh
   subprocess rebuilds the encoder's pictures byte for byte; the closed
   loop at 1080p in bf16; encode and decode seconds per I- and P-frame;
   the I-frame's 3x3 conv shapes in bf16 (tools/conv_paths.py).
15. int8: (a) `python -m lssvc_tpu_torch.tools.int8_calibrate` (in
   process) on phase 8's video checkpoint, 512x512, 3 frames; (b)
   int8_conv bit for bit against its plain version, s32 and bf16 outputs,
   at every shape a warm-up int8 frame at 1080p launched it with (one
   launch a served site call), then edge cases: Cin 102 and 32, stride 2,
   7x3 with padding (1, 0), batch 2, s8 and f32 inputs, an input and an
   output one element past 16-byte alignment, an input past 2^31
   elements, all +-127 at K = 5376; then int8_conv's time at each launch
   shape of the frame (tools/int8_bench.py's `time_launches`): ms, the
   launches a frame, the bound (bytes or operations), cuDNN's bf16 conv of
   the same packed shape, and the frame's sums of launches x ms by class
   of site; (c) the bench twin's int8_packed
   chain at 1080p, K=3, without and with LSSVC_PACKED_CTX=1, the counts
   set to 0 just before and read just after: int8_conv launches equal the
   served site calls, > 0, the warps launch 14 and 1 a frame (its own
   calibration's frames included), the packed pair store once a frame
   with the packed pair warp; s/frame, peak GiB and bits beside phase
   11's bf16_packed; the first of the two runs and one of bf16_packed
   profile a chain of 3 frames (`bench.py --profile`): device ms a frame
   and int8_conv's share; (d) the first 3 frames (I P P) of phase 8's sequence
   through the CLI, `--precision int8 --int8_calib <table>
   --write_stream 1`, decoded by `python -m lssvc_tpu_torch.decode
   --precision int8 --int8_calib <table>` in a fresh subprocess byte for
   byte, and the 1080p closed loop in int8; (e) int8_conv's times at the
   packed 3x3 96 -> 96 site and SpyNet's EL conv2 beside its bounds, its
   plain version, cuDNN's bf16 conv of the same packed shape and the
   taps-call torch._int_mm yardstick, then tools/int8_bench.py's stack.

16. Serving: (a) the streambench twin (`python -m
   lssvc_tpu_torch.tools.streambench`) at 1152x1920 / 576x960, bf16, 6
   P-frames: the pipelined encoder's bins byte-equal to the sequential
   encoder's, ms a frame of each; (b) in the same run `decode_sequence`
   (the overlapped decoder) on those bins, its final DPB bit-equal to the
   encoders' (and the sequential decoder's), ms a frame of both decoders;
   the warp counts set to 0 just before the pipelined encode and read just
   after the overlapped decode: 20 flow_warp and 2 grouped_warp a P-frame;
   (c) `harness.serving.encode_gop` in bf16 on the first 3 frames (I P P)
   of phase 8's sequence, its bins byte-equal to phase 14's CLI bins; (d)
   the bench twin `--staged` at batch 1 and `--batch 2` in bf16 (K capped
   at 2) beside phase 11's fused bf16 chain, s/frame and peak GiB, then one
   1080p bf16 frame fused, four-stage and two-stage from the same inputs:
   DPB bit-equal, bits within 1e-6 relative, the four-stage frame's warp
   launches counted; (e) the CLI on the first 3 frames of phase 8's
   sequence with two copies of its video checkpoint as two `--model_path`
   entries, at `--worker 1` and at `--worker 2` (the latter with all four
   `--save_*` flags): equal results, the wall seconds and the card's idle
   share of each (1 - the union of the models' device spans / the CLI's
   wall time), and every PNG the JAX package's layout names exists and
   parses.

17. Evaluation side (no kernel of its own): (a) latent RDO at 1080p
   through the CLI in process (`--force_intra 1 --intra_rdo
   --write_stream 1`, the first frame of phase 8's sequence, IntraSS
   with BL 192 from its checkpoint), with the iterations capped only to
   bound this run (`max_iter` set in each task's `intra_rdo_opt`): fp32 at
   one lambda, 3 iterations; bf16 at four lambdas (four rate points), 20
   iterations each; prints per run the iterations, ms per iteration (host
   clock between the iterations' loss syncs), the RD loss at the start
   and the best, and each layer's bits and PSNR; the first run of each
   precision decoded by `python -m lssvc_tpu_torch.decode` in a fresh
   subprocess, its EL and BL YUV byte-equal to the encoder's pictures;
   (b) Cheng2020Anchor at N=192 from the port's init: the forward with
   estimated bits on the sequence's first frame (EL padded, 1152x1920) in
   fp32 and bf16 (ms, bits), then `compress` / `decompress` (host
   per-pixel loops) on its 256x256 corner: seconds of each, the decoder's
   y_hat bit-equal to the encoder's, stream bits within the CPU test's
   margin of the estimate; (c) `python -m lssvc_tpu_torch.compare_rd` (in
   process) on (a)'s bf16 result JSON against itself: the BD-rate is 0.

18. Training: (a) both backward kernels (`flow_warp_backward`, its pair
   form, and `grouped_warp_backward`, lssvc_tpu_torch/csrc/warp_grad.cu)
   against autograd through the plain warps on the card, f32 and bf16, at
   every backward launch shape of a `pair` train step at crop 256, at the
   1080p P-frame's warp shapes (tools/warp_bench.py's, which phase 4
   holds phase 3's launches to) and at edge cases:
   zero flows and integer flows on the borders (the clip's ties), flows
   far past the borders, NaN flows, batch 2, unaligned widths; then the
   kernels' two scatter paths: tiles cut unevenly (2x19x37, 1x33x65) and
   whole (1x64x64), smooth flows whose boxes fit (2 and 12 px), one launch
   with smooth tiles beside tiles of random flows past the borders (direct
   scatter), 40 px smooth per-unit offsets for the grouped warp (the
   trainer's uncapped range), a generic grouped shape, and the 1080p EL
   pair and grouped warp on smooth flows; f32 max |err| <= 1e-5 max|ref|,
   bf16 relative RMS <= 1e-2 and the bf16 source gradient within half a
   bf16 ulp (+1e-5 max|ref|) of the f32 kernel's on the same values
   (summed in f32, rounded once), the flow and mask gradients bit-equal
   across two launches; then the train step's, the 1080p frame's and the
   edge cases and the scatter paths again through the kernels'
   fixed-order variant (what `torch.use_deterministic_algorithms(True)`
   selects: each tap's value converted to a 64-bit integer on its own and
   summed exactly), its source gradients bit-equal to the plain version
   (`flow_warp_backward_fixed_plain`, `grouped_warp_backward_fixed_plain`:
   the same integers summed by an int64 index_add_, rounded once), every
   gradient within the same bounds of plain autograd and bit-equal across
   two launches; (b) one fp32 `pair` step and
   one `cascade` chain of T=3 with no warm step at crop 256, the counts
   set to 0 just before and read just after: a backward launch for each
   forward warp whose inputs take a gradient (12 of 14 flow_warp and 1
   grouped_warp; the chain 26 of 28 and 2); (c) one fp32 `pair` loss and
   gradient at 128x128 on the CPU, on the CPU in float64 and on the card:
   the loss within 1e-4 relative, the whole gradient within 1e-2 relative
   L2 and each key within 5e-2 (random init's cancelling sums; the CPU's
   own f32-against-f64 spread is printed); (d) `python -m
   lssvc_tpu_torch.train` in process on its default device at crop 256,
   synthetic data: `--stage spynet`, `--stage mv`, `--loss pair`,
   `--stage cascade --frames 3` and `--loss intra` 4 steps each, `pair`
   at `--batch-per-device 8` 3 steps (s/step, frames/s, peak GiB), a
   crash resume that restores step 2, a fixed-batch `pair` run of 20
   steps whose loss must fall, and the trained checkpoints coding the GOP
   path's first 3 frames through the test CLI; (e) each backward
   kernel's ms at the 1080p EL pair and grouped warp and at the training
   crop's, f32 and bf16, on smooth flows (12 px; the grouped warp also a
   12 px field plus 40 px per-unit offsets) and random ones (+-6 px), a
   wrapper call and the kernel alone (its C entry point on preallocated
   buffers), beside its byte bound, the wrapper's zero-fill and rounding
   passes, the
   plain autograd's backward and, for flow_warp, F.grid_sample's backward
   (`tools/warp_bench.py --backward`), and the fixed-order variant's ms (a
   wrapper call and its C entry point) with, for the pair, F.grid_sample's
   backward under the deterministic flag (its ms, or PyTorch's refusal).

19. Parallelism (about 3 minutes; NCCL takes one card a rank, so two
   ranks share the card on gloo, whose exchanges stage CUDA tensors
   through the host): (a) `python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m lssvc_tpu_torch.train --stage spynet` at crop
   256, 3 steps, a world of 1 on NCCL: its checkpoint bit-equal to the
   plain CLI's (spynet's gradients reach the warps only through the
   flows), then, in this process under
   `torch.use_deterministic_algorithms(True)` (set for the block and
   restored after), one data-parallel `pair` step, a world of 1 on NCCL,
   the backward launches counted (12 flow_warp_backward, 1
   grouped_warp_backward; the 6 and 1 that take a source gradient through
   the fixed-order variant), its parameters bit-equal to the plain step's
   and two plain steps bit-equal (a plain step with the flag off, whose
   atomic source sums differ in the last bits, printed beside); (b)-(e) two
   gloo ranks on cuda:0: which gloo collectives take CUDA tensors (a
   probe); the 1080p EL pair and the
   grouped warp (576 rows a rank; smooth 12 px flows, 12 + 40 px
   offsets) on strips at a halo above and below the flows' reach, within
   1e-4 of the whole-frame kernel, the values that differ at all
   counted (none: a strip samples the frame's own f32 positions), one
   launch a call on either branch, and rank 0's strip and whole-frame
   launch times; the spatial P-frame (LSSVC, fp32, cap 10 px, EL
   1152x1920 / BL 576x960, K=2 chained from a random DPB, the pictures
   fed back clamped as the GOP loop does) against rank 0's unsharded card
   forward: bits within 1e-3 and, on both frames, each DPB entry within
   the elementwise bound of `tests/test_spatial.py`, rtol = atol = 1e-3
   (the values past it and the spread a 1e-6 move of the frame makes are
   printed), and no op of frame 1 whose output the strips change
   (`tools/op_digests.py`'s per-row digests: each conv shape takes the
   cheapest route whose rows a probe found to be the frame's bits,
   `ops/strips.py` `conv2d`; the routes' counts and the warm-up frame's
   time, probes included, are printed), 14 flow_warp and 1
   grouped_warp launches a frame a rank, s/frame, peak GiB and the warps'
   branches a rank; the IntraSS I-frame at 1080p, twice (the first call
   probes), its picture bit-equal to the unsharded one's; `serve_streams`, two bf16 streams of 3 P-frames, each bit-equal
   to its stream run alone; (f) `python -m lssvc_tpu_torch.dryrun --n 2
   --backend gloo` (its x1.5 frame and reference both in fp32, every DPB
   value within 1e-3, rtol and atol).  Every spatial forward runs inside
   `precision_scope(Mode("fp32"))`, as its unsharded reference does.

20. The root tools' twins, each `python -m lssvc_tpu_torch.tools.<name>`
   in a subprocess on its default device: (a) `rd_experiment` trains
   IntraSS (BL 192) and LSSVC at full width for 2 lambdas (`--stages
   full`, 2 steps a stage, crop 128), then evaluates them with real
   bitstreams at 128x128, 4 frames at gop 2, in fp32, bf16 and int8 (one
   calibration a checkpoint): its point lines equal its report's
   numbers, each mode's JSONs exist; the launches of its evaluation
   process (`flow_warp`, `grouped_warp`, `int8_conv`) and of its training
   processes (the backward kernels), dumped by each process at exit
   (`utils/launch_counts.py`, LSSVC_LAUNCH_COUNTS), must all be > 0; (b)
   `rd_reconstruct` on its log rebuilds the report's points as printed;
   (c) `chain_probe --precision bf16` on the first rate point's pair:
   4 finite PSNRs, its exit code the cliff rule's; (d) `ref_scale_eval
   --frames 3`: the 1080p YUV's size, its config and the CLI's command.
   Prints each mode's bpp and PSNR and the phase's seconds.

Then one JSON line {"kernels": [...]}: each kernel's launches counted on its
path (the warps on the P-frame chain of phase 3, with their GOP path,
stream path, warp-tier path, bf16 chain and bf16 stream counts beside
them; the pair's packed store on the bf16_packed chain with
LSSVC_PACKED_CTX=1; the grouped packed store on warp_bench's packed_run;
conv_chain on the conv-chain path of phase 6; int8_conv on the
int8_packed chain of phase 15; the backward kernels on phase 18's `pair`
train step (with the cascade chain's beside them, and a data-parallel
step's); the warps also with their launches a frame a rank on phase 19's
spatial P-frame, its branches and the halo warps' errors, and with their
launches a
P-frame on phase 16's pipelined encode and overlapped decode and a frame
on its four-stage frame; every kernel with the launches of phase 20's
evaluation process and training processes), its times, bound and errors,
after a line with the script's total seconds.  The last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from lssvc_tpu_torch import bench, build, compare_rd
from lssvc_tpu_torch import test as cli
from lssvc_tpu_torch import train as trainer
from lssvc_tpu_torch.decode import yuv_frame
from lssvc_tpu_torch.harness import runner, serving
from lssvc_tpu_torch.harness.results import RESULT_KEYS
from lssvc_tpu_torch.models import LSSVC, Cheng2020Anchor, IntraSS, \
    intra_ss_stream, lssvc_stream
from lssvc_tpu_torch.models.dmc_stream import DMCExtend
from lssvc_tpu_torch.models.init import init_cheng2020, init_intra_ss, \
    init_lssvc
from lssvc_tpu_torch.models.lssvc_stream import LSSVCExtend
from lssvc_tpu_torch.native import rans
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.ops import conv_chain as cc
from lssvc_tpu_torch.ops import int8 as q8
from lssvc_tpu_torch.ops import strips
from lssvc_tpu_torch.ops import warp as plain
from lssvc_tpu_torch.ops import warp_kernels as wk
from lssvc_tpu_torch.ops.nn import Mode, precision_scope
from lssvc_tpu_torch.parallel import scheduler
from lssvc_tpu_torch.parallel import train as ptrain
from lssvc_tpu_torch.tools import (conv_paths, convchain_bench,
                                   int8_bench, int8_calibrate, streambench,
                                   synthetic, warp_bench, warp_tier_bench)
from lssvc_tpu_torch.utils import launch_counts
from lssvc_tpu_torch.utils.io import YUVReader
from lssvc_tpu_torch.utils.padding import get_interlayer_padding
from lssvc_tpu_torch.utils.png import read_png
from lssvc_tpu_torch.tools.op_digests import OpDigests, first_differences
from lssvc_tpu_torch.tools.profile_frame import iframe_flops
from lssvc_tpu_torch.tools.timing import card, time_ms
from lssvc_tpu_torch.tools.warp_bench import (bound_ms, deterministic,
                                              flow_warp_cost, grouped_cost,
                                              smooth_field, uniform)

EL_HW, BL_HW, K = (1152, 1920), (576, 960), 3
# the GOP path: a 1080p source (h, w) coded at x2, EL padded to 1152x1920,
# BL 540x960 padded to 576x960; 6 frames at gop 4 are I P P P I P
GOP_HW, GOP_EL_HW, GOP_BL_HW, GOP_FRAMES, GOP = (
    (1080, 1920), (1152, 1920), (576, 960), 6, 4)
# the decode-profiling stages the JAX package names
# (lssvc_tpu/models/dmc.py:262-265, lssvc_tpu/models/lssvc.py:518-521)
JAX_STAGES = {
    "BL": ("entropy_dec_mv_z", "mv_y_prior_dec", "entropy_dec_mv_y",
           "mv_dec", "motion_compensation_ctx_refine", "entropy_dec_z",
           "y_prior", "entropy_dec_y", "res_dec"),
    "EL": ("mv_setup", "entropy_dec_mv_z", "mv_prior_dec", "entropy_dec_mv_y",
           "mv_dec_ctx", "entropy_dec_z", "y_prior", "entropy_dec_y",
           "spatial_prior_update", "res_dec")}
# the FL result carries no per-plane PSNR lists
YUV_KEYS = {"ave_i_frame_YUV_psnr", "ave_p_frame_YUV_psnr",
            "ave_all_frame_YUV_psnr"}
# H100 SXM tensor-core peaks from NVIDIA's data sheet (the memory and f32
# rates are tools/warp_bench.py's)
BF16_TENSOR_FLOP_PER_S = 989e12  # dense, tensor cores
TF32_TENSOR_FLOP_PER_S = 495e12  # dense, tensor cores
DTYPES = {0: torch.float32, 1: torch.bfloat16}  # the kernels' dtype codes
FLOW_WARP_REPLACES = (
    "lssvc_tpu/ops/warp_pallas.py:305 (_warp_kernel_cblock), "
    "lssvc_tpu/ops/warp_pallas.py:151 (_warp_kernel), "
    "lssvc_tpu/ops/warp_pallas.py:477 (_warp_kernel_cblock_roll), "
    "lssvc_tpu/ops/warp_pallas.py:407 (_warp_kernel_cblock_wide), "
    "lssvc_tpu/ops/warp_pallas.py:232 (_warp_kernel_smallflow)")
GROUPED_REPLACES = (
    "lssvc_tpu/ops/warp_pallas.py:647 (_grouped_warp_kernel_cblock), "
    "lssvc_tpu/ops/warp_pallas.py:892 (_grouped_warp_kernel), "
    "lssvc_tpu/ops/warp_pallas.py:859 (_grouped_warp_kernel_smallflow)")
SOURCE = "lssvc_tpu_torch/csrc/warp.cu"
CHAIN_SOURCE = "lssvc_tpu_torch/csrc/conv_chain.cu"
CHAIN_REPLACES = "lssvc_tpu/ops/conv_chain.py:64 (_chain_kernel)"
# conv_chain edge cases: the mixed chain, then the bench chain unaligned,
# in a batch of 2, and at 128 channels, then a 3-channel head
CHAIN_EDGES = [(1, 576, 960, 64), (1, 1150, 1918, 48), (2, 576, 960, 48),
               (1, 576, 960, 128), (1, 576, 960, 3)]


def log(msg):
    print(msg, flush=True)


class LaunchRecorder:
    """Stands in for the kernel library and records every launch's shape
    and dtype code: flow_warp (n, h, w, c); flow_warp_pair (n, h, w, ca,
    cb); grouped_warp (n, h, w, c_src, go, group_num)."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def lssvc_flow_warp(self, *args):
        self.calls.append(("flow_warp", tuple(args[3:7]), args[7]))
        return self.lib.lssvc_flow_warp(*args)

    def lssvc_flow_warp_pair(self, *args):
        self.calls.append(("flow_warp_pair", tuple(args[5:10]), args[10]))
        return self.lib.lssvc_flow_warp_pair(*args)

    def lssvc_grouped_warp(self, *args):
        self.calls.append(("grouped_warp", tuple(args[5:11]), args[11]))
        return self.lib.lssvc_grouped_warp(*args)


def grid_sample_ms(x, flow):
    """Time of the one PyTorch call that computes flow_warp:
    F.grid_sample(bilinear, border, align_corners=True) on x's NCHW view."""
    _, h, w, _ = x.shape
    iy = torch.arange(h, device=x.device, dtype=torch.float32)[None, :, None]
    ix = torch.arange(w, device=x.device, dtype=torch.float32)[None, None, :]
    grid = torch.stack([(ix + flow[..., 0]) / ((w - 1) / 2) - 1,
                        (iy + flow[..., 1]) / ((h - 1) / 2) - 1], -1) \
        .to(x.dtype)
    x_nchw = x.permute(0, 3, 1, 2)
    return time_ms(lambda: F.grid_sample(
        x_nchw, grid, mode="bilinear", padding_mode="border",
        align_corners=True))


def chain_cost(specs, n, h, w, c_in, elt):
    """Bytes: the input read once, the output written once, the f32 weights
    and biases read once.  Operations per pixel: 2*9*ci*co for a conv3,
    2*ci*co for a conv1, 2*9*c for a dw3, one per output channel for a bias,
    a leaky ReLU, an act or an add."""
    cur, flops, params = c_in, 0, 0
    for s in specs:
        kind = s["kind"]
        if kind == "save":
            continue
        if kind in ("act", "add_saved"):
            flops += cur
            continue
        co = s["w"].shape[0]
        taps = 1 if kind == "conv1" else 9
        macs = taps * co if kind == "dw3" else taps * cur * co
        flops += 2 * macs + co * ((s.get("b") is not None)
                                  + (s.get("slope") is not None))
        params += macs + co
        if not s.get("branch"):
            cur = co
    return n * h * w * (c_in + cur) * elt + 4 * params, n * h * w * flops


def chain_peak(dtype):
    """The rate of the unit the kernel uses: bf16 tensor cores, or for f32
    the TF32 tensor cores at three TF32 products per f32 product."""
    return BF16_TENSOR_FLOP_PER_S if dtype == torch.bfloat16 \
        else TF32_TENSOR_FLOP_PER_S / 3


def check_chain(name, errs, dtype):
    """f32: max |err| <= 1e-5 max|ref|; bf16: relative RMS <= 1e-3 and max
    |err| <= 2^-5 max|ref|."""
    err, top, rms = errs["max_abs_err"], errs["max_abs_ref"], errs["rel_rms"]
    ok = (err <= 1e-5 * top if dtype == torch.float32
          else rms <= 1e-3 and err <= 2.0 ** -5 * top)
    log(f"  {name}: max |err| {err:.3g} at max |ref| {top:.3g}, "
        f"relative RMS {rms:.3g}")
    if not ok:
        raise AssertionError(f"{name}: beyond tolerance")
    return err


def check_equal(name, out, ref, x):
    """fp32: max |err| <= 1e-5 * max|x|; bf16: within one bf16 ulp of the
    plain version (computed in f32, rounded once).  NaN must meet NaN."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape} {out.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    o, r = out.float(), ref.float()
    nan_o, nan_r = torch.isnan(o), torch.isnan(r)
    if not torch.equal(nan_o, nan_r):
        raise AssertionError(f"{name}: NaN positions differ")
    o, r = o.masked_fill(nan_o, 0), r.masked_fill(nan_r, 0)
    err = (o - r).abs()
    if out.dtype == torch.float32:
        tol = 1e-5 * float(x.float().abs().max())
        ok = float(err.max()) <= tol
    else:
        ok = bool((err <= r.abs() * 2.0 ** -7 + 1e-30).all())
    if not ok:
        raise AssertionError(f"{name}: max |err| {float(err.max())} beyond "
                             "tolerance")
    log(f"  {name}: max |err| {float(err.max()):.3g}")
    return float(err.max())


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    smi = card()
    log(smi)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    return smi


# the sources every phase runs, and the two that build on while the
# untimed checks run (phase 2's window: about 70-100 s of nvcc for
# conv_chain.cu's wgmma instantiations, 25-50 s for int8_conv.cu's)
EARLY_SOURCES = ("warp", "warp_grad", "lssvc_rans")
LATE_SOURCES = ("conv_chain", "int8_conv")


def phase_build():
    """Phase 2, started: every source compiled at once, one compiler each;
    returns when the early ones are loaded, with the late ones' builds
    (futures) running on."""
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=len(LATE_SOURCES))
    late = [pool.submit(build.build, name) for name in LATE_SOURCES]
    pool.shutdown(wait=False)
    build.build_all(EARLY_SOURCES)
    for name in EARLY_SOURCES:
        build.load(name)
    log(f"# build: " + ", ".join(
        f"{build.library_path(n).name} {build.BUILD_SECONDS[n]:.2f} s"
        for n in EARLY_SOURCES)
        + f"; {time.perf_counter() - t0:.2f} s to build and load; "
        f"{', '.join(LATE_SOURCES)} build on while the untimed checks run")
    return late


def phase_build_late(late):
    """Phase 2, finished: the late sources built and loaded; the tensor-core
    instructions in their SASS and ptxas's report of the int8 kernels."""
    t0 = time.perf_counter()
    for future in late:
        future.result()
    for name in LATE_SOURCES:
        build.load(name)
    log(f"# build: " + ", ".join(
        f"{build.library_path(n).name} {build.BUILD_SECONDS[n]:.2f} s"
        for n in LATE_SOURCES)
        + f"; waited {time.perf_counter() - t0:.2f} s for them after the "
        "untimed checks")
    # the conv chain's products: tensor-core instructions in its SASS
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(build.library_path("conv_chain"))],
        capture_output=True, text=True, check=True).stdout
    hgmma = sass.count("HGMMA")
    log(f"# conv_chain.cu SASS: {hgmma} HGMMA, {sass.count('HMMA')} HMMA")
    if hgmma == 0:
        raise AssertionError("conv_chain.cu has no HGMMA instruction")
    # the int8 conv's products: integer wgmma (IGMMA) in its SASS
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(build.library_path("int8_conv"))],
        capture_output=True, text=True, check=True).stdout
    igmma = sorted(set(re.findall(r"IGMMA[.\w]*", sass)))
    log(f"# int8_conv.cu SASS: {sass.count('IGMMA')} IGMMA "
        f"({', '.join(igmma)}), {sass.count('IMMA')} IMMA")
    if not igmma:
        raise AssertionError("int8_conv.cu has no IGMMA instruction")
    # ptxas's report of the int8 kernels: registers, shared memory, spills
    report = build.BUILD_LOG.get("int8_conv", "")
    for line in report.splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            log("#   " + re.sub(r"_ZN\w*int8_conv_kernel", "int8_conv_kernel",
                               line.strip())[:160])


def check_bits(name, out, ref):
    """Bit for bit against the plain version, NaN meeting NaN."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape} {out.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    nan_o, nan_r = torch.isnan(out), torch.isnan(ref)
    o, r = out.masked_fill(nan_o, 0), ref.masked_fill(nan_r, 0)
    if not (torch.equal(nan_o, nan_r) and torch.equal(o, r)):
        raise AssertionError(f"{name}: not bit-equal, max |err| "
                             f"{float((o.float() - r.float()).abs().max())}")
    log(f"  {name}: bit-equal")
    return 0.0


def misaligned(t):
    """A copy of t at storage offset 1: its data starts one element past
    an aligned address, as a view into a larger tensor may."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return view.view(t.shape).copy_(t)


def check_flow(name, xs, flow):
    """flow_warp of xs[0], or flow_warp_pair of xs[0] and xs[1], in one
    launch, against the plain warp of each tensor."""
    n0 = wk.flow_warp.launches
    outs = ([wk.flow_warp(xs[0], flow)] if len(xs) == 1
            else wk.flow_warp_pair(*xs, flow))
    if wk.flow_warp.launches != n0 + 1:
        raise AssertionError(f"{name}: {wk.flow_warp.launches - n0} launches")
    return max(check_bits(f"{name} [{i}]", out, plain.flow_warp(x, flow))
               for i, (out, x) in enumerate(zip(outs, xs)))


def check_grouped(name, x, fx, fy, m, gn):
    n0 = wk.grouped_warp.launches
    out = wk.grouped_warp(x, fx, fy, m, gn)
    if wk.grouped_warp.launches != n0 + 1:
        raise AssertionError(f"{name}: {wk.grouped_warp.launches - n0} "
                             "launches")
    return check_bits(name, out, plain.grouped_warp_plain(x, fx, fy, m, gn))


def phase_kernels(dev, calls):
    """Each CUDA kernel bit for bit against its plain version at every
    shape the warm-up frame launched it with (`calls`, from LaunchRecorder,
    which must be tools/warp_bench.py's FRAME and GROUPED) and at edge
    cases; then warp_bench's times at those shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def uni(shape, lo, hi):
        return uniform(gen, shape, lo, hi)

    flow_calls = [(name, shape) for name, shape, _ in calls
                  if name != "grouped_warp"]
    grouped_calls = [shape for name, shape, _ in calls
                     if name == "grouped_warp"]
    if (flow_calls != warp_bench.FRAME
            or grouped_calls != [warp_bench.GROUPED]
            or {DTYPES[dt] for _, _, dt in calls} != {torch.float32}):
        raise AssertionError(f"main path launched {calls}; warp_bench times "
                             f"{warp_bench.FRAME} and {warp_bench.GROUPED}")
    f32, bf16 = torch.float32, torch.bfloat16

    log("# flow_warp and flow_warp_pair against the plain version")
    errs = []
    for name, shape in warp_bench.FRAME:
        xs, flow = warp_bench.flow_inputs(gen, shape)
        errs.append(check_flow(f"{name} {shape} frame launch", xs, flow))
    n, h, w, ca, cb = warp_bench.EL_PAIR
    a, b = uni((n, h, w, ca), -1, 1), uni((n, h, w, cb), -1, 1)
    for label, lo in (("|f|<=2", 2.0), ("|f|<=25", 25.0),
                      ("|f|<=300 past borders", 300.0)):
        errs.append(check_flow(f"pair {warp_bench.EL_PAIR} {label}", [a, b],
                               uni((n, h, w, 2), -lo, lo)))
    flow_small = uni((n, h, w, 2), -2, 2)
    errs.append(check_flow("bf16 pair |f|<=2", [a.to(bf16), b.to(bf16)],
                           flow_small))
    flow_nan = flow_small.clone()
    flow_nan[0, 100:110, 200:260, 0] = float("nan")
    errs.append(check_flow("pair NaN flows", [a, b], flow_nan))
    # unaligned rows, batch 2, both dtypes: scalar (3) and vector paths
    for shape in ((1, 1150, 1918, 3), (1, 1150, 1918, 48), (2, 576, 960, 64)):
        flow = uni(shape[:3] + (2,), -25, 25)
        for dtype in (f32, bf16):
            errs.append(check_flow(f"{str(dtype)[6:]} {shape} |f|<=25",
                                   [uni(shape, -1, 1).to(dtype)], flow))
    errs.append(check_flow("pair (2, 575, 957, 3 + 64) |f|<=25",
                           [uni((2, 575, 957, 3), -1, 1),
                            uni((2, 575, 957, 64), -1, 1)],
                           uni((2, 575, 957, 2), -25, 25)))
    # a data_ptr one element past 16-byte alignment takes the scalar path
    x = uni((1, 576, 960, 48), -1, 1)
    flow = uni((1, 576, 960, 2), -25, 25)
    errs.append(check_flow("(1, 576, 960, 48) at storage offset 1",
                           [misaligned(x)], flow))
    errs.append(check_flow("pair 3 + 48, b at storage offset 1",
                           [x[..., :3].contiguous(), misaligned(x)], flow))
    # past 2^31 elements the kernel offsets in 64 bits: a pair of a
    # scalar-path tensor past 2^31 elements and a vector-path one.  The warp
    # is per channel, so a is held against its first and last channels,
    # which hold the smallest and the largest offsets
    big = (1, h, w, 2 ** 31 // (h * w) + 1)
    a_big = torch.empty(big, dtype=bf16, device=dev).uniform_(
        -1, 1, generator=gen)
    b16 = uni((1, h, w, 16), -1, 1).to(bf16)
    flow = uni((1, h, w, 2), -25, 25)
    out_a, out_b = wk.flow_warp_pair(a_big, b16, flow)
    errs.append(check_bits(f"bf16 pair with a {big}: b {tuple(b16.shape)}",
                           out_b, plain.flow_warp(b16, flow)))
    for chans in (slice(0, 4), slice(-4, None)):
        xs = a_big[..., chans].contiguous()
        errs.append(check_bits(
            f"bf16 pair a {big} ({math.prod(big)} elements) channels "
            f"{chans.start}:{chans.stop or ''}", out_a[..., chans],
            plain.flow_warp(xs, flow)))
    del a_big, out_a, out_b, xs

    log("# grouped_warp against the plain version")
    g_errs = []
    n, h, w, c_src, go, gn = warp_bench.GROUPED
    g_errs.append(check_grouped(f"{warp_bench.GROUPED} frame launch",
                                *warp_bench.grouped_inputs(gen), gn))
    # batch 2, unaligned rows, both dtypes, offsets to 300 px past the
    # borders, NaN offsets, and x at storage offset 1 (one load a channel)
    shape, units = (2, 290, 478, c_src), (2, 290, 478, go)
    m = uni(units, 0, 1)
    for dtype in (f32, bf16):
        x = uni(shape, -1, 1).to(dtype)
        for off in (0.4, 12.0, 50.0, 300.0):
            fx, fy = uni(units, -off, off), uni(units, -off, off)
            g_errs.append(check_grouped(
                f"{str(dtype)[6:]} {shape} |off|<={off:g}", x, fx, fy, m, gn))
        fx[0, 10:20, 30:90, 5] = float("nan")
        fy[1, 200:210, 0:40, 20] = float("nan")
        g_errs.append(check_grouped(f"{str(dtype)[6:]} {shape} NaN offsets",
                                    x, fx, fy, m, gn))
        g_errs.append(check_grouped(
            f"{str(dtype)[6:]} {shape} at storage offset 1", misaligned(x),
            fx, fy, m, gn))
    # another shape takes the kernel's runtime constants: 8 units, 4 groups
    u8 = (2, 290, 478, 8)
    g_errs.append(check_grouped(
        f"{u8} x 8 units, 4 groups |off|<=12", uni(u8, -1, 1),
        uni(u8, -12, 12), uni(u8, -12, 12), uni(u8, 0, 1), 4))
    # past 2^31 output elements (64-bit offsets): images are independent,
    # so the first and the last are held against the plain version
    nb = 11
    xb = uni((nb, h, w, c_src), -1, 1).to(bf16)
    fxb, fyb = uni((nb, h, w, go), -12, 12), uni((nb, h, w, go), -12, 12)
    mb = uni((nb, h, w, go), 0, 1)
    out = wk.grouped_warp(xb, fxb, fyb, mb, gn)
    for i in (0, nb - 1):
        im = slice(i, i + 1)
        g_errs.append(check_bits(
            f"bf16 {tuple(xb.shape)} x {go} units ({out.numel()} output "
            f"elements) image {i}", out[im],
            plain.grouped_warp_plain(xb[im], fxb[im], fyb[im], mb[im], gn)))
    del xb, fxb, fyb, mb, out

    log("# warp times at the frame's shapes (tools/warp_bench.py)")
    bench = warp_bench.run(dev)
    for f in bench["frame"]:
        log(f"  {f['call']} {tuple(f['shape'])}: {f['ms']:.4f} ms, bound "
            f"{f['bound_ms']:.4f} ms")
    n, h, w, ca, cb = warp_bench.EL_PAIR
    xs, flow = warp_bench.flow_inputs(gen, warp_bench.EL_PAIR)
    plain_ms = time_ms(lambda: plain.flow_warp(torch.cat(xs, -1), flow), 5, 1)
    library_ms = grid_sample_ms(torch.cat(xs, -1), flow)
    library_ms_bf16 = grid_sample_ms(torch.cat(xs, -1).to(bf16), flow)
    b_ms, b_by = bound_ms(*flow_warp_cost(n, h, w, ca + cb, 4))
    fw_entry = {
        "name": "flow_warp", "route": "cuda", "source": SOURCE,
        "replaces": FLOW_WARP_REPLACES, "call": "flow_warp_pair",
        "shape": list(warp_bench.EL_PAIR), "dtype": "float32",
        "max_abs_err": max(errs), "ms": bench["pair_ms"],
        "pair_ms": bench["pair_ms"], "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library_call": "F.grid_sample(bilinear, border, align_corners=True)"
                        " on the two tensors' concat",
        "library_ms_bfloat16": library_ms_bf16,
        "ms_random_flows": bench["pair_ms_random_flows"],
        "frame_ms": bench["frame_ms"],
        "frame_bound_ms": bench["frame_bound_ms"],
    }
    log(f"# flow_warp_pair at the EL pair {bench['pair_ms']:.4f} ms, "
        f"{bench['pair_ms_random_flows']:.4f} ms on random flows (bound "
        f"{b_ms:.4f}, plain {plain_ms:.4f}, grid_sample {library_ms:.4f}, "
        f"in bf16 {library_ms_bf16:.4f}); "
        f"the {len(bench['frame'])} launches of a frame "
        f"{bench['frame_ms']:.4f} ms (bound {bench['frame_bound_ms']:.4f})")
    del xs, flow

    x, fx, fy, m = warp_bench.grouped_inputs(gen)
    plain_ms = time_ms(lambda: plain.grouped_warp_plain(x, fx, fy, m, gn),
                       3, 1)
    del x, fx, fy, m
    grouped = bench["grouped"]
    b_ms, b_by = bound_ms(*grouped_cost(*warp_bench.GROUPED, 4))
    gw_entry = {
        "name": "grouped_warp", "route": "cuda", "source": SOURCE,
        "replaces": GROUPED_REPLACES, "shape": [n, h, w, c_src],
        "units": go, "dtype": "float32", "max_abs_err": max(g_errs),
        "ms": grouped["ms"], "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_random_flows": grouped["ms_random_flows"],
    }
    log(f"# grouped_warp {grouped['ms']:.4f} ms, "
        f"{grouped['ms_random_flows']:.4f} ms on random flows (bound "
        f"{b_ms:.4f}, plain {plain_ms:.4f})")
    return [fw_entry, gw_entry]


def _rel_rms(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / torch.sqrt(torch.mean(b ** 2)).clamp_min(1e-12))


def phase_cpu_vs_card(dev):
    params = init_lssvc(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    shapes = [(1, 64, 64, 3), (1, 128, 128, 3), (1, 64, 64, 3),
              (1, 128, 128, 3), (1, 64, 64, 64), (1, 128, 128, 48)]
    args = [torch.from_numpy(rng.random(s, np.float32)) for s in shapes]
    outs = []
    for device in ("cpu", dev):
        model = LSSVC(params, device=device,
                      od_offset_cap=OD_OFFSET_CAP_SERVING)
        model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
        outs.append(model.forward_one_frame(*(a.to(device) for a in args)))
    cpu, card = outs
    for k in ("bit_bl", "bit_el"):
        a, b = float(card[k]), float(cpu[k])
        if not abs(a - b) <= 3e-3 * max(abs(b), 1.0):
            raise AssertionError(f"{k}: card {a} vs cpu {b}")
    rms = {k: _rel_rms(card["dpb"][k], cpu["dpb"][k])
           for k in ("ref_frame_bl", "ref_frame_el")}
    if max(rms.values()) > 0.05:
        raise AssertionError(f"recon relative RMS {rms}")
    log(f"# cpu vs card at 128x128: bits card {float(card['bit_bl']):.3f}/"
        f"{float(card['bit_el']):.3f} cpu {float(cpu['bit_bl']):.3f}/"
        f"{float(cpu['bit_el']):.3f}, recon rel RMS {rms}")


def mixed_chain(c, seed):
    """save, conv3 (bias, slope), a conv1 branch under a tag, dw3, act,
    conv3, add_saved(tag), add_saved; a nonzero bias on every conv."""
    gen = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen) * (2.0 / (shape[1] * 9)) ** .5

    def b(c):
        return torch.randn(c, generator=gen) * 0.1

    return [{"kind": "save"},
            {"kind": "conv3", "w": w(c, c, 3, 3), "b": b(c), "slope": 0.1},
            {"kind": "conv1", "w": w(c, c, 1, 1), "b": b(c), "branch": "a"},
            {"kind": "dw3", "w": w(c, 1, 3, 3) * 3, "b": b(c), "slope": 0.01},
            {"kind": "act", "slope": 0.2},
            {"kind": "conv3", "w": w(c, c, 3, 3), "b": b(c)},
            {"kind": "add_saved", "tag": "a"},
            {"kind": "add_saved"}]


def head_chain(seed):
    """A 3 -> 16 channel conv3 head (bias, slope) before the mixed chain at
    16 channels."""
    gen = torch.Generator().manual_seed(seed)
    return [{"kind": "conv3", "w": torch.randn((16, 3, 3, 3), generator=gen)
             * (2.0 / 27) ** .5, "b": torch.randn(16, generator=gen) * 0.1,
             "slope": 0.1}] + mixed_chain(16, seed)


def phase_conv_chain(dev):
    """The conv-chain bench at its defaults (the path, counted), then edge
    chains against the plain version (uncounted)."""
    log("# conv-chain path: tools/convchain_bench.py at 1x1152x1920x48 x4")
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    cc.conv_chain.launches = 0
    runs = {mode: convchain_bench.run(mode) for mode in dtypes}
    launches = cc.conv_chain.launches
    for mode, run in runs.items():
        log(json.dumps(run))
        check_chain(f"bench {mode}", run["chain"], dtypes[mode])
        if run["chain"]["launches_per_call"] != 1:
            raise AssertionError(f"bench {mode}: {run['chain']} launches")
    if launches == 0:
        raise AssertionError("the conv-chain path launched no kernel")

    log("# conv_chain edge chains against the plain version")
    errs = []
    edges = [(f"mixed {CHAIN_EDGES[0]}", mixed_chain(CHAIN_EDGES[0][-1], 1),
              CHAIN_EDGES[0])]
    for shape in CHAIN_EDGES[1:-1]:
        specs = convchain_bench.make_chain(shape[-1], 4, 8, 8,
                                           device="cpu")[1]
        edges.append((f"bench chain {shape}", specs, shape))
    edges.append((f"3-channel head {CHAIN_EDGES[-1]}", head_chain(2),
                  CHAIN_EDGES[-1]))
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, specs, shape in edges:
        x = uniform(gen, shape, -1, 1)
        for mode, dtype in dtypes.items():
            chain = cc.ConvChain(specs, shape[-1], dtype, dev)
            n0 = cc.conv_chain.launches
            out = chain(x)
            if cc.conv_chain.launches - n0 != shape[0]:
                raise AssertionError(f"{name}: {cc.conv_chain.launches - n0}"
                                     f" launches for {shape[0]} images")
            where = "shared" if chain.in_shared_memory else "global"
            errs.append(check_chain(
                f"{mode} {name}, tile {chain.tile}, slots in {where} memory",
                convchain_bench.errors(out, cc.conv_chain_plain(x, specs,
                                                                dtype)),
                dtype))
            if shape[0] > 1 and not torch.equal(out[1:], chain(x[1:])):
                raise AssertionError(f"{name}: image 1 differs from its "
                                     "own launch")

    entry = {"name": "conv_chain", "route": "cuda", "source": CHAIN_SOURCE,
             "replaces": CHAIN_REPLACES, "launches": launches,
             "max_abs_err": max(errs + [r["chain"]["max_abs_err"]
                                        for r in runs.values()]),
             "library_call": "F.conv2d + F.leaky_relu per layer, "
                             "channels_last, compute dtype (cuDNN)"}
    specs = convchain_bench.make_chain(h=8, w=8, device="cpu")[1]
    for mode, run in runs.items():
        dtype = dtypes[mode]
        nbytes, chain_flops = chain_cost(specs, *run["shape"],
                                         dtype.itemsize)
        b_ms, b_by = bound_ms(nbytes, chain_flops, chain_peak(dtype))
        ms = run["chain"]["ms"]
        numbers = {"shape": run["shape"], "dtype": mode, "ms": ms,
                   "plain_ms": run["plain_version_ms"],
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": run["plain"]["ms"], "tile": run["tile"],
                   "executed_factor": run["executed_gflop"] * 1e9
                   / chain_flops,
                   "executed_tflops": run["executed_gflop"] / ms}
        if mode == "bf16":  # the bench's default mode heads the entry
            entry.update(numbers)
        else:
            entry[mode] = numbers
        log(f"# conv_chain {mode}: {numbers['ms']:.3f} ms (bound "
            f"{b_ms:.4f} by {b_by}, plain {numbers['plain_ms']:.3f}, cuDNN "
            f"chain {numbers['library_ms']:.3f}); tile {run['tile']}, "
            f"executed-work factor {numbers['executed_factor']:.3f}, "
            f"{numbers['executed_tflops']:.1f} TFLOP/s executed"
            + (f" ({3 * numbers['executed_tflops']:.1f} in TF32 products)"
               if mode == "fp32" else ""))
    return entry


def phase_warp_tiers(dev):
    """Every variant of the warp tier bench (the path, counted)."""
    log("# warp-tier path: tools/warp_tier_bench.py at 1x1152x1920x48")
    inp = warp_tier_bench.make_inputs(dev)
    wk.flow_warp.launches = 0
    wk.grouped_warp.launches = 0
    rows = warp_tier_bench.run(inp, check=check_equal)
    launches = {"flow_warp": wk.flow_warp.launches,
                "grouped_warp": wk.grouped_warp.launches}
    for row in rows:
        log(json.dumps(row))
        want = {k: int(k == row["kernel"])  # a shift sum launches none
                for k in ("flow_warp", "grouped_warp")}
        if row["launches_per_call"] != want:
            raise AssertionError(f"{row['name']}: launched "
                                 f"{row['launches_per_call']}, want {want}")
    if min(launches.values()) == 0:
        raise AssertionError(f"warp-tier path launches {launches}")
    # each kernel's yardsticks at the bench's shapes (outside the count)
    x, flow = inp["x"], inp["flow"]
    units = (inp["fx"], inp["fy"], inp["mask"])
    n, h, w, c = x.shape
    go, gn = units[0].shape[-1], warp_tier_bench.GROUPS
    elt = x.element_size()
    numbers = {
        "flow_warp": {
            "plain_ms": time_ms(lambda: plain.flow_warp(x, flow), 5, 1),
            "library_ms": grid_sample_ms(x, flow),
            "bound_ms": bound_ms(*flow_warp_cost(n, h, w, c, elt))[0]},
        "grouped_warp": {
            "plain_ms": time_ms(
                lambda: plain.grouped_warp_plain(x, *units, gn), 3, 1),
            "library_ms": None,
            "bound_ms": bound_ms(*grouped_cost(n, h, w, c, go, gn, elt))[0]}}
    # the same two kernels in bf16 at the bench's shapes
    x16 = x.to(torch.bfloat16)
    numbers["flow_warp"]["bf16_ms"] = time_ms(lambda: wk.flow_warp(x16, flow))
    numbers["flow_warp"]["bf16_library_ms"] = grid_sample_ms(x16, flow)
    numbers["grouped_warp"]["bf16_ms"] = time_ms(
        lambda: wk.grouped_warp(x16, *units, gn))
    numbers["flow_warp"]["bf16_bound_ms"] = bound_ms(
        *flow_warp_cost(n, h, w, c, 2))[0]
    numbers["grouped_warp"]["bf16_bound_ms"] = bound_ms(
        *grouped_cost(n, h, w, c, go, gn, 2))[0]
    del x16
    for name, nums in numbers.items():
        nums["launches"] = launches[name]
        nums["ms"] = {r["name"]: r["ms"] for r in rows
                      if r["launches_per_call"][name]}
        log(f"# {name} on the warp-tier path: {json.dumps(nums)}")
    return numbers


def phase_main_path(dev):
    params = init_lssvc(torch.Generator().manual_seed(0))
    model = LSSVC(params, device=dev, od_offset_cap=OD_OFFSET_CAP_SERVING)
    model.set_scale_information(2.0, EL_HW, (0, 0, 0, 0))
    with model.scope():  # the model's own mode, entered by each call
        if (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32):
            raise AssertionError("fp32 parity mode must turn TF32 off")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    x_bl, x_el = uni(*BL_HW, 3), uni(*EL_HW, 3)
    dpb0 = {"ref_frame_bl": uni(*BL_HW, 3), "ref_frame_el": uni(*EL_HW, 3),
            "ref_feature_bl": uni(*BL_HW, 64),
            "ref_feature_el": uni(*EL_HW, 48)}

    def frame(dpb):
        out = model.forward_one_frame(
            x_bl, x_el, dpb["ref_frame_bl"], dpb["ref_frame_el"],
            dpb["ref_feature_bl"], dpb["ref_feature_el"])
        nxt = dict(out["dpb"])
        # the codec's GOP loop clamps the reference frames between frames
        # (lssvc_tpu/harness/runner.py:185-190)
        for k in ("ref_frame_bl", "ref_frame_el"):
            nxt[k] = torch.clamp(nxt[k], 0, 1)
        return out, nxt

    # warm-up, uncounted: records the shape of every kernel launch
    recorder, real_lib = LaunchRecorder(wk._lib()), wk._lib
    wk._lib = lambda: recorder
    try:
        frame(dpb0)
    finally:
        wk._lib = real_lib
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.flow_warp.launches = 0
    wk.grouped_warp.launches = 0
    t0 = time.perf_counter()
    dpb, outs = dpb0, []
    for _ in range(K):
        out, dpb = frame(dpb)
        outs.append(out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"flow_warp": wk.flow_warp.launches,
                "grouped_warp": wk.grouped_warp.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, out in enumerate(outs):
        for k in ("bit_bl", "bit_el"):
            if not math.isfinite(float(out[k])):
                raise AssertionError(f"frame {i}: {k} = {float(out[k])}")
        for k in ("ref_frame_bl", "ref_frame_el"):
            if not bool(torch.isfinite(out["dpb"][k]).all()):
                raise AssertionError(f"frame {i}: {k} not finite")
        if out["dpb"]["ref_frame_el"].shape != (1, *EL_HW, 3):
            raise AssertionError(f"frame {i}: EL recon shape "
                                 f"{tuple(out['dpb']['ref_frame_el'].shape)}")
    if launches != {"flow_warp": 14 * K, "grouped_warp": K}:
        raise AssertionError(f"launch counts {launches}, expected "
                             f"{14 * K} flow_warp and {K} grouped_warp")
    log(json.dumps({
        "main_path": "LSSVC.forward_one_frame", "el": list(EL_HW),
        "bl": list(BL_HW), "frames": K, "precision": "fp32",
        "s_per_frame": seconds / K, "peak_mem_gib": peak_gib,
        "launches": launches,
        "bits": [[float(o["bit_bl"]), float(o["bit_el"])] for o in outs]}))
    return recorder.calls, launches


class FrameTimer:
    """While installed: CUDA events around every call of the two models'
    frame methods (IntraSS.forward for an I-frame, LSSVC.forward_one_frame
    for a P-frame), the wall time of each run_test, and the host seconds
    of the runner's two heaviest host steps, the per-layer metrics and the
    YUV -> RGB conversion."""

    METHODS = ((IntraSS, "forward", "I"), (LSSVC, "forward_one_frame", "P"))
    HOST_STEPS = ("_layer_metrics", "ycbcr420_to_rgb")

    def __init__(self):
        self.spans, self.walls, self.real = [], [], {}
        self.host = {name: [] for name in self.HOST_STEPS}

    def __enter__(self):
        for cls, name, kind in self.METHODS:
            self.real[cls] = real = getattr(cls, name)
            setattr(cls, name, self._timed(real, kind))
        self.real_run_test = scheduler.run_test
        scheduler.run_test = self._walled(self.real_run_test, self.walls)
        for name in self.HOST_STEPS:
            self.real[name] = real = getattr(runner, name)
            setattr(runner, name, self._walled(real, self.host[name], False))
        return self

    def __exit__(self, *exc):
        for cls, name, _ in self.METHODS:
            setattr(cls, name, self.real[cls])
        scheduler.run_test = self.real_run_test
        for name in self.HOST_STEPS:
            setattr(runner, name, self.real[name])

    def _timed(self, real, kind):
        def timed(model, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(model, *args, **kwargs)
            end.record()
            self.spans.append((kind, start, end))
            return out
        return timed

    @staticmethod
    def _walled(real, into, sync=True):
        def walled(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return walled

    def seconds(self, kind):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) / 1e3 for k, s, e in self.spans
                if k == kind]


def gop_inputs(d: Path):
    """Phase 8's sequence and checkpoints, which phase 10 codes again:
    (config, intra checkpoint, video checkpoint) under `d`."""
    t0 = time.perf_counter()
    cfg = synthetic.write_dataset(d / "ds", *GOP_HW, frames=GOP_FRAMES,
                                  gop=GOP, seed=0)
    intra, video = d / "intra.pth", d / "video.pth"
    torch.save(init_intra_ss(torch.Generator().manual_seed(1), 192), intra)
    torch.save(init_lssvc(torch.Generator().manual_seed(2)), video)
    log(f"  sequence and checkpoints written in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, intra, video


def phase_gop(flops, d, cfg, intra, video):
    """The GOP path: the port's CLI (`python -m lssvc_tpu_torch.test`,
    called in-process as `main(argv)`) codes a synthetic 1080p sequence
    with estimated bits from `.pth` checkpoints of the port's init.
    Returns its launch counts and each layer's frame bpp."""
    log(f"# GOP path: {GOP_FRAMES} frames of {GOP_HW[1]}x{GOP_HW[0]} 8-bit "
        f"4:2:0, gop {GOP}, x2, fp32, through lssvc_tpu_torch.test")
    argv = ["--test_config", str(cfg), "--i_frame_model_path", str(intra),
            "--model_path", str(video), "--output_path", str(d / "out"),
            "--ratios", "x2"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.flow_warp.launches = 0
    wk.grouped_warp.launches = 0
    t0 = time.perf_counter()
    with FrameTimer() as timer:
        results = cli.main(argv)
    torch.cuda.synchronize()
    cli_seconds = time.perf_counter() - t0
    launches = {"flow_warp": wk.flow_warp.launches,
                "grouped_warp": wk.grouped_warp.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    written = {layer: json.loads((d / "out" / f"x2_{layer}.json")
                                 .read_text())["synthetic"]["seq1"]
               ["video.pth"] for layer in ("BL", "EL", "FL")}

    n_p = GOP_FRAMES - -(-GOP_FRAMES // GOP)
    want = {"flow_warp": 14 * n_p, "grouped_warp": n_p}
    if launches != want:
        raise AssertionError(f"GOP launch counts {launches}, expected {want}")
    types = [int(i % GOP != 0) for i in range(GOP_FRAMES)]
    if len(results) != 1 or any(r["frame_type"] != types
                                for r in results[0]):
        raise AssertionError(f"frame types {[r['frame_type'] for r in results[0]]}")
    for layer, res in written.items():
        keys = set(RESULT_KEYS) - (YUV_KEYS if layer == "FL" else set())
        if set(res) != keys:
            raise AssertionError(f"x2_{layer}.json keys {sorted(res)}")
        if (res["i_frame_num"], res["p_frame_num"]) != (GOP_FRAMES - n_p, n_p):
            raise AssertionError(f"x2_{layer}.json frame counts {res}")
        for k in ("ave_all_frame_bpp", "ave_i_frame_bpp", "ave_p_frame_bpp",
                  "ave_all_frame_psnr", "ave_i_frame_psnr",
                  "ave_p_frame_psnr", "ave_all_frame_rgb_psnr"):
            if not math.isfinite(res[k]):
                raise AssertionError(f"x2_{layer}.json {k} = {res[k]}")
    for r in results[0]:
        if not all(math.isfinite(b) and b > 0 for b in r["frame_bpp"]):
            raise AssertionError(f"frame bpp {r['frame_bpp']}")

    i_s, p_s = timer.seconds("I"), timer.seconds("P")
    wall = timer.walls[0]
    busy = sum(i_s) + sum(p_s)
    out = {
        "main_path": "lssvc_tpu_torch.test main(argv) -> run_test",
        "el": list(GOP_EL_HW), "bl": list(GOP_BL_HW),
        "source": f"{GOP_HW[1]}x{GOP_HW[0]}", "frames": GOP_FRAMES,
        "gop": GOP, "frame_types": types, "precision": "fp32",
        "device_s_iframe": i_s, "device_s_pframe": p_s,
        "device_s_per_iframe": sum(i_s) / len(i_s),
        "device_s_per_pframe": sum(p_s) / len(p_s),
        # the first frame of each type also pays first-call costs
        "device_s_per_iframe_after_first": sum(i_s[1:]) / len(i_s[1:]),
        "device_s_per_pframe_after_first": sum(p_s[1:]) / len(p_s[1:]),
        "run_test_wall_s": wall, "wall_s_per_frame": wall / GOP_FRAMES,
        "cli_wall_s": cli_seconds,
        # host seconds per frame of the runner's heaviest host steps
        "host_metrics_s_per_frame": sum(timer.host["_layer_metrics"])
        / GOP_FRAMES,
        "host_yuv_to_rgb_s_per_frame": sum(timer.host["ycbcr420_to_rgb"])
        / GOP_FRAMES,
        "idle_share": 1 - busy / wall, "peak_mem_gib": peak_gib,
        "launches": launches, "iframe_flop": flops,
        "iframe_tflops": flops["total"] / 1e12 / (sum(i_s) / len(i_s)),
        "frame_bpp": {layer: r["frame_bpp"]
                      for layer, r in zip(("BL", "EL", "FL"), results[0])},
        "psnr": {layer: [res["ave_i_frame_psnr"], res["ave_p_frame_psnr"]]
                 for layer, res in written.items()},
        "msssim_all": {layer: res["ave_all_frame_msssim"]
                       for layer, res in written.items()}}
    log(json.dumps(out))
    return launches, out["frame_bpp"]


class StreamTimer:
    """While installed: per coded frame, the wall seconds of its encode
    and decode halves (IntraSS: `compress_stream` / `decompress_stream`;
    a P-frame: both layers' `compress` / the two-layer
    `decode_frame_overlapped`), each ended by a synchronize, and inside
    each half the seconds and symbols of the host rANS calls (the C
    coder's encode, flush and decode; a P-frame's decode counts those on
    its worker thread too, though they overlap the card)."""

    def __init__(self):
        self.frames, self.half, self.real = [], None, []

    def _patch(self, owner, name, wrap):
        self.real.append((owner, name, getattr(owner, name)))
        setattr(owner, name, wrap(getattr(owner, name)))

    def __enter__(self):
        for owner, name, kind in ((IntraSS, "encode_decode", "I"),
                                  (LSSVCExtend, "encode_decode", "P")):
            self._patch(owner, name, self._frame(kind))
        for owner, name, half in (
                (intra_ss_stream, "compress_stream", "enc"),
                (intra_ss_stream, "decompress_stream", "dec"),
                (DMCExtend, "compress", "enc"),
                (LSSVCExtend, "compress", "enc"),
                (lssvc_stream, "decode_frame_overlapped", "dec")):
            self._patch(owner, name, self._half(half))
        for owner, name, counts in (
                (rans.BufferedRansEncoder, "encode_with_indexes", True),
                (rans.BufferedRansEncoder, "flush", False),
                (rans.RansDecoder, "decode_stream", False)):
            self._patch(owner, name, self._rans(counts))
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self.real):
            setattr(owner, name, real)

    def _frame(self, kind):
        def wrap(real):
            def frame(*args, **kwargs):
                self.frames.append({"type": kind, "enc_s": 0.0, "dec_s": 0.0,
                                    "enc_rans_s": 0.0, "dec_rans_s": 0.0,
                                    "symbols": 0})
                return real(*args, **kwargs)
            return frame
        return wrap

    def _half(self, half):
        def wrap(real):
            def timed(*args, **kwargs):
                torch.cuda.synchronize()
                self.half, t0 = half, time.perf_counter()
                out = real(*args, **kwargs)
                torch.cuda.synchronize()
                self.frames[-1][f"{half}_s"] += time.perf_counter() - t0
                self.half = None
                return out
            return timed
        return wrap

    def _rans(self, counts):
        def wrap(real):
            def timed(coder, *args):
                t0 = time.perf_counter()
                out = real(coder, *args)
                if self.half is not None:
                    frame = self.frames[-1]
                    frame[f"{self.half}_rans_s"] += time.perf_counter() - t0
                    if counts:  # the symbols the encoder writes
                        frame["symbols"] += np.asarray(args[0]).size
                return out
            return timed
        return wrap

    def summary(self, kind):
        """Seconds per frame of `kind`, each half split into host rANS and
        the rest; symbols per frame."""
        frames = [f for f in self.frames if f["type"] == kind]
        out = {}
        for half in ("enc", "dec"):
            total = [f[f"{half}_s"] for f in frames]
            coder = [f[f"{half}_rans_s"] for f in frames]
            name = "encode" if half == "enc" else "decode"
            out[f"{name}_s"] = total
            out[f"{name}_s_per_frame"] = sum(total) / len(frames)
            out[f"{name}_rans_s_per_frame"] = sum(coder) / len(frames)
            out[f"{name}_device_and_copies_s_per_frame"] = \
                (sum(total) - sum(coder)) / len(frames)
        out["symbols"] = [f["symbols"] for f in frames]
        return out


def _bins(folder):
    """{"BL/0.bin": bytes, ...} under `folder`."""
    return {p.relative_to(folder).as_posix(): p.read_bytes()
            for p in sorted(folder.rglob("*.bin"))}


def _subprocess(cmd, what):
    torch.cuda.empty_cache()  # the child gets the card's free memory
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"{what} exited {res.returncode}:\n"
                             f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return time.perf_counter() - t0


class Background:
    """A subprocess started now and waited for later (phase 2's window),
    its standard output and error in a file of `d`."""

    def __init__(self, cmd, what, d):
        self.what, self.t0 = what, time.perf_counter()
        self.out = open(d / (re.sub(r"\W+", "_", what) + ".out"), "w+")
        self.proc = subprocess.Popen(
            cmd, cwd=Path(__file__).resolve().parent, stdout=self.out,
            stderr=subprocess.STDOUT, text=True)

    def result(self):
        """Its output, after it exits 0 (within 900 s); `seconds` its wall
        time since its start."""
        code = self.proc.wait(timeout=900)
        self.seconds = time.perf_counter() - self.t0
        self.out.seek(0)
        text = self.out.read()
        self.out.close()
        if code != 0:
            raise AssertionError(f"{self.what} exited {code}:\n"
                                 f"{text[-8000:]}")
        return text

    def stop(self):
        """Ends it (and, through its SIGTERM, torchrun's workers)."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _equal(a, b, what):
    if a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"closed loop: {what} differs between the "
                             "encoder and the decoder")


def phase_stream(dev, d, cfg, intra, video, estimated_bpp):
    """Phase 10: real bitstreams of phase 8's sequence, through the CLI in
    a subprocess, through the models in this process, decoded by the
    decode CLI in a fresh subprocess; the closed loop at 1080p.  Returns
    the warp launches of the in-process run."""
    log(f"# stream path: {GOP_FRAMES} frames of {GOP_HW[1]}x{GOP_HW[0]}, "
        f"gop {GOP}, x2, fp32, cap 10 px, --write_stream 1")
    n_p = GOP_FRAMES - -(-GOP_FRAMES // GOP)
    pixels = {"BL": (GOP_HW[0] // 2) * (GOP_HW[1] // 2),
              "EL": GOP_HW[0] * GOP_HW[1]}

    # (a) the CLI, in a subprocess
    cli_bins, out = d / "bins_cli", d / "out_stream"
    cli_s = _subprocess(
        [sys.executable, "-m", "lssvc_tpu_torch.test", "--test_config",
         str(cfg), "--i_frame_model_path", str(intra), "--model_path",
         str(video), "--output_path", str(out), "--ratios", "x2",
         "--write_stream", "1", "--decoding_profiling", "1",
         "--stream_path", str(cli_bins)], "the stream CLI")
    cli_bins = cli_bins / "seq1" / "0" / "x2"
    files = _bins(cli_bins)
    want = {f"{layer}/{i}.bin" for layer in ("BL", "EL")
            for i in range(GOP_FRAMES)}
    if set(files) != want:
        raise AssertionError(f"the CLI wrote {sorted(files)}")
    written = {layer: json.loads((out / f"x2_{layer}.json").read_text())
               ["synthetic"]["seq1"]["video.pth"] for layer in ("BL", "EL")}
    profiling = {}
    for layer, res in written.items():
        bits = 8 * sum(len(b) for k, b in files.items()
                       if k.startswith(layer))
        json_bits = res["ave_all_frame_bpp"] * GOP_FRAMES * pixels[layer]
        if abs(json_bits - bits) > 1e-6 * bits:
            raise AssertionError(f"{layer}: JSON bits {json_bits}, files "
                                 f"{bits}")
        if not (res["encoding_time"] > 0 and res["decoding_time"] > 0):
            raise AssertionError(f"{layer}: encode/decode seconds {res}")
        profiling[layer] = res["decoding_profiling"]
        if list(profiling[layer]) != ["frames", "overall",
                                      *JAX_STAGES[layer]]:
            raise AssertionError(f"{layer} decode-profiling keys "
                                 f"{list(profiling[layer])}")
    log(f"  CLI subprocess {cli_s:.2f} s: {len(files)} bins, bits = 8 x "
        f"file sizes, profiling keys the JAX stage names")

    # (b) the same frames through the models, in this process
    i_net = scheduler.load_intra(str(intra), dev)
    v_net = scheduler.load_video(str(video), dev, OD_OFFSET_CAP_SERVING)
    for net in (i_net, v_net):
        net.update(force=True)
    pictures = {"x_hat_bl": [], "x_hat_el": []}
    real_copy = runner.HostCopy

    def recording(tensors):  # the run's clamped DPB pictures, cropped
        for k in pictures:
            pictures[k].append(yuv_frame(tensors[k], (0, 0, 0, 0)))
        return real_copy(tensors)

    task = {"frame_num": GOP_FRAMES, "gop_size": GOP, "ratio": "x2",
            "yuv_path_el": str(d / "ds" / "seq1" / "x1.yuv"),
            "x1": {"height": GOP_HW[0], "width": GOP_HW[1]},
            "write_stream": True, "bin_folder": str(d / "bins_api")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.flow_warp.launches = 0
    wk.grouped_warp.launches = 0
    runner.HostCopy = recording
    t0 = time.perf_counter()
    try:
        with StreamTimer() as timer:
            logs = runner.run_test(v_net, i_net, task)
    finally:
        runner.HostCopy = real_copy
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"flow_warp": wk.flow_warp.launches,
                "grouped_warp": wk.grouped_warp.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"flow_warp": 20 * n_p, "grouped_warp": 2 * n_p}
    if launches != want:
        raise AssertionError(f"stream launch counts {launches}, expected "
                             f"{want}")
    api = _bins(d / "bins_api" / "x2")
    differ = sorted(k for k in files if api.get(k) != files[k])
    if set(api) != set(files) or differ:
        raise AssertionError(f"in-process bins differ from the CLI's: "
                             f"{differ or sorted(api)}")
    log(f"  in-process run {run_s:.2f} s: {len(api)} bins byte-equal to "
        "the CLI's")

    # (c) the decode CLI, in a fresh subprocess, on the CLI's bins
    yuv = {layer: d / f"decoded_{layer}.yuv" for layer in ("el", "bl")}
    decode_s = _subprocess(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(cli_bins), "--i_frame_model_path", str(intra), "--model_path",
         str(video), "--height", str(GOP_HW[0]), "--width", str(GOP_HW[1]),
         "--ratio", "x2", "--gop", str(GOP), "--frame_num", str(GOP_FRAMES),
         "--yuv_out", str(yuv["el"]), "--yuv_out_bl", str(yuv["bl"])],
        "the decode CLI")
    for layer, path in yuv.items():
        if path.read_bytes() != b"".join(pictures[f"x_hat_{layer}"]):
            raise AssertionError(f"decoded {layer.upper()} YUV differs from "
                                 "the encoder's pictures")
    log(f"  decode subprocess {decode_s:.2f} s: EL and BL YUV byte-equal "
        f"to the encoder's {GOP_FRAMES} frames")

    # (d) the closed loop at 1080p: one I-frame, then the P-frame after it
    gen = torch.Generator(device=dev).manual_seed(4)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    for net in (i_net, v_net):
        net.set_scale_information(2.0, GOP_EL_HW, (0, 0, 0, 0))
    x_bl, x_el = uni(*GOP_BL_HW, 3), uni(*GOP_EL_HW, 3)
    paths = [d / "loop_bl.bin", d / "loop_el.bin"]
    enc = intra_ss_stream.compress_stream(i_net, x_bl, x_el, *paths,
                                          *GOP_BL_HW, *GOP_EL_HW)
    dec = intra_ss_stream.decompress_stream(i_net, *paths)
    for k in ("x_hat_bl", "x_hat_el", "feature_el"):
        _equal(enc[k], dec[k], f"I-frame {k}")
    dpb = {"ref_frame_bl": dec["x_hat_bl"].clamp(0, 1),
           "ref_feature_bl": None,
           "ref_frame_el": dec["x_hat_el"].clamp(0, 1),
           "ref_feature_el": dec["feature_el"]}
    x_bl, x_el = uni(*GOP_BL_HW, 3), uni(*GOP_EL_HW, 3)
    bl = v_net.base_layer_model
    enc = bl.compress(x_bl, dpb)
    dec = bl.decompress(enc["string"], *GOP_BL_HW, dpb)
    for k in ("ref_frame_bl", "ref_feature_bl"):
        _equal(enc["dpb"][k], dec["dpb"][k], f"P-frame {k}")
    dpb_el = dict(dpb, texture=dec["dpb"]["ref_feature_bl"],
                  y_hat_bl=dec["dpb"]["y_hat_bl"],
                  mv_hat_bl=dec["dpb"]["mv_hat_bl"])
    enc = v_net.compress(x_el, dpb_el)
    dec = v_net.decompress(enc["string"], *GOP_EL_HW, dpb_el)
    for k in ("ref_frame_el", "ref_feature_el"):
        _equal(enc["dpb"][k], dec["dpb"][k], f"P-frame {k}")
    log("  closed loop at 1080p: I-frame and P-frame DPB of both layers "
        "bit-equal between encoder and decoder")

    real = {layer: logs[i]["frame_bpp"] for i, layer in
            enumerate(("BL", "EL", "FL"))}
    out = {
        "stream_path": "lssvc_tpu_torch.test --write_stream 1 (subprocess),"
                       " run_test -> encode_decode (in process), "
                       "lssvc_tpu_torch.decode (fresh subprocess)",
        "el": list(GOP_EL_HW), "bl": list(GOP_BL_HW), "frames": GOP_FRAMES,
        "gop": GOP, "precision": "fp32", "od_offset_cap": 10.0,
        "iframe": timer.summary("I"), "pframe": timer.summary("P"),
        "run_test_wall_s": run_s, "wall_s_per_frame": run_s / GOP_FRAMES,
        "cli_subprocess_s": cli_s, "decode_subprocess_s": decode_s,
        "decode_subprocess_s_per_frame": decode_s / GOP_FRAMES,
        "real_bpp": real, "estimated_bpp": estimated_bpp,
        "real_over_estimated": {
            layer: sum(real[layer]) / sum(estimated_bpp[layer])
            for layer in real},
        "peak_mem_gib": peak_gib, "launches": launches,
        "launches_per_p_frame": {k: v / n_p for k, v in launches.items()},
        "decoding_profiling_cli": profiling}
    log(json.dumps(out))
    return launches


def phase_iframe_cpu_vs_card(dev):
    """One IntraSS frame at EL 128x128 / BL 64x64 from the same weights
    on both devices: bits within 3e-3 relative, reconstructions within 5%
    relative RMS."""
    params = init_intra_ss(torch.Generator().manual_seed(0), 192)
    rng = np.random.default_rng(2)
    x_bl = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32))
    x_el = torch.from_numpy(rng.random((1, 128, 128, 3), np.float32))
    outs = []
    for device in ("cpu", dev):
        model = IntraSS(params, device=device)
        model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
        outs.append(model.forward(x_bl.to(device), x_el.to(device)))
    cpu, card = outs
    for k in ("bit_bl", "bit_el"):
        a, b = float(card[k]), float(cpu[k])
        if not abs(a - b) <= 3e-3 * max(abs(b), 1.0):
            raise AssertionError(f"I-frame {k}: card {a} vs cpu {b}")
    rms = {k: _rel_rms(card[k], cpu[k]) for k in ("x_hat_bl", "x_hat_el")}
    if max(rms.values()) > 0.05:
        raise AssertionError(f"I-frame recon relative RMS {rms}")
    log(f"# I-frame cpu vs card at 128x128: bits card "
        f"{float(card['bit_bl']):.3f}/{float(card['bit_el']):.3f} cpu "
        f"{float(cpu['bit_bl']):.3f}/{float(cpu['bit_el']):.3f}, recon rel "
        f"RMS {rms}")


# phase 11: the bench twin's modes at 1080p, K=3 (mode, LSSVC_PACKED_CTX)
BENCH_MODES = [("fp32", "0"), ("high", "0"), ("bf16", "0"),
               ("bf16_f32out", "0"), ("bf16_packed", "0"),
               ("bf16_packed", "1"), ("bf16_einsum", "0")]
PAIR_PACKED_REPLACES = (
    "lssvc_tpu/ops/warp_pallas.py:596-606 (_warp_kernel_cblock, "
    "nhwc_out=\"p\", via flow_warp_auto(packed_out=True) :1214)")
GROUPED_PACKED_REPLACES = (
    "lssvc_tpu/ops/warp_pallas.py:807-811 (_grouped_warp_kernel_cblock, "
    "nhwc_out=\"p\", via grouped_warp_auto(packed_out=True) :1332)")
# the bf16 stream GOP codes the first 3 frames of phase 8's sequence: I P P
BF16_GOP_FRAMES = 3


def _reset_counts():
    for fn in (wk.flow_warp, wk.grouped_warp):
        fn.launches = fn.packed_launches = 0


def _counts():
    return {"flow_warp": wk.flow_warp.launches,
            "flow_warp_packed": wk.flow_warp.packed_launches,
            "grouped_warp": wk.grouped_warp.launches,
            "grouped_warp_packed": wk.grouped_warp.packed_launches}


def phase_modes(dev):
    """Phase 11: the bench twin (`python -m lssvc_tpu_torch.bench`) at
    1080p, K=3, in each serving mode, the warp counts set to 0 just before
    each run and read just after: every run launches both warps; the
    packed-ctx run launches the pair's packed store, one a frame; no other
    run launches a packed store."""
    log("# modes: lssvc_tpu_torch.bench at 1080p, K=3")
    rows = {}
    before = os.environ.get("LSSVC_PACKED_CTX")
    try:
        for mode, ctx in BENCH_MODES:
            os.environ["LSSVC_PACKED_CTX"] = ctx
            torch.cuda.synchronize()
            _reset_counts()
            res = bench.bench_chain(EL_HW, k=K, mode=mode, device=dev)
            torch.cuda.synchronize()
            counts = _counts()
            name = mode + ("+packed_ctx" if ctx == "1" else "")
            if not math.isfinite(res["bits"]):
                raise AssertionError(f"{name}: bits {res['bits']}")
            if counts["flow_warp"] == 0 or counts["grouped_warp"] == 0:
                raise AssertionError(f"{name}: warp counts {counts}")
            if (counts["flow_warp_packed"] > 0) != (ctx == "1"):
                raise AssertionError(f"{name}: packed-store counts {counts}")
            if counts["grouped_warp_packed"]:
                raise AssertionError(f"{name}: grouped packed {counts}")
            frames = counts["grouped_warp"]  # one grouped warp a frame
            if ctx == "1" and counts["flow_warp_packed"] != frames:
                raise AssertionError(f"{name}: {counts}: one packed pair a "
                                     "frame expected")
            rows[name] = dict(res, launches=counts,
                              launches_per_frame={k: v / frames for k, v
                                                  in counts.items()})
            log(f"  {name}: {res['s_per_frame']:.4f} s/frame, peak "
                f"{res['peak_gib']:.2f} GiB, bits {res['bits']:.1f}, "
                f"launches {counts}")
    finally:
        if before is None:
            os.environ.pop("LSSVC_PACKED_CTX", None)
        else:
            os.environ["LSSVC_PACKED_CTX"] = before
    log(json.dumps({"modes": rows}))
    return rows


def _frame_args(seed):
    rng = np.random.default_rng(seed)
    shapes = [(1, 64, 64, 3), (1, 128, 128, 3), (1, 64, 64, 3),
              (1, 128, 128, 3), (1, 64, 64, 64), (1, 128, 128, 48)]
    return [torch.from_numpy(rng.random(s, np.float32)) for s in shapes]


def _p_frame(params, device, args, **mode):
    model = LSSVC(params, device=device, od_offset_cap=OD_OFFSET_CAP_SERVING,
                  **mode)
    model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
    return model.forward_one_frame(*(a.to(device) for a in args))


def _close_mostly(a, b, atol, rtol, frac):
    """`tests/parity_utils.assert_close_mostly`: at most `frac` of the
    elements past atol + rtol |b|."""
    a, b = a.float().cpu(), b.float().cpu()
    share = float(((a - b).abs() > atol + rtol * b.abs()).float().mean())
    if share > frac:
        raise AssertionError(f"{share:.4f} of the elements past tolerance")
    return share


def phase_precision_gates(dev):
    """Phase 12, at the size of phases 5 and 9 (EL 128x128 / BL 64x64):
    (a) bf16 and high P-frames on the card against the port's CPU frames in
    the same precision, with the CPU tests' tolerances (bits within 2%,
    the DPB pictures within 5% relative RMS; bf16 mv_hat: at most 2% of
    elements past 2e-2 + 1e-2 |ref|); (b) high against fp32 on the card
    (printed, and held to phase 5's 3e-3 bits, 5% pictures); (c) fp32 at
    packed width 2, with and without the packed pair warp, against fp32
    plain on the card, within 2e-4 (rtol and atol) but for 0.5% of the
    elements (`tests/parity_utils.assert_close_mostly`: cuDNN's fp32
    algorithms sum the packed and the plain shapes in other orders, and
    the random-init codec amplifies last bits; the largest error and the
    relative RMS are printed); (d) the I-frame in
    bf16 and high on the card against the CPU: bits within 2%; the BL
    picture within 1.5x the card's own distance from its fp32 picture
    (capped at 20%; at least phase 9's 5%): a random-init IntraNoAR's
    latents round differently under any rounding of its convs; the EL
    from the CPU's BL outputs within 5% and 2% bits."""
    params = init_lssvc(torch.Generator().manual_seed(0))
    args = _frame_args(1)
    out = {}
    card = {prec: _p_frame(params, dev, args, precision=prec)
            for prec in ("fp32", "high", "bf16")}
    for prec in ("bf16", "high"):
        cpu = _p_frame(params, "cpu", args, precision=prec)
        row = {}
        for k in ("bit_bl", "bit_el"):
            a, b = float(card[prec][k]), float(cpu[k])
            row[k] = abs(a - b) / abs(b)
            if row[k] > 0.02:
                raise AssertionError(f"{prec} {k}: card {a} vs cpu {b}")
        for k in ("ref_frame_bl", "ref_frame_el"):
            row[k] = _rel_rms(card[prec]["dpb"][k], cpu["dpb"][k])
            if row[k] > 0.05:
                raise AssertionError(f"{prec} {k}: rel RMS {row[k]}")
        if prec == "bf16":
            row["mv_hat_share_past_tol"] = _close_mostly(
                card[prec]["mv_hat"], cpu["mv_hat"], 2e-2, 1e-2, 0.02)
        out[f"{prec}_card_vs_cpu"] = row
    hi, fp = card["high"], card["fp32"]
    row = {k: abs(float(hi[k]) - float(fp[k])) / abs(float(fp[k]))
           for k in ("bit_bl", "bit_el")}
    row.update({k: _rel_rms(hi["dpb"][k], fp["dpb"][k])
                for k in ("ref_frame_bl", "ref_frame_el", "ref_feature_el")})
    row["mv_hat"] = _rel_rms(hi["mv_hat"], fp["mv_hat"])
    out["high_vs_fp32_card"] = row
    if max(row["bit_bl"], row["bit_el"]) > 3e-3 or max(
            row["ref_frame_bl"], row["ref_frame_el"]) > 0.05:
        raise AssertionError(f"high vs fp32 on the card: {row}")
    for ctx in (False, True):
        packed = _p_frame(params, dev, args, packed_width=2, packed_ctx=ctx)
        row = {}
        for k in ("ref_frame_bl", "ref_frame_el", "ref_feature_el"):
            a, b = packed["dpb"][k], fp["dpb"][k]
            row[k] = {
                "max_err_over_tol": float(
                    ((a - b).abs() / (2e-4 + 2e-4 * b.abs())).max()),
                "rel_rms": _rel_rms(a, b),
                "share_past_tol": _close_mostly(a, b, 2e-4, 2e-4, 0.005)}
        out[f"fp32_packed{'_ctx' if ctx else ''}_vs_plain_card"] = row

    # (d) the I-frame
    from lssvc_tpu_torch.models import intra_ss as tis

    iparams = init_intra_ss(torch.Generator().manual_seed(0), 192)
    rng = np.random.default_rng(2)
    x_bl = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32))
    x_el = torch.from_numpy(rng.random((1, 128, 128, 3), np.float32))

    def iframe(device, prec):
        model = IntraSS(iparams, device=device, precision=prec)
        model.set_scale_information(2.0, (128, 128), (0, 0, 0, 0))
        return model, model.forward(x_bl.to(device), x_el.to(device))

    i_fp32 = iframe(dev, "fp32")[1]
    for prec in ("bf16", "high"):
        (m_cpu, cpu), (m_card, crd) = iframe("cpu", prec), iframe(dev, prec)
        row = {"bit_bl": abs(float(crd["bit_bl"]) - float(cpu["bit_bl"]))
               / float(cpu["bit_bl"])}
        row["x_hat_bl"] = _rel_rms(crd["x_hat_bl"], cpu["x_hat_bl"])
        floor = _rel_rms(crd["x_hat_bl"], i_fp32["x_hat_bl"])
        row["x_hat_bl_card_vs_card_fp32"] = floor
        limit = max(0.05, min(1.5 * floor, 0.2))
        if row["bit_bl"] > 0.02 or row["x_hat_bl"] > limit:
            raise AssertionError(f"I-frame {prec}: {row}")
        # the EL from the CPU's BL outputs, on both devices
        bl_cpu = m_cpu.base_layer_model.forward(x_bl)
        els = []
        for model, device in ((m_cpu, "cpu"), (m_card, dev)):
            with model.scope(), torch.no_grad():
                els.append(tis._el_forward(
                    model.el_params(), x_el.to(device),
                    bl_cpu["x_hat"].to(device), bl_cpu["y_hat"].to(device),
                    None, (128, 128), (0, 0, 0, 0)))
        row["el_bit_el"] = abs(float(els[1]["bit_el"])
                               - float(els[0]["bit_el"])) \
            / float(els[0]["bit_el"])
        for k in ("x_hat_el", "feature_el"):
            row[f"el_{k}"] = _rel_rms(els[1][k], els[0][k])
        if row["el_bit_el"] > 0.02 or max(row["el_x_hat_el"],
                                          row["el_feature_el"]) > 0.05:
            raise AssertionError(f"I-frame EL {prec}: {row}")
        out[f"iframe_{prec}_card_vs_cpu"] = row
    log(json.dumps({"precision_gates": out}))
    return out


def check_pair_packed(name, xs, flow, out=None):
    """The packed pair store of xs = [a, b] bit for bit against the plain
    warp of their concat: through `flow_warp_pair(packed_out=True)` (one
    launch, counted as packed), or, given `out` (N, H, W, ca+cb), through
    the C entry point into it (an output the wrapper would not allocate,
    e.g. one element past alignment)."""
    a, b = xs
    n, h, w, ca = a.shape
    ref = plain.flow_warp(torch.cat(xs, -1), flow)
    if out is None:
        c0 = _counts()
        out = wk.flow_warp_pair(a, b, flow, packed_out=True)
        c1 = _counts()
        if (c1["flow_warp"], c1["flow_warp_packed"]) != (
                c0["flow_warp"] + 1, c0["flow_warp_packed"] + 1):
            raise AssertionError(f"{name}: launches {c0} -> {c1}")
        ref = ref.view(out.shape)
    else:
        wk._raise_on(wk._lib().lssvc_flow_warp_pair_packed(
            a.data_ptr(), b.data_ptr(), flow.data_ptr(), out.data_ptr(), n,
            h, w, ca, b.shape[-1], wk._DTYPES[a.dtype],
            torch.cuda.current_stream().cuda_stream), name)
    return check_bits(f"{name} -> {tuple(out.shape)}", out, ref)


def phase_packed_stores(dev):
    """Phase 13: the two packed stores at the model's launch shapes (the
    EL pair, 3 + 48 channels at 1152x1920; grouped_warp 48 -> 96), f32 and
    bf16, bit for bit against their plain versions; the packed pair also
    with a and b one element past 16-byte alignment, into an output one
    element past it (the C entry point), and with a past 2^31 elements;
    then tools/warp_bench.py's `packed_run` (its path), the counts set to
    0 just before and read just after; the plain versions' and
    F.grid_sample's times (f32 and bf16) beside the byte bound."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n, h, w, ca, cb = warp_bench.EL_PAIR
    _, _, _, c_src, go, gn = warp_bench.GROUPED
    log("# packed stores against their plain versions")
    errs = {"pair": [], "grouped": []}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        xs, flow = warp_bench.flow_inputs(gen, warp_bench.EL_PAIR,
                                          dtype=dtype)
        errs["pair"].append(check_pair_packed(
            f"{tag} packed pair {warp_bench.EL_PAIR}", xs, flow))
        errs["pair"].append(check_pair_packed(
            f"{tag} packed pair, a and b at storage offset 1",
            [misaligned(x) for x in xs], flow))
        out = misaligned(torch.empty((n, h, w, ca + cb), dtype=dtype,
                                     device=dev))
        errs["pair"].append(check_pair_packed(
            f"{tag} packed pair into an output at storage offset 1", xs,
            flow, out))
        x, fx, fy, m = warp_bench.grouped_inputs(gen, dtype=dtype)
        out = wk.grouped_warp(x, fx, fy, m, gn, packed_out=True)
        ref = plain.grouped_warp_plain(x, fx, fy, m, gn).view(out.shape)
        errs["grouped"].append(check_bits(
            f"{tag} packed grouped {warp_bench.GROUPED} -> "
            f"{tuple(out.shape)}", out, ref))
        del xs, flow, x, fx, fy, m, out, ref
    # past 2^31 output elements the kernel offsets in 64 bits: the warp is
    # per channel, so a is held by its first and last channels and b whole
    bf16 = torch.bfloat16
    big = (1, h, w, 2 ** 31 // (h * w) + 1)
    a_big = torch.empty(big, dtype=bf16, device=dev).uniform_(
        -1, 1, generator=gen)
    b16 = uniform(gen, (1, h, w, 16), -1, 1).to(bf16)
    flow = uniform(gen, (1, h, w, 2), -25, 25)
    out = wk.flow_warp_pair(a_big, b16, flow, packed_out=True).view(
        1, h, w, -1)
    c_big = big[-1]
    errs["pair"].append(check_bits(
        f"bf16 packed pair a {big}: b {tuple(b16.shape)} ({out.numel()} "
        "output elements)", out[..., c_big:], plain.flow_warp(b16, flow)))
    for chans in (slice(0, 4), slice(c_big - 4, c_big)):
        errs["pair"].append(check_bits(
            f"bf16 packed pair a {big} channels {chans.start}:{chans.stop}",
            out[..., chans],
            plain.flow_warp(a_big[..., chans].contiguous(), flow)))
    del a_big, b16, flow, out
    torch.cuda.synchronize()
    _reset_counts()
    times = warp_bench.packed_run(dev)
    torch.cuda.synchronize()
    counts = _counts()
    if counts["flow_warp_packed"] == 0 or counts["grouped_warp_packed"] == 0:
        raise AssertionError(f"packed_run counts {counts}")
    pair_plain_ms, pair_library_ms = {}, {}
    for dtype in (torch.float32, bf16):
        xs, flow = warp_bench.flow_inputs(gen, warp_bench.EL_PAIR,
                                          dtype=dtype)
        key = str(dtype)[6:]
        pair_plain_ms[key] = time_ms(lambda: plain.flow_warp(
            torch.cat(xs, -1), flow).view(n, h, w // 2, -1), 5, 1)
        pair_library_ms[key] = grid_sample_ms(torch.cat(xs, -1), flow)
        del xs, flow
    x, fx, fy, m = warp_bench.grouped_inputs(gen, dtype=bf16)
    grouped_plain_ms = time_ms(lambda: plain.grouped_warp_plain(
        x, fx, fy, m, gn).view(n, h, w // 2, -1), 3, 1)
    del x, fx, fy, m
    b16, f32 = times["bfloat16"], times["float32"]
    p_bound, p_by = bound_ms(*flow_warp_cost(n, h, w, ca + cb, 2))
    g_bound, g_by = bound_ms(*grouped_cost(*warp_bench.GROUPED, 2))
    pair_entry = {
        "name": "flow_warp_packed", "route": "cuda", "source": SOURCE,
        "replaces": PAIR_PACKED_REPLACES, "call": "flow_warp_pair("
        "packed_out=True)", "shape": list(warp_bench.EL_PAIR),
        "out_shape": [n, h, w // 2, 2 * (ca + cb)], "dtype": "bfloat16",
        "max_abs_err": max(errs["pair"]), "ms": b16["pair_packed_ms"],
        "plain_ms": pair_plain_ms["bfloat16"], "bound_ms": p_bound,
        "bound_by": p_by, "library_ms": pair_library_ms["bfloat16"],
        "library_call": "F.grid_sample(bilinear, border, align_corners=True)"
                        " on the two tensors' concat, bf16",
        "unpacked_ms": b16["pair_ms"],
        "ms_float32": f32["pair_packed_ms"],
        "bound_ms_float32": f32["pair_bound_ms"],
        "plain_ms_float32": pair_plain_ms["float32"],
        "library_ms_float32": pair_library_ms["float32"],
        "unpacked_ms_float32": f32["pair_ms"], "float32": f32,
        "packed_run_launches": counts["flow_warp_packed"]}
    grouped_entry = {
        "name": "grouped_warp_packed", "route": "cuda", "source": SOURCE,
        "replaces": GROUPED_PACKED_REPLACES,
        "call": "grouped_warp(packed_out=True): the plain output viewed "
                "packed (the same bytes)",
        "shape": [n, h, w, c_src], "units": go,
        "out_shape": [n, h, w // 2, 2 * go * (c_src // gn)],
        "dtype": "bfloat16", "max_abs_err": max(errs["grouped"]),
        "ms": b16["grouped_packed_ms"], "plain_ms": grouped_plain_ms,
        "bound_ms": g_bound, "bound_by": g_by, "library_ms": None,
        "unpacked_ms": b16["grouped_ms"], "float32": f32,
        "launches": counts["grouped_warp_packed"]}
    for tag, t in (("f32", f32), ("bf16", b16)):
        key = "float32" if tag == "f32" else "bfloat16"
        log(f"# packed pair {tag} {t['pair_packed_ms']:.4f} ms (unpacked "
            f"{t['pair_ms']:.4f}, bound {t['pair_bound_ms']:.4f}, plain "
            f"{pair_plain_ms[key]:.4f}, grid_sample "
            f"{pair_library_ms[key]:.4f}); packed grouped "
            f"{t['grouped_packed_ms']:.4f} ms (unpacked "
            f"{t['grouped_ms']:.4f}, bound {t['grouped_bound_ms']:.4f})")
    log(f"# packed grouped bf16 plain {grouped_plain_ms:.4f} ms; packed_run "
        f"launches {counts}")
    return pair_entry, grouped_entry, times


def phase_bf16_stream(dev, d, cfg, intra, video):
    """Phase 14: the first 3 frames (I P P) of phase 8's sequence through
    the CLI in this process, `--precision bf16 --write_stream 1`, its
    clamped DPB pictures kept as 8-bit 4:2:0 frames; `python -m
    lssvc_tpu_torch.decode --precision bf16` in a fresh subprocess must
    rebuild them byte for byte; the closed loop at 1080p in bf16 (an
    I-frame and the P-frame after it, encoder DPB = decoder DPB); the
    I-frame's 3x3 conv shapes in bf16 (tools/conv_paths.py)."""
    log(f"# bf16 stream path: {BF16_GOP_FRAMES} frames (I P P) of "
        f"{GOP_HW[1]}x{GOP_HW[0]}, x2, --precision bf16 --write_stream 1")
    bins = d / "bins_bf16"
    pictures = {"x_hat_bl": [], "x_hat_el": []}
    real_copy = runner.HostCopy

    def recording(tensors):
        for k in pictures:
            pictures[k].append(yuv_frame(tensors[k], (0, 0, 0, 0)))
        return real_copy(tensors)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    runner.HostCopy = recording
    t0 = time.perf_counter()
    try:
        with StreamTimer() as timer:
            cli.main(["--test_config", str(cfg), "--i_frame_model_path",
                      str(intra), "--model_path", str(video),
                      "--output_path", str(d / "out_bf16"), "--ratios", "x2",
                      "--precision", "bf16", "--write_stream", "1",
                      "--force_frame_num", str(BF16_GOP_FRAMES),
                      "--stream_path", str(bins)])
    finally:
        runner.HostCopy = real_copy
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _counts()
    n_p = BF16_GOP_FRAMES - 1
    want = {"flow_warp": 20 * n_p, "flow_warp_packed": 0,
            "grouped_warp": 2 * n_p, "grouped_warp_packed": 0}
    if counts != want:
        raise AssertionError(f"bf16 stream counts {counts}, expected {want}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    yuv = {layer: d / f"bf16_{layer}.yuv" for layer in ("el", "bl")}
    decode_s = _subprocess(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(bins / "seq1" / "0" / "x2"), "--i_frame_model_path", str(intra),
         "--model_path", str(video), "--height", str(GOP_HW[0]), "--width",
         str(GOP_HW[1]), "--ratio", "x2", "--gop", str(GOP), "--frame_num",
         str(BF16_GOP_FRAMES), "--precision", "bf16", "--yuv_out",
         str(yuv["el"]), "--yuv_out_bl", str(yuv["bl"])],
        "the bf16 decode CLI")
    for layer, path in yuv.items():
        if path.read_bytes() != b"".join(pictures[f"x_hat_{layer}"]):
            raise AssertionError(f"bf16: decoded {layer.upper()} YUV "
                                 "differs from the encoder's pictures")
    log(f"  CLI in process {run_s:.2f} s; bf16 decode subprocess "
        f"{decode_s:.2f} s: EL and BL YUV byte-equal to the encoder's "
        f"{BF16_GOP_FRAMES} frames")

    # the closed loop at 1080p in bf16
    i_net = scheduler.load_intra(str(intra), dev, "bf16")
    v_net = scheduler.load_video(str(video), dev, OD_OFFSET_CAP_SERVING,
                                 "bf16")
    for net in (i_net, v_net):
        net.update(force=True)
        net.set_scale_information(2.0, GOP_EL_HW, (0, 0, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(6)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    x_bl, x_el = uni(*GOP_BL_HW, 3), uni(*GOP_EL_HW, 3)
    paths = [d / "loop16_bl.bin", d / "loop16_el.bin"]
    enc = intra_ss_stream.compress_stream(i_net, x_bl, x_el, *paths,
                                          *GOP_BL_HW, *GOP_EL_HW)
    dec = intra_ss_stream.decompress_stream(i_net, *paths)
    for k in ("x_hat_bl", "x_hat_el", "feature_el"):
        if dec[k].dtype != torch.bfloat16:
            raise AssertionError(f"bf16 I-frame {k} is {dec[k].dtype}")
        _equal(enc[k], dec[k], f"bf16 I-frame {k}")
    dpb = {"ref_frame_bl": dec["x_hat_bl"].clamp(0, 1),
           "ref_feature_bl": None,
           "ref_frame_el": dec["x_hat_el"].clamp(0, 1),
           "ref_feature_el": dec["feature_el"]}
    x_bl, x_el = uni(*GOP_BL_HW, 3), uni(*GOP_EL_HW, 3)
    bl = v_net.base_layer_model
    enc = bl.compress(x_bl, dpb)
    dec = bl.decompress(enc["string"], *GOP_BL_HW, dpb)
    for k in ("ref_frame_bl", "ref_feature_bl"):
        _equal(enc["dpb"][k], dec["dpb"][k], f"bf16 P-frame {k}")
    dpb_el = dict(dpb, texture=dec["dpb"]["ref_feature_bl"],
                  y_hat_bl=dec["dpb"]["y_hat_bl"],
                  mv_hat_bl=dec["dpb"]["mv_hat_bl"])
    enc = v_net.compress(x_el, dpb_el)
    dec = v_net.decompress(enc["string"], *GOP_EL_HW, dpb_el)
    for k in ("ref_frame_el", "ref_feature_el"):
        _equal(enc["dpb"][k], dec["dpb"][k], f"bf16 P-frame {k}")
    log("  closed loop at 1080p in bf16: I-frame and P-frame DPB of both "
        "layers bit-equal between encoder and decoder")
    del i_net, v_net, enc, dec, dpb, dpb_el

    convs = [{"c_in": ci, "c_out": co, "hw": [h, w],
              **conv_paths.conv_paths(dev, ci, co, h, w, torch.bfloat16)}
             for ci, co, h, w in conv_paths.SHAPES]
    out = {
        "bf16_stream_path": "lssvc_tpu_torch.test --precision bf16 "
                            "--write_stream 1 (in process), "
                            "lssvc_tpu_torch.decode --precision bf16 (fresh "
                            "subprocess)",
        "frames": BF16_GOP_FRAMES, "el": list(GOP_EL_HW),
        "bl": list(GOP_BL_HW), "iframe": timer.summary("I"),
        "pframe": timer.summary("P"), "run_s": run_s,
        "decode_subprocess_s": decode_s,
        "decode_subprocess_s_per_frame": decode_s / BF16_GOP_FRAMES,
        "peak_mem_gib": peak_gib, "launches": counts,
        "iframe_conv_shapes_bf16": convs}
    log(json.dumps(out))
    return counts


# phase 15: the int8 precision
INT8_SOURCE = "lssvc_tpu_torch/csrc/int8_conv.cu"
INT8_REPLACES = (
    "not a Pallas kernel: XLA's s8 conv, lssvc_tpu/ops/int8.py:63-76 "
    "(int8_conv2d), as lssvc_tpu/models/packed_blocks.py:35-53 "
    "(_pconv_int8) runs it")
INT8_CODES = {0: torch.int8, 1: torch.bfloat16, 2: torch.float32}
# the int8 stream GOP codes the first 3 frames of phase 8's sequence: I P P
INT8_GOP_FRAMES = 3


def int8_input(gen, shape, dtype):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen,
                             device=gen.device, dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype) * 2


def int8_case(gen, label, x, cout, kh, kw, stride, pad, cases=("s32", "bf16")):
    """int8_conv against its plain version on x with a random s8 kernel:
    the s32 accumulator and the bf16 epilogue, bit for bit (a float x is
    quantized as it loads, by 0.0173)."""
    dev = gen.device
    w8 = torch.randint(-127, 128, (cout, x.shape[-1], kh, kw), generator=gen,
                       device=dev, dtype=torch.int8)
    mult = uniform(gen, (cout,), 1e-6, 1e-4)
    bias = uniform(gen, (cout,), -0.1, 0.1)
    s_in = None if x.dtype == torch.int8 else 0.0173
    for case in cases:
        m, b = (mult, bias) if case == "bf16" else (None, None)
        check_bits(f"{label} {case}",
                   q8.int8_conv2d(x, w8, stride, pad, s_in=s_in, mult=m,
                                  bias=b),
                   q8.int8_conv2d_plain(x, w8, stride, pad, s_in=s_in,
                                        mult=m, bias=b))
    return w8, mult, bias, s_in


def int8_edges(gen):
    """Phase 15 (b)'s edge cases, each against the plain version."""
    bf16 = torch.bfloat16
    for label, shape, dtype, cout, k, stride, pad in (
            ("Cin 102", (1, 64, 96, 102), bf16, 96, (3, 3), 1,
             ((1, 1), (1, 1))),
            ("Cin 32, 7x3", (1, 64, 96, 32), bf16, 128, (7, 3), 1,
             ((3, 3), (1, 1))),
            ("stride 2, padding (1, 0)", (1, 65, 98, 102), bf16, 96, (3, 3),
             2, ((1, 1), (1, 0))),
            ("7x3, padding (1, 0)", (1, 70, 50, 128), bf16, 256, (7, 3), 1,
             ((3, 3), (1, 0))),
            ("batch 2", (2, 64, 96, 96), bf16, 96, (3, 3), 1,
             ((1, 1), (1, 1))),
            ("s8 input", (1, 64, 96, 96), torch.int8, 64, (1, 1), 1,
             ((0, 0), (0, 0))),
            ("f32 input, Cin 106", (1, 64, 96, 106), torch.float32, 128,
             (3, 3), 1, ((1, 1), (1, 1)))):
        int8_case(gen, f"edge {label} {shape}", int8_input(gen, shape, dtype),
                  cout, *k, stride, pad)

    # an input and an output one element past 16-byte alignment
    x = misaligned(int8_input(gen, (1, 64, 96, 96), bf16))
    w8, mult, bias, s_in = int8_case(gen, "edge misaligned input", x, 96, 3,
                                     3, 1, ((1, 1), (1, 1)))
    kern = q8.Int8Weight(w8)
    lay = kern.layout()
    for out_bf16, dtype in ((1, bf16), (0, torch.int32)):
        m, b = (mult, bias) if out_bf16 else (None, None)
        ref = q8.int8_conv2d_plain(x, w8, 1, ((1, 1), (1, 1)), s_in=s_in,
                                   mult=m, bias=b)
        out = torch.empty(ref.numel() + 1, dtype=dtype,
                          device=x.device)[1:].view(ref.shape)
        err = q8._lib().lssvc_int8_conv(
            x.data_ptr(), lay.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if b is None else b.data_ptr(), float(np.float32(s_in)), 1,
            64, 96, 96, 64, 96, 96, kern.cout_pad, kern.cinp, 3, 3, 1, 1,
            1, 1, out_bf16, torch.cuda.current_stream().cuda_stream)
        if err:
            raise AssertionError(f"misaligned output: CUDA error {err}")
        check_bits(f"edge misaligned output {dtype}", out, ref)
    del x, out, ref

    # an input past 2^31 elements: the last rows against the plain version
    # on a crop (its first output row reads the crop's own zero padding)
    shape = (1, 4100, 4100, 128)
    x = int8_input(gen, shape, bf16)
    w8 = torch.randint(-127, 128, (8, 128, 3, 3), generator=gen,
                       device=x.device, dtype=torch.int8)
    mult, bias = uniform(gen, (8,), 1e-6, 1e-4), uniform(gen, (8,), -0.1, 0.1)
    for m, b, case in ((None, None, "s32"), (mult, bias, "bf16")):
        out = q8.int8_conv2d(x, w8, 1, ((1, 1), (1, 1)), s_in=0.0173,
                             mult=m, bias=b)
        ref = q8.int8_conv2d_plain(x[:, -12:], w8, 1, ((1, 1), (1, 1)),
                                   s_in=0.0173, mult=m, bias=b)
        check_bits(f"edge input of {x.numel()} elements {case}, last 11 rows",
                   out[:, -11:], ref[:, 1:])
        del out, ref
    del x

    # all +-127 at the largest K of the path, 7*3*256 = 5376
    x = torch.full((1, 40, 60, 256), 127, dtype=torch.int8, device=w8.device)
    for sign in (1, -1):
        w8 = torch.full((64, 256, 7, 3), sign * 127, dtype=torch.int8,
                        device=x.device)
        acc = q8.int8_conv2d(x, w8, 1, ((3, 3), (1, 1)))
        check_bits(f"edge full scale x {sign} at K = 5376", acc,
                   q8.int8_conv2d_plain(x, w8, 1, ((3, 3), (1, 1))))
        if int(acc[0, 20, 30, 0]) != sign * 127 * 127 * 5376:
            raise AssertionError(f"full scale: {int(acc[0, 20, 30, 0])}")


def int8_chain(modes, d):
    """Phase 15 (c): the bench twin in int8_packed at 1080p, K=3, without
    and with the packed pair warp, the counts set to 0 just before each
    run and read just after; the run without it profiles one chain of 3
    frames (`--profile`), and so does a bf16_packed run: int8_conv's share
    of the int8 frame's device time beside the bf16 frame's."""
    rows = {}
    profile_dir = d / "profile"
    bf16 = bench.bench_chain(EL_HW, k=K, mode="bf16_packed",
                             device=torch.device("cuda"),
                             profile=profile_dir)
    rows["bf16_packed_profile"] = bf16["profile"]
    before = os.environ.get("LSSVC_PACKED_CTX")
    try:
        for ctx in ("0", "1"):
            os.environ["LSSVC_PACKED_CTX"] = ctx
            torch.cuda.synchronize()
            _reset_counts()
            q8.int8_conv2d.launches = 0
            res = bench.bench_chain(
                EL_HW, k=K, mode="int8_packed", device=torch.device("cuda"),
                profile=profile_dir if ctx == "0" else None)
            torch.cuda.synchronize()
            counts = dict(_counts(), int8_conv=q8.int8_conv2d.launches)
            name = "int8_packed" + ("+packed_ctx" if ctx == "1" else "")
            frames = res["frames_run"]
            # the calibration's bf16 frames launch the warps too
            coded = frames + bench.CALIB_FRAMES
            if not math.isfinite(res["bits"]):
                raise AssertionError(f"{name}: bits {res['bits']}")
            if not 0 < counts["int8_conv"] == res["int8_served_calls"]:
                raise AssertionError(
                    f"{name}: {counts['int8_conv']} int8_conv launches for "
                    f"{res['int8_served_calls']} served site calls")
            if (counts["flow_warp"] != 14 * coded
                    or counts["grouped_warp"] != coded):
                raise AssertionError(f"{name}: warp counts {counts} for "
                                     f"{coded} frames")
            if counts["flow_warp_packed"] != (frames if ctx == "1" else 0):
                raise AssertionError(f"{name}: packed stores {counts}")
            bf16_row = modes["bf16_packed" + name[len("int8_packed"):]]
            rows[name] = dict(
                res, launches=counts,
                int8_conv_launches_per_frame=counts["int8_conv"] / frames,
                served_site_calls_per_frame=res["int8_served_calls"] / frames,
                bf16_packed_s_per_frame=bf16_row["s_per_frame"],
                bf16_packed_peak_gib=bf16_row["peak_gib"],
                bf16_packed_bits=bf16_row["bits"])
            log(f"  {name}: {res['s_per_frame']:.4f} s/frame (bf16_packed "
                f"{bf16_row['s_per_frame']:.4f}), peak {res['peak_gib']:.2f} "
                f"GiB ({bf16_row['peak_gib']:.2f}), bits {res['bits']:.1f} "
                f"({bf16_row['bits']:.1f}); {res['int8_served']} of "
                f"{res['int8_sites']} sites served, int8_conv "
                f"{counts['int8_conv'] / frames:g} launches a frame = the "
                f"served site calls a frame, over {frames} frames; {counts}")
            if "profile" in res:
                prof, ref = res["profile"], bf16["profile"]
                log(f"  {name} profiled: {prof['ms_per_frame']:.3f} ms of "
                    f"device time a frame, int8_conv "
                    f"{prof['int8_conv_ms_per_frame']:.3f} ms "
                    f"({prof['int8_conv_share']:.1%}); bf16_packed "
                    f"{ref['ms_per_frame']:.3f} ms a frame")
    finally:
        if before is None:
            os.environ.pop("LSSVC_PACKED_CTX", None)
        else:
            os.environ["LSSVC_PACKED_CTX"] = before
    return rows


def int8_stream(dev, d, cfg, intra, video, table_path, table):
    """Phase 15 (d): the first 3 frames (I P P) of phase 8's sequence
    through the CLI in int8, decoded in a fresh subprocess byte for byte;
    the 1080p closed loop in int8."""
    bins = d / "bins_int8"
    pictures = {"x_hat_bl": [], "x_hat_el": []}
    real_copy = runner.HostCopy

    def recording(tensors):
        for k in pictures:
            pictures[k].append(yuv_frame(tensors[k], (0, 0, 0, 0)))
        return real_copy(tensors)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    q8.int8_conv2d.launches = 0
    runner.HostCopy = recording
    t0 = time.perf_counter()
    try:
        with StreamTimer() as timer:
            cli.main(["--test_config", str(cfg), "--i_frame_model_path",
                      str(intra), "--model_path", str(video),
                      "--output_path", str(d / "out_int8"), "--ratios", "x2",
                      "--precision", "int8", "--int8_calib", str(table_path),
                      "--write_stream", "1",
                      "--force_frame_num", str(INT8_GOP_FRAMES),
                      "--stream_path", str(bins)])
    finally:
        runner.HostCopy = real_copy
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(_counts(), int8_conv=q8.int8_conv2d.launches)
    n_p = INT8_GOP_FRAMES - 1
    want = {"flow_warp": 20 * n_p, "grouped_warp": 2 * n_p}
    if ({k: counts[k] for k in want} != want or counts["int8_conv"] == 0
            or counts["flow_warp_packed"] or counts["grouped_warp_packed"]):
        raise AssertionError(f"int8 stream counts {counts}, expected {want} "
                             "and int8_conv launches")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    yuv = {layer: d / f"int8_{layer}.yuv" for layer in ("el", "bl")}
    decode_s = _subprocess(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(bins / "seq1" / "0" / "x2"), "--i_frame_model_path", str(intra),
         "--model_path", str(video), "--height", str(GOP_HW[0]), "--width",
         str(GOP_HW[1]), "--ratio", "x2", "--gop", str(GOP), "--frame_num",
         str(INT8_GOP_FRAMES), "--precision", "int8", "--int8_calib",
         str(table_path), "--yuv_out", str(yuv["el"]), "--yuv_out_bl",
         str(yuv["bl"])], "the int8 decode CLI")
    for layer, path in yuv.items():
        if path.read_bytes() != b"".join(pictures[f"x_hat_{layer}"]):
            raise AssertionError(f"int8: decoded {layer.upper()} YUV "
                                 "differs from the encoder's pictures")
    log(f"  CLI in process {run_s:.2f} s ({counts['int8_conv']} int8_conv "
        f"launches, {counts['int8_conv'] / n_p:g} a P-frame, encoder and "
        f"decoder); int8 decode subprocess {decode_s:.2f} s: EL and BL YUV "
        f"byte-equal to the encoder's {INT8_GOP_FRAMES} frames")

    # the closed loop at 1080p in int8
    i_net = scheduler.load_intra(str(intra), dev, "int8", table)
    v_net = scheduler.load_video(str(video), dev, OD_OFFSET_CAP_SERVING,
                                 "int8", table)
    for net in (i_net, v_net):
        net.update(force=True)
        net.set_scale_information(2.0, GOP_EL_HW, (0, 0, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(7)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    x_bl, x_el = uni(*GOP_BL_HW, 3), uni(*GOP_EL_HW, 3)
    paths = [d / "loop8_bl.bin", d / "loop8_el.bin"]
    enc = intra_ss_stream.compress_stream(i_net, x_bl, x_el, *paths,
                                          *GOP_BL_HW, *GOP_EL_HW)
    dec = intra_ss_stream.decompress_stream(i_net, *paths)
    for k in ("x_hat_bl", "x_hat_el", "feature_el"):
        _equal(enc[k], dec[k], f"int8 I-frame {k}")
    dpb = {"ref_frame_bl": dec["x_hat_bl"].clamp(0, 1),
           "ref_feature_bl": None,
           "ref_frame_el": dec["x_hat_el"].clamp(0, 1),
           "ref_feature_el": dec["feature_el"]}
    x_bl, x_el = uni(*GOP_BL_HW, 3), uni(*GOP_EL_HW, 3)
    n0 = q8.int8_conv2d.launches
    bl = v_net.base_layer_model
    enc = bl.compress(x_bl, dpb)
    dec = bl.decompress(enc["string"], *GOP_BL_HW, dpb)
    for k in ("ref_frame_bl", "ref_feature_bl"):
        _equal(enc["dpb"][k], dec["dpb"][k], f"int8 P-frame {k}")
    dpb_el = dict(dpb, texture=dec["dpb"]["ref_feature_bl"],
                  y_hat_bl=dec["dpb"]["y_hat_bl"],
                  mv_hat_bl=dec["dpb"]["mv_hat_bl"])
    enc = v_net.compress(x_el, dpb_el)
    dec = v_net.decompress(enc["string"], *GOP_EL_HW, dpb_el)
    for k in ("ref_frame_el", "ref_feature_el"):
        _equal(enc["dpb"][k], dec["dpb"][k], f"int8 P-frame {k}")
    if q8.int8_conv2d.launches == n0:
        raise AssertionError("the int8 closed loop launched no int8_conv")
    log("  closed loop at 1080p in int8: I-frame and P-frame DPB of both "
        f"layers bit-equal between encoder and decoder "
        f"({q8.int8_conv2d.launches - n0} int8_conv launches)")
    del i_net, v_net, enc, dec, dpb, dpb_el
    i_sum, p_sum = timer.summary("I"), timer.summary("P")
    log(f"  int8 stream: I-frame encode {i_sum['encode_s_per_frame']:.3f} s"
        f" / decode {i_sum['decode_s_per_frame']:.3f} s, P-frame encode "
        f"{p_sum['encode_s_per_frame']:.3f} s / decode "
        f"{p_sum['decode_s_per_frame']:.3f} s (host rANS "
        f"{p_sum['encode_rans_s_per_frame']:.3f} / "
        f"{p_sum['decode_rans_s_per_frame']:.3f}), peak {peak_gib:.2f} GiB")
    return {"frames": INT8_GOP_FRAMES, "iframe": i_sum, "pframe": p_sum,
            "run_s": run_s,
            "decode_subprocess_s": decode_s,
            "decode_subprocess_s_per_frame": decode_s / INT8_GOP_FRAMES,
            "peak_mem_gib": peak_gib, "launches": counts}


def phase_int8(dev, d, cfg, intra, video, modes):
    """Phase 15: the int8 precision.  (a) calibrate phase 8's video
    checkpoint with the port's tool (512x512, 3 frames); (b) int8_conv bit
    for bit against its plain version at every shape a warm-up int8 frame
    at 1080p launched it with, then the edge cases, then its time at each
    shape beside its bound and cuDNN's bf16 conv; (c) the bench twin's
    int8_packed chain at 1080p, K=3, counted, without and with the packed
    pair warp, and one chain of it and of bf16_packed profiled; (d) the
    int8 stream GOP (I P P) through both CLIs and the
    1080p closed loop; (e) the kernel's times at two sites, beside its
    bounds, its plain version, cuDNN's bf16 conv and the taps-call
    torch._int_mm yardstick, then tools/int8_bench.py's stack."""
    t_phase = time.perf_counter()
    log("# int8: (a) calibration, python -m "
        "lssvc_tpu_torch.tools.int8_calibrate on phase 8's video checkpoint")
    table_path = d / "int8_calib.json"
    t0 = time.perf_counter()
    table = int8_calibrate.main(["--out", str(table_path), "--ckpt",
                                 str(video)])
    log(f"  {len(table)} conv sites calibrated in "
        f"{time.perf_counter() - t0:.2f} s")

    log("# int8: (b) int8_conv at the shapes of a warm-up int8 frame at "
        "1080p, bit for bit against its plain version")
    model = LSSVC(bench.load_params(str(video)), device=dev,
                  od_offset_cap=OD_OFFSET_CAP_SERVING, precision="int8",
                  packed_width=2, int8_table=table)
    model.set_scale_information(2.0, EL_HW, (0, 0, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(15)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    calls = int8_bench.record_launches(lambda: model.forward_one_frame(
        uni(*BL_HW, 3), uni(*EL_HW, 3), uni(*BL_HW, 3), uni(*EL_HW, 3),
        uni(*BL_HW, 64), uni(*EL_HW, 48)))
    served_calls = model.mode.int8.calls
    del model
    if len(calls) != served_calls or not served_calls:
        raise AssertionError(f"{len(calls)} launches for {served_calls} "
                             "served site calls")
    shapes = sorted(set(calls))
    log(f"  the frame launched int8_conv {len(calls)} times at "
        f"{len(shapes)} shapes")
    for (n, h, w, cin, ho, wo, cout, kh, kw, stride, pt, pl, code,
         out_bf16) in shapes:
        pad = ((pt, (ho - 1) * stride + kh - h - pt),
               (pl, (wo - 1) * stride + kw - w - pl))
        int8_case(gen, f"launch {(n, h, w, cin)} -> {cout} {kh}x{kw} "
                       f"stride {stride} padding {pad} "
                       f"{INT8_CODES[code]}",
                  int8_input(gen, (n, h, w, cin), INT8_CODES[code]), cout,
                  kh, kw, stride, pad)
    int8_edges(gen)
    torch.cuda.empty_cache()
    log("# int8: (b) int8_conv's time at each launch shape of the frame "
        "(tools/int8_bench.py --frame), beside its bound and cuDNN's bf16 "
        "conv of the same packed shape")
    frame = int8_bench.time_launches(calls, dev)
    int8_bench.log_frame_times(frame, out=sys.stdout)
    torch.cuda.empty_cache()

    log("# int8: (c) the bench twin's int8_packed chain at 1080p, K=3, "
        "and bf16_packed's, each with one profiled chain of 3 frames")
    chain = int8_chain(modes, d)
    log("# int8: (d) the int8 stream: first 3 frames (I P P) of phase 8's "
        "sequence, --precision int8 --int8_calib --write_stream 1")
    stream = int8_stream(dev, d, cfg, intra, video, table_path, table)

    log("# int8: (e) times (tools/int8_bench.py)")
    sites = {name: int8_bench.site_times(name, dev)
             for name in int8_bench.SITES}
    for name, r in sites.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: not bit-equal ({r})")
        log(f"  {name} {r['shape']} -> {r['cout']} {r['kernel']}: int8_conv "
            f"{r['ms']:.4f} ms, bounds {r['bytes_ms']:.4f} (bytes) / "
            f"{r['ops_ms']:.4f} (operations), plain {r['plain_ms']:.3f}, "
            f"cuDNN bf16 {r['cudnn_bf16_ms']:.4f}, torch._int_mm x "
            f"{r['int_mm_calls']} {r['int_mm_ms']:.4f}")
    stack = int8_bench.stack_variants(dev)
    log(f"  int8_bench stack (4 layers, 1x1152x960x96): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stack.items())
        + " (int8_mm: 9 torch._int_mm calls a layer)")
    site = sites["packed_3x3_96"]
    main_run = chain["int8_packed"]
    entry = {
        "name": "int8_conv", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES,
        "launches": main_run["launches"]["int8_conv"],
        "launches_per_frame": main_run["int8_conv_launches_per_frame"],
        "max_abs_err": 0.0, "site": "packed_3x3_96",
        "shape": site["shape"], "cout": site["cout"],
        "dtype": "bfloat16 in and out (quantized on load, fused epilogue)",
        "ms": site["ms"], "plain_ms": site["plain_ms"],
        "bound_ms": site["bound_ms"], "bound_by": site["bound_by"],
        "library_ms": None,
        "library_note": "no one PyTorch call computes an s8 conv (F.conv2d "
                        "refuses int8); cudnn_bf16_ms is the path it "
                        "replaces, int_mm_ms a taps-call yardstick",
        "cudnn_bf16_ms": site["cudnn_bf16_ms"],
        "int_mm_ms": site["int_mm_ms"], "int_mm_calls": site["int_mm_calls"],
        "spynet_el_conv2": sites["spynet_el_conv2"], "stack_ms": stack,
        "packed_ctx_launches":
            chain["int8_packed+packed_ctx"]["launches"]["int8_conv"],
        "stream_launches": stream["launches"]["int8_conv"],
        "warm_up_launch_shapes": len(shapes),
        "frame_launch_shapes": frame["shapes"],
        "frame_sums_ms": frame["sums"],
        "int8_frame_profile": chain["int8_packed"]["profile"],
        "bf16_frame_profile": chain["bf16_packed_profile"]}
    log(json.dumps({"int8": {"chain": chain, "stream": stream,
                             "sites": sites, "table_sites": len(table)}}))
    log(f"# int8 phase: {time.perf_counter() - t_phase:.1f} s")
    return entry


# phase 16: the serving path
SERVE_FRAMES = 6  # streambench's P-frames
SERVE_GOP_FRAMES = 3  # encode_gop and the worker runs: I P P


@contextlib.contextmanager
def counted(into):
    """The warp counts set to 0 on entry and read into `into` on exit."""
    torch.cuda.synchronize()
    _reset_counts()
    yield
    torch.cuda.synchronize()
    into.update(_counts())


class SpanTimer:
    """While installed: CUDA events around every call of the models'
    frame methods (IntraSS.forward, LSSVC.forward_one_frame) on any
    thread.  `busy_s()` is the union of those spans on the card's
    timeline: with two workers on one stream the spans of one thread's
    calls hold the other's work too, so they are merged, not summed."""

    METHODS = ((IntraSS, "forward"), (LSSVC, "forward_one_frame"))

    def __init__(self):
        self.spans, self.real = [], {}
        self.lock = threading.Lock()

    def __enter__(self):
        self.origin = torch.cuda.Event(enable_timing=True)
        self.origin.record()
        for cls, name in self.METHODS:
            self.real[cls] = real = getattr(cls, name)
            setattr(cls, name, self._timed(real))
        return self

    def __exit__(self, *exc):
        for cls, name in self.METHODS:
            setattr(cls, name, self.real[cls])

    def _timed(self, real):
        def timed(model, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(model, *args, **kwargs)
            end.record()
            with self.lock:
                self.spans.append((start, end))
            return out
        return timed

    def busy_s(self):
        torch.cuda.synchronize()
        spans = sorted((self.origin.elapsed_time(s) / 1e3,
                        self.origin.elapsed_time(e) / 1e3)
                       for s, e in self.spans)
        busy, reach = 0.0, -math.inf
        for a, b in spans:
            if b > reach:
                busy += b - max(a, reach)
                reach = b
        return busy


def _same_results(a, b, where="results"):
    """Equal CLI results, NaN equal to NaN; wall-clock seconds skipped."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{where}: keys {sorted(a)} != {sorted(b)}")
        for k in a:
            if not k.endswith("_time"):
                _same_results(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: lengths {len(a)} != {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_results(x, y, f"{where}[{i}]")
    elif not (a == b or (isinstance(a, float) and isinstance(b, float)
                         and math.isnan(a) and math.isnan(b))):
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def phase_serving(dev, d, cfg, intra, video, modes):
    """Phase 16: the serving path (module docstring).  Returns the warps'
    launches a P-frame of the pipelined encode plus the overlapped decode,
    and a frame of the four-stage frame."""
    t_phase = time.perf_counter()
    log(f"# serving: (a)-(b) lssvc_tpu_torch.tools.streambench at "
        f"{EL_HW[1]}x{EL_HW[0]}, bf16, {SERVE_FRAMES} P-frames")
    pipe_counts = {}
    res = streambench.run(EL_HW, SERVE_FRAMES, "bf16", dev,
                          folder=d / "streambench",
                          counted=lambda: counted(pipe_counts))
    want = {"flow_warp": 20 * SERVE_FRAMES, "flow_warp_packed": 0,
            "grouped_warp": 2 * SERVE_FRAMES, "grouped_warp_packed": 0}
    if pipe_counts != want:
        raise AssertionError(f"pipelined encode + overlapped decode counts "
                             f"{pipe_counts}, expected {want}")
    ms = res["ms_per_frame"]
    log(f"  bins byte-equal, final DPBs bit-equal; ms/frame: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
        + f"; encode speedup {res['encode_speedup']:.3f}x, decode speedup "
        f"{res['decode_speedup']:.3f}x; launches {pipe_counts}")
    del res["final_dpb"]

    # (c) encode_gop on phase 14's frames, against phase 14's CLI bins
    frames, hw_bl, hw_el = serving.read_frames(
        d / "ds" / "seq1" / "x1.yuv", *GOP_HW, "x2", SERVE_GOP_FRAMES, dev)
    i_net = scheduler.load_intra(str(intra), dev, "bf16")
    v_net = scheduler.load_video(str(video), dev, OD_OFFSET_CAP_SERVING,
                                 "bf16")
    for net in (i_net, v_net):
        net.update(force=True)
        net.set_scale_information(2.0, hw_el, (0, 0, 0, 0))
    gop_dir = d / "serving_gop"
    gop_paths = {layer: [gop_dir / layer / f"{t}.bin"
                         for t in range(SERVE_GOP_FRAMES)]
                 for layer in ("BL", "EL")}
    for layer in gop_paths:
        (gop_dir / layer).mkdir(parents=True)
    serving.encode_gop(i_net, v_net, [f[0] for f in frames],
                       [f[1] for f in frames], GOP, gop_paths["BL"],
                       gop_paths["EL"], hw_bl, hw_el)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, gop_bits = serving.encode_gop(
        i_net, v_net, [f[0] for f in frames], [f[1] for f in frames], GOP,
        gop_paths["BL"], gop_paths["EL"], hw_bl, hw_el)
    torch.cuda.synchronize()
    gop_s = time.perf_counter() - t0
    cli_bins = _bins(d / "bins_bf16" / "seq1" / "0" / "x2")
    if _bins(gop_dir) != cli_bins:
        raise AssertionError("encode_gop's bins differ from phase 14's CLI "
                             "bins")
    log(f"  (c) encode_gop, bf16, {SERVE_GOP_FRAMES} frames (I P P): bins "
        f"byte-equal to phase 14's CLI; {gop_s:.3f} s "
        f"({gop_s / SERVE_GOP_FRAMES:.4f} s/frame, encode only)")
    del i_net, v_net, frames

    # (d) the staged frame: the bench twin, then one frame against fused
    log(f"# serving: (d) lssvc_tpu_torch.bench --staged at 1080p, bf16")
    staged = {}
    for name, kw in (("staged", dict(staged=True)),
                     ("staged_batch2", dict(batch=2))):
        r = bench.bench_chain(EL_HW, k=K, mode="bf16", device=dev, **kw)
        if not (r["staged"] and r["frames"] == 2 and math.isfinite(r["bits"])):
            raise AssertionError(f"{name}: {r}")
        staged[name] = r
        log(f"  {name}: {r['s_per_frame']:.4f} s/frame (batch {r['batch']}, "
            f"{r['fps']:.3f} frames/s), peak {r['peak_gib']:.2f} GiB")
    fused = modes["bf16"]
    log(f"  fused bf16 (phase 11): {fused['s_per_frame']:.4f} s/frame, peak "
        f"{fused['peak_gib']:.2f} GiB")
    model = LSSVC(init_lssvc(torch.Generator().manual_seed(0)), device=dev,
                  od_offset_cap=OD_OFFSET_CAP_SERVING, precision="bf16")
    model.set_scale_information(2.0, EL_HW, (0, 0, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(16)

    def uni(*shape):
        return torch.rand((1, *shape), generator=gen, device=dev)

    args = (uni(*BL_HW, 3), uni(*EL_HW, 3), uni(*BL_HW, 3), uni(*EL_HW, 3),
            uni(*BL_HW, 64), uni(*EL_HW, 48))
    ref = model.forward_one_frame(*args)
    staged_counts = {}
    with counted(staged_counts):
        out3 = model.forward_one_frame_staged3(*args)
    out2 = model.forward_one_frame_staged(*args)
    for name, out in (("four-stage", out3), ("two-stage", out2)):
        for k, v in out["dpb"].items():
            if not torch.equal(v, ref["dpb"][k]):
                raise AssertionError(f"{name} frame: {k} differs from the "
                                     "fused frame's")
        if not torch.equal(out["bit_bl"], ref["bit_bl"]):
            raise AssertionError(f"{name} frame: bit_bl differs")
        rel = abs(float(out["bit_el"]) / float(ref["bit_el"]) - 1)
        if rel > 1e-6:
            raise AssertionError(f"{name} frame: bit_el off by {rel:.2e}")
    if staged_counts != {"flow_warp": 14, "flow_warp_packed": 0,
                         "grouped_warp": 1, "grouped_warp_packed": 0}:
        raise AssertionError(f"four-stage frame counts {staged_counts}")
    log(f"  one 1080p bf16 frame: four-stage and two-stage DPB bit-equal to "
        f"the fused frame's; four-stage launches {staged_counts}")
    del model, ref, out3, out2, args

    # (e) the CLI with two models at --worker 1 and --worker 2
    log(f"# serving: (e) lssvc_tpu_torch.test, two copies of phase 8's video "
        f"checkpoint, {SERVE_GOP_FRAMES} frames, --worker 1 and --worker 2")
    copies = [d / "worker" / tag / "video.pth" for tag in ("a", "b")]
    for path in copies:
        path.parent.mkdir(parents=True)
        path.write_bytes(Path(video).read_bytes())
    art = d / "artifacts"
    save = [arg for a in runner.ARTIFACTS
            for arg in (f"--save_{a}", "1", f"--{a}_path", str(art / a))]
    workers = {}
    for n in (1, 2):
        argv = ["--test_config", str(cfg), "--i_frame_model_path",
                str(intra), str(intra), "--model_path", *map(str, copies),
                "--output_path", str(d / f"out_worker{n}"), "--ratios", "x2",
                "--force_frame_num", str(SERVE_GOP_FRAMES), "--worker",
                str(n)] + (save if n == 2 else [])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with SpanTimer() as spans:
            t0 = time.perf_counter()
            results = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = spans.busy_s()
        workers[n] = {"wall_s": wall, "busy_s": busy,
                      "idle_share": 1 - busy / wall,
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2 ** 30, "results": results}
        log(f"  --worker {n}: {wall:.2f} s wall for 2 sequences of "
            f"{SERVE_GOP_FRAMES} frames, models' device spans {busy:.2f} s, "
            f"idle share {1 - busy / wall:.3f}, peak "
            f"{workers[n]['peak_mem_gib']:.2f} GiB")
    _same_results(workers[2].pop("results"), workers[1].pop("results"))
    pngs = []
    for model_idx in (0, 1):
        roots = {a: art / f"{a}_IntraNoAR_LSSVC" / "seq1" / str(model_idx)
                 / "x2" for a in runner.ARTIFACTS}
        for i in range(SERVE_GOP_FRAMES):
            pngs += [(roots["decoded_frame"] / layer / f"{i}.png",
                      hw) for layer, hw in (("BL", (GOP_HW[0] // 2,
                                                    GOP_HW[1] // 2)),
                                            ("EL", GOP_HW))]
            if i % GOP:
                pngs += [(roots["decoded_mv"] / f"{i}.png", GOP_EL_HW),
                         (roots["warp_frame"] / f"{i}.png", GOP_HW),
                         (roots["decoded_context"] / f"{i}.png", GOP_EL_HW)]
    for path, hw in pngs:
        img = read_png(path)
        if img.shape[:2] != tuple(hw):
            raise AssertionError(f"{path}: {img.shape}, expected {hw}")
    n_png = sum(1 for _ in art.rglob("*.png"))
    if n_png != len(pngs):
        raise AssertionError(f"{n_png} PNGs written, {len(pngs)} expected")
    log(f"  --worker 2 equals --worker 1 (NaN equal to NaN); {len(pngs)} "
        f"PNGs of the JAX package's layout written and parsed")

    out = {"serving": {
        "streambench": dict(res, launches=pipe_counts),
        "encode_gop": {"frames": SERVE_GOP_FRAMES, "precision": "bf16",
                       "seconds": gop_s, "s_per_frame": gop_s
                       / SERVE_GOP_FRAMES, "bits": gop_bits,
                       "bins_equal_phase14_cli": True},
        "staged": {k: {f: r[f] for f in ("s_per_frame", "fps", "batch",
                                         "frames", "peak_gib", "bits")}
                   for k, r in staged.items()},
        "fused_bf16_phase11": {f: fused[f] for f in ("s_per_frame", "fps",
                                                     "peak_gib")},
        "staged_frame_launches": staged_counts,
        "workers": workers,
        "seconds": time.perf_counter() - t_phase}}
    log(json.dumps(out))
    return ({k: v / SERVE_FRAMES for k, v in pipe_counts.items()},
            staged_counts)


# phase 17: the evaluation side.  RDO runs: (precision, iteration cap,
# lambdas); the caps only bound this run (the CLI's default is 3000)
EVAL_RDO = (("fp32", 3, (0.01,)), ("bf16", 20, (0.0018, 0.0035, 0.0067,
                                                0.013)))
CHENG_N, CHENG_STREAM_HW = 192, (256, 256)


def rdo_run(dev, d, cfg, intra, video, precision, max_iter, lmbdas):
    """(a) of phase 17 in one precision: the CLI in process on the first
    frame of phase 8's sequence, all-intra, latent RDO with `max_iter`
    set in each task, one checkpoint entry a lambda; then the first run's
    bins decoded in a fresh subprocess.  Returns the bf16 FL JSON path."""
    out, bins = d / f"out_rdo_{precision}", d / f"bins_rdo_{precision}"
    tasks, pictures = [], {"x_hat_bl": [], "x_hat_el": []}
    real_build, real_copy = cli.build_tasks, runner.HostCopy

    def capped(args, config):
        for t in real_build(args, config):
            t["intra_rdo_opt"] = dict(t["intra_rdo_opt"], max_iter=max_iter,
                                      trace=[])
            tasks.append(t)
        return tasks

    def recording(tensors):
        for k in pictures:
            pictures[k].append(yuv_frame(tensors[k], (0, 0, 0, 0)))
        return real_copy(tensors)

    cli.build_tasks, runner.HostCopy = capped, recording
    t0 = time.perf_counter()
    try:
        results = cli.main(
            ["--test_config", str(cfg), "--i_frame_model_path",
             *[str(intra)] * len(lmbdas), "--force_intra", "1",
             "--force_frame_num", "1", "--intra_rdo", "--intra_lmbda",
             *[str(v) for v in lmbdas], "--write_stream", "1",
             "--stream_path", str(bins), "--output_path", str(out),
             "--ratios", "x2", "--precision", precision])
    finally:
        cli.build_tasks, runner.HostCopy = real_build, real_copy
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    pixels = {"BL": GOP_HW[0] * GOP_HW[1] // 4, "EL": GOP_HW[0] * GOP_HW[1]}
    for task, (res_bl, res_el, _) in zip(tasks, results):
        trace = task["intra_rdo_opt"]["trace"]
        losses, stamps = [t[0] for t in trace], [t[1] for t in trace]
        if not (len(trace) == max_iter and all(map(math.isfinite, losses))):
            raise AssertionError(f"RDO {precision}: {len(trace)} iterations "
                                 f"(cap {max_iter}), losses {losses}")
        folder = bins / "seq1" / str(task["model_idx"]) / "x2"
        row = {"precision": precision,
               "lmbda": task["intra_rdo_opt"]["lmbda"],
               "max_iter_cap": max_iter, "iterations": len(trace),
               "ms_per_iteration": (stamps[-1] - stamps[0]) * 1e3
               / (len(stamps) - 1),
               "rd_loss_start": losses[0], "rd_loss_best": min(losses)}
        for layer, res in (("BL", res_bl), ("EL", res_el)):
            bits = 8 * (folder / layer / "0.bin").stat().st_size
            if abs(bits - res["ave_i_frame_bpp"] * pixels[layer]) > 1e-6 * bits:
                raise AssertionError(f"RDO {precision} {layer}: JSON bits "
                                     "differ from the bin's")
            row[f"{layer}_bits"] = bits
            row[f"{layer}_rgb_psnr"] = res["ave_i_frame_rgb_psnr"]
            if not math.isfinite(res["ave_i_frame_rgb_psnr"]):
                raise AssertionError(f"RDO {precision} {layer}: PSNR")
        log("  " + json.dumps(row))
    yuv = {layer: d / f"rdo_{precision}_{layer}.yuv" for layer in ("el", "bl")}
    decode_s = _subprocess(
        [sys.executable, "-m", "lssvc_tpu_torch.decode", "--bin_dir",
         str(bins / "seq1" / "0" / "x2"), "--i_frame_model_path", str(intra),
         "--model_path", str(video), "--height", str(GOP_HW[0]), "--width",
         str(GOP_HW[1]), "--ratio", "x2", "--gop", "1", "--frame_num", "1",
         "--precision", precision, "--yuv_out", str(yuv["el"]),
         "--yuv_out_bl", str(yuv["bl"])], f"the {precision} RDO decode")
    for layer, path in yuv.items():
        if path.read_bytes() != pictures[f"x_hat_{layer}"][0]:
            raise AssertionError(f"RDO {precision}: decoded {layer.upper()} "
                                 "YUV differs from the encoder's picture")
    log(f"  {precision}: CLI in process {run_s:.2f} s for {len(tasks)} "
        f"I-frame(s); decode subprocess {decode_s:.2f} s, EL and BL YUV "
        "byte-equal to the encoder's")
    return out / "x2_FL.json"


def stream_against_estimate(model, x, enc):
    """Each latent's stream bits against its estimate, {"y", "z"} each:
    z is coded with the EntropyBottleneck's own CDFs, so within 2% and 64
    bits; y's coder rounds each scale up to the next table row (the
    reference's +1 index bias), so with random weights it codes below the
    estimate (0.835-0.874 of it on the CPU at N=32 and N=192): never over
    1% and 64 bits above it, nor under 75% of it."""
    lik = model.forward(x)["likelihoods"]
    est = {k: float(-torch.log2(v.float()).sum()) for k, v in lik.items()}
    real = {"y": 8 * len(enc["strings"][0][0]),
            "z": 8 * len(enc["strings"][1][0])}
    if not (abs(real["z"] - est["z"]) <= 0.02 * est["z"] + 64
            and 0.75 * est["y"] <= real["y"] <= 1.01 * est["y"] + 64):
        raise AssertionError(f"Cheng2020 stream bits {real}, estimated {est}")
    return real, est


def cheng_run(dev, cfg):
    """(b) of phase 17: Cheng2020Anchor at N=192."""
    params = init_cheng2020(torch.Generator().manual_seed(3), CHENG_N)
    config = json.loads(Path(cfg).read_text())["synthetic"]
    pad_info = get_interlayer_padding(H_HR=GOP_HW[0], W_HR=GOP_HW[1],
                                      ratio=2.0)
    reader = YUVReader(str(Path(config["base_path"]) / "seq1" / "x1.yuv"),
                       GOP_HW[1], GOP_HW[0])
    _, x, _ = runner.layer_inputs(*reader.read_one_frame(), pad_info, dev)
    reader.close()
    row = {"N": CHENG_N, "forward_hw": list(x.shape[1:3])}
    for precision in ("bf16", "fp32"):  # fp32's model codes the stream
        model = Cheng2020Anchor(params, device=dev, precision=precision)
        bits = float(model.forward(x)["bit"])
        if not math.isfinite(bits):
            raise AssertionError(f"Cheng2020 {precision} bits {bits}")
        row[f"forward_{precision}_bits"] = bits
        row[f"forward_{precision}_ms"] = time_ms(lambda: model.forward(x),
                                                 2, 1)
    crop = x[:, :CHENG_STREAM_HW[0], :CHENG_STREAM_HW[1]].contiguous()
    model.update(force=True)
    t0 = time.perf_counter()
    enc = model.compress(x=crop)
    t1 = time.perf_counter()
    dec = model.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not np.array_equal(dec["y_hat"].cpu().numpy(), enc["y_hat"]):
        raise AssertionError("Cheng2020: decoded y_hat differs from the "
                             "encoder's")
    real, est = stream_against_estimate(model, crop, enc)
    row.update({"stream_hw": list(CHENG_STREAM_HW),
                "latent_pixels": int(enc["y_hat"].shape[1]
                                     * enc["y_hat"].shape[2]),
                "encode_s": t1 - t0, "decode_s": t2 - t1,
                "stream_bits": real, "estimated_bits": est,
                "y_hat_bit_equal": True})
    log("  " + json.dumps(row))


def phase_evaluation(dev, d, cfg, intra, video):
    """Phase 17: latent RDO, Cheng2020Anchor and the RD comparison."""
    log("# evaluation side: --intra_rdo at 1080p (iterations capped for "
        "this run only), Cheng2020Anchor at N=192, compare_rd")
    t0 = time.perf_counter()
    fl = {p: rdo_run(dev, d, cfg, intra, video, p, cap, lmbdas)
          for p, cap, lmbdas in EVAL_RDO}
    cheng_run(dev, cfg)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        status = compare_rd.main(["--results", f"A={fl['bf16']}",
                                  f"B={fl['bf16']}"])
    rows = [ln.split() for ln in buf.getvalue().splitlines() if "| mean" in ln]
    if status != 0 or rows != [["B", "synthetic:", "+0.0", "|", "mean",
                                "+0.0"]]:
        raise AssertionError(f"compare_rd against itself: {buf.getvalue()}")
    points = compare_rd.weighted_class_points(
        compare_rd.load_results(fl["bf16"]))["synthetic"]
    ra, pa = zip(*points)
    if len(points) != 4 or abs(compare_rd.bd_rate(ra, pa, ra, pa)) > 1e-9:
        raise AssertionError(f"BD-rate of {points} against itself")
    log(f"  compare_rd on the bf16 FL results against themselves: BD-rate "
        f"+0.0; the rate points {json.dumps(points)}")
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 18: training

TRAIN_CROP = 256
GRAD_SOURCE = "lssvc_tpu_torch/csrc/warp_grad.cu"
GRAD_FLOW_REPLACES = (
    "none: the XLA gradient of lssvc_tpu/ops/warp.py:49 (flow_warp) that "
    "JAX's train step takes (lssvc_tpu/ops/warp_pallas.py:1262)")
GRAD_GROUPED_REPLACES = (
    "none: the XLA gradient of lssvc_tpu/ops/warp_pallas.py:1372-1378 "
    "(_slow_eager, through lssvc_tpu/ops/warp.py:143 flow_warp_grouped) "
    "that JAX's train step takes")
# the 1080p P-frame's warps whose backward is timed: the EL pair and the
# grouped warp (PERF.md's rows 1 and 3)
GRAD_TIMED = [("flow_warp_backward", (1, *EL_HW, 3, 48)),
              ("grouped_warp_backward", (1, *EL_HW, 48, 32, 16))]


class GradRecorder:
    """Stands in for the backward kernels' library and records each launch:
    flow_warp_backward ((n, h, w, ca, cb), dtype code, (a, b, flow) taking
    a gradient); grouped_warp_backward ((n, h, w, c_src, go, group_num),
    dtype code, (x, flow_x, flow_y, mask) taking a gradient)."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def lssvc_flow_warp_backward(self, *args):
        self.calls.append(("flow_warp_backward",
                           (*args[10:13], args[3], args[7]), args[13],
                           (args[2] != 0, args[6] != 0, args[9] != 0)))
        return self.lib.lssvc_flow_warp_backward(*args)

    def lssvc_grouped_warp_backward(self, *args):
        self.calls.append(("grouped_warp_backward", tuple(args[9:15]),
                           args[15], tuple(a != 0 for a in args[5:9])))
        return self.lib.lssvc_grouped_warp_backward(*args)

    def lssvc_f32_to_bf16(self, *args):
        return self.lib.lssvc_f32_to_bf16(*args)


def _grad_counts():
    return {"flow_warp": wk.flow_warp.launches,
            "flow_warp_backward": wk.flow_warp_backward.launches,
            "grouped_warp": wk.grouped_warp.launches,
            "grouped_warp_backward": wk.grouped_warp_backward.launches}


def _reset_grad_counts():
    _reset_counts()
    for fn in (wk.flow_warp_backward, wk.grouped_warp_backward):
        fn.launches = fn.fixed_launches = 0


def _fixed_counts():
    return {"flow_warp_backward": wk.flow_warp_backward.fixed_launches,
            "grouped_warp_backward": wk.grouped_warp_backward.fixed_launches}


def same_bits(a, b) -> bool:
    """Whether two tensors (or None) hold the same bits, NaNs included."""
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def train_batch(loss, crop, nb, dev, seed=0, frames=3):
    """A batch of the trainer's synthetic data on `dev`."""
    return trainer.make_batch(trainer.SyntheticPairs(crop, seed), loss, nb,
                              frames, dev)[0]


def check_grads(name, labels, got, ref, dtype):
    """Each gradient of `got` against `ref` (None meets None), NaN meeting
    NaN; f32: max |err| <= 1e-5 max|ref|; bf16: relative RMS <= 1e-2.
    Returns the largest max |err|."""
    worst = 0.0
    for label, g, r in zip(labels, got, ref):
        if (g is None) != (r is None):
            raise AssertionError(f"{name} {label}: one side is None")
        if g is None:
            continue
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name} {label}: {tuple(g.shape)} {g.dtype}"
                                 f" against {tuple(r.shape)} {r.dtype}")
        g, r = g.float(), r.float()
        nan_g, nan_r = torch.isnan(g), torch.isnan(r)
        if not torch.equal(nan_g, nan_r):
            raise AssertionError(f"{name} {label}: NaN positions differ")
        g, r = g.masked_fill(nan_g, 0), r.masked_fill(nan_r, 0)
        err = float((g - r).abs().max())
        top = float(r.abs().max())
        if dtype == torch.float32:
            ok = err <= 1e-5 * top
        else:
            ok = _rel_rms(g, r) <= 1e-2
        if not ok:
            raise AssertionError(f"{name} {label}: max |err| {err:.3g} at "
                                 f"max |ref| {top:.3g}, relative RMS "
                                 f"{_rel_rms(g, r):.3g}")
        worst = max(worst, err)
    return worst


def _grad_inputs(gen, shape, dtype, kind, flows="random"):
    """Sources, flows and output gradients of one backward launch shape.
    The kernels' scatter paths: "smooth2" and "smooth12" are smooth fields
    of that amplitude in px (their tiles' boxes fit), "mixed" the left half
    of each image smooth and the right half random past the borders (one
    launch, both paths), "smooth40" (grouped) one 12 px field plus each
    unit's own 40 px smooth offset."""
    if kind == "flow_warp_backward":
        n, h, w, ca, cb = shape
        srcs = [uniform(gen, (n, h, w, c), 0, 1).to(dtype)
                for c in (ca, cb) if c]
        fshape = (n, h, w, 2)
    else:
        n, h, w, c_src, go, gn = shape
        srcs = [uniform(gen, (n, h, w, c_src), 0, 1).to(dtype)]
        fshape = (n, h, w, 2 * go)
    if flows == "random":
        flow = uniform(gen, fshape, -6, 6)
    elif flows in ("smooth2", "smooth12"):
        flow = smooth_field(gen, fshape, float(flows[6:]))
    elif flows == "mixed":
        flow = smooth_field(gen, fshape, 2.0)
        flow[:, :, w // 2:] = uniform(gen, (n, h, w - w // 2, fshape[3]),
                                      -3 * w, 3 * w)
    elif flows == "smooth40":
        base = smooth_field(gen, (n, h, w, 2), 12.0)
        flow = torch.cat([base[..., i:i + 1] + smooth_field(
            gen, (n, h, w, go), 40.0) for i in range(2)], -1)
    elif flows == "zero":
        flow = torch.zeros(fshape, device=gen.device)
    elif flows == "integer":  # many samples exactly on a border
        flow = torch.round(uniform(gen, fshape, -w / 2, w / 2))
    elif flows == "past":
        flow = uniform(gen, fshape, -3 * w, 3 * w)
    else:  # "nan": a tenth of the flows NaN
        flow = uniform(gen, fshape, -6, 6)
        flow[uniform(gen, fshape, 0, 1) < 0.1] = float("nan")
    if kind == "flow_warp_backward":
        grads = [uniform(gen, s.shape, -1, 1).to(dtype) for s in srcs]
        return srcs, flow, grads
    fx, fy = flow[..., :go].contiguous(), flow[..., go:].contiguous()
    mask = uniform(gen, (n, h, w, go), 0, 1)
    grad = uniform(gen, (n, h, w, go * (c_src // gn)), -1, 1).to(dtype)
    return srcs, (fx, fy, mask), [grad]


def _kernel_grads(kind, shape, srcs, flow, grads):
    """One launch of the backward kernel (its fixed-order variant under
    the deterministic flag): flow_warp_backward's (grad_flow, grad_a,
    grad_b), grouped_warp_backward's (grad_x, grad_flow_x, grad_flow_y,
    grad_mask)."""
    if kind == "flow_warp_backward":
        b = srcs[1] if len(srcs) > 1 else None
        gb = grads[1] if len(grads) > 1 else None
        return wk.flow_warp_backward(flow, srcs[0], grads[0], b, gb)
    return wk.grouped_warp_backward(srcs[0], *flow, shape[5], grads[0])


def rounded_once(name, got, ref32):
    """A bf16 source gradient against the f32 kernel's on the same values:
    within half a bf16 ulp (2^-8 relative) plus 1e-5 max|ref| for the f32
    sums' order, as one rounding of an f32 sum gives."""
    g, r = got.float(), ref32
    nan = torch.isnan(r)
    if not torch.equal(torch.isnan(g), nan):
        raise AssertionError(f"{name}: NaN positions differ")
    g, r = g.masked_fill(nan, 0), r.masked_fill(nan, 0)
    slack = 2.0 ** -8 * r.abs() + 1e-5 * float(r.abs().max())
    if bool(((g - r).abs() > slack).any()):
        raise AssertionError(f"{name}: the bf16 gradient is not the f32 sum "
                             f"rounded once: max |err| "
                             f"{float((g - r).abs().max()):.3g}")


def grad_case(kind, shape, dtype, gen, flows="random"):
    """One backward launch of the kernel against autograd through the plain
    warp on the same card tensors; the flow and mask gradients bit-equal
    across two launches; a bf16 source gradient the f32 kernel's on the
    same values rounded once.  Returns (max |err|, the inputs)."""
    srcs, flow, grads = _grad_inputs(gen, shape, dtype, kind, flows)
    got = _kernel_grads(kind, shape, srcs, flow, grads)
    again = _kernel_grads(kind, shape, srcs, flow, grads)
    if kind == "flow_warp_backward":
        b = srcs[1] if len(srcs) > 1 else None
        gb = grads[1] if len(grads) > 1 else None
        ref = wk.flow_warp_backward_plain(flow, srcs[0], grads[0], b, gb)
        # (grad_flow, grad_a, grad_b); the flow's gradient uses no atomics
        same, src_grads = [(got[0], again[0])], got[1:]
    else:
        ref = wk.grouped_warp_backward_plain(srcs[0], *flow, shape[5],
                                             grads[0])
        same, src_grads = list(zip(got[1:], again[1:])), got[:1]
    for g1, g2 in same:
        if not torch.equal(torch.nan_to_num(g1), torch.nan_to_num(g2)):
            raise AssertionError(f"{kind} {shape}: the flow or mask "
                                 "gradient differs between two launches")
    labels = (("grad_flow", "grad_a", "grad_b")
              if kind == "flow_warp_backward" else
              ("grad_x", "grad_flow_x", "grad_flow_y", "grad_mask"))
    err = check_grads(f"{kind} {shape} {flows}", labels, got, ref, dtype)
    if dtype == torch.bfloat16:
        got32 = _kernel_grads(kind, shape, [s.float() for s in srcs], flow,
                              [g.float() for g in grads])
        ref32 = got32[1:] if kind == "flow_warp_backward" else got32[:1]
        for g16, g32 in zip(src_grads, ref32):
            if g16 is not None:
                rounded_once(f"{kind} {shape} {flows}", g16, g32)
    return err, (srcs, flow, grads)


def fixed_case(kind, shape, dtype, gen, flows="random"):
    """One launch of the backward kernel's fixed-order variant: its source
    gradients bit-equal to the plain version's
    (`flow_warp_backward_fixed_plain` / `grouped_warp_backward_fixed_plain`:
    each tap's value as round(v 2^s) summed in int64, rounded once), and
    every gradient within the default path's bounds of plain autograd
    through the plain warp (the check of the scale and the sums at this
    shape that the plain version, sharing them, cannot give); a second
    launch bit-equal to the first (every gradient, NaNs included).
    Returns max |err| against plain autograd."""
    srcs, flow, grads = _grad_inputs(gen, shape, dtype, kind, flows)
    before = _fixed_counts()[kind]
    with deterministic():
        got = _kernel_grads(kind, shape, srcs, flow, grads)
        again = _kernel_grads(kind, shape, srcs, flow, grads)
    if _fixed_counts()[kind] - before != 2:
        raise AssertionError(f"{kind} {shape}: the fixed-order variant did "
                             "not launch")
    for g1, g2 in zip(got, again):
        if not same_bits(g1, g2):
            raise AssertionError(f"fixed-order {kind} {shape} {flows} "
                                 f"{dtype}: two launches differ")
    if kind == "flow_warp_backward":
        b = srcs[1] if len(srcs) > 1 else None
        gb = grads[1] if len(grads) > 1 else None
        ref = wk.flow_warp_backward_fixed_plain(flow, srcs[0], grads[0], b,
                                                gb)
        auto = wk.flow_warp_backward_plain(flow, srcs[0], grads[0], b, gb)
        labels, src = ("grad_flow", "grad_a", "grad_b"), (1, 2)
    else:
        ref = wk.grouped_warp_backward_fixed_plain(srcs[0], *flow, shape[5],
                                                   grads[0])
        auto = wk.grouped_warp_backward_plain(srcs[0], *flow, shape[5],
                                              grads[0])
        labels = ("grad_x", "grad_flow_x", "grad_flow_y", "grad_mask")
        src = (0,)
    for i in src:
        if not same_bits(got[i], ref[i]):
            raise AssertionError(f"fixed-order {kind} {shape} {flows} "
                                 f"{dtype}: {labels[i]} is not the plain "
                                 "version's bits")
    return check_grads(f"fixed-order {kind} {shape} {flows}", labels, got,
                       auto, dtype)


def train_launches(dev):
    """Phase 18 (b): one fp32 `pair` train step at crop 256 and one
    `cascade` chain of T=3 with no warm step, the counts set to 0 just
    before each and read just after.  A backward launch for every forward
    warp whose inputs take a gradient: the pair step 12 of its 14
    flow_warp launches (not SpyNet's first level in either layer, which
    warps an input frame by a zero flow) and its grouped_warp; the chain
    12 + 14 (its second frame warps the first's reconstruction).  Returns
    the counts and the pair step's backward launch shapes."""
    params = {k: v.to(dev) for k, v in
              init_lssvc(torch.Generator().manual_seed(0)).items()}
    opt = ptrain.Adam(1e-4)
    counts, shapes = {}, set()
    for loss, want in (("pair", (14, 12, 1, 1)), ("cascade", (28, 26, 2, 2))):
        batch = train_batch(loss, TRAIN_CROP, 1, dev, frames=3)
        step = ptrain.make_train_step(opt, 0.01, (TRAIN_CROP, TRAIN_CROP),
                                      loss=loss, precision="fp32")
        rec = GradRecorder(wk._grad_lib())
        real = wk._grad_lib
        wk._grad_lib = lambda: rec
        try:
            torch.cuda.synchronize()
            _reset_grad_counts()
            _, _, metrics = step(params, opt.init(params), batch)
            torch.cuda.synchronize()
        finally:
            wk._grad_lib = real
        got = _grad_counts()
        counts[loss] = got
        log(f"  {loss} step at crop {TRAIN_CROP}: launches {got}, loss "
            f"{float(metrics['loss']):.6g}")
        if tuple(got.values()) != want:
            raise AssertionError(f"{loss}: launches {got}, expected "
                                 f"{dict(zip(got, want))}")
        if loss == "pair":
            shapes = {(k, s) for k, s, _, _ in rec.calls}
            needs = [nd for k, _, _, nd in rec.calls
                     if k == "flow_warp_backward"]
            log(f"  pair step backward launches (a, b, flow take a "
                f"gradient): {needs}")
    return counts, sorted(shapes)


def grad_kernels(dev, train_shapes, frame_calls):
    """Phase 18 (a): both backward kernels against autograd through the
    plain warps, f32 and bf16, at the pair train step's launch shapes, at
    the 1080p P-frame's warp shapes (`frame_calls`) and at edge cases:
    zero flows and integer flows landing on the borders (the clip's ties),
    flows far past the borders, NaN flows, batch 2 and unaligned widths."""
    gen = torch.Generator(device=dev).manual_seed(18)
    frame = set()
    for kind, shape, _ in frame_calls:
        if kind == "flow_warp":
            frame.add(("flow_warp_backward", (*shape, 0)))
        elif kind == "flow_warp_pair":
            frame.add(("flow_warp_backward", shape))
        else:
            frame.add(("grouped_warp_backward", shape))
    edges = [(k, s, f) for f in ("zero", "integer", "past", "nan")
             for k, s in (("flow_warp_backward", (2, 19, 37, 3, 0)),
                          ("flow_warp_backward", (2, 19, 37, 3, 48)),
                          ("flow_warp_backward", (1, 33, 65, 5, 0)),
                          ("grouped_warp_backward", (2, 19, 37, 48, 32, 16)),
                          ("grouped_warp_backward", (1, 17, 31, 12, 8, 4)))]
    # the scatter paths: tiles cut unevenly and whole, boxes that fit, one
    # launch with both paths, the trainer's 40 px offsets
    tiled = [("flow_warp_backward", (2, 19, 37, 3, 48)),
             ("flow_warp_backward", (1, 33, 65, 3, 48)),
             ("flow_warp_backward", (1, 64, 64, 3, 48)),
             ("grouped_warp_backward", (2, 19, 37, 48, 32, 16)),
             ("grouped_warp_backward", (1, 33, 65, 48, 32, 16)),
             ("grouped_warp_backward", (1, 64, 64, 48, 32, 16)),
             ("grouped_warp_backward", (1, 33, 65, 12, 8, 4))]
    paths = ([(k, s, f) for f in ("smooth2", "smooth12", "mixed")
              for k, s in tiled]
             + [(k, s, "smooth40") for k, s in tiled
                if k == "grouped_warp_backward"]
             + [("flow_warp_backward", (1, *EL_HW, 3, 48), "smooth12"),
                ("grouped_warp_backward", (1, *EL_HW, 48, 32, 16),
                 "smooth40")])
    cases = ([(k, s, "random") for k, s in train_shapes]
             + [(k, s, "random") for k, s in sorted(frame)] + edges + paths)
    # the fixed-order variant at the train step's shapes, the 1080p
    # frame's and the edge cases, and on its scatter paths (boxes that fit,
    # one launch with tiles of both paths, the 40 px offsets, the 1080p
    # pair and grouped warp on smooth flows)
    fixed_cases = ([(k, s, "random") for k, s in train_shapes]
                   + [(k, s, "random") for k, s in sorted(frame)] + edges
                   + paths)
    t0 = time.perf_counter()
    worst = {"flow_warp_backward": 0.0, "grouped_warp_backward": 0.0}
    fixed_worst = dict(worst)
    for dtype in (torch.float32, torch.bfloat16):
        for kind, shape, flows in cases:
            err, _ = grad_case(kind, shape, dtype, gen, flows)
            if dtype == torch.float32:
                worst[kind] = max(worst[kind], err)
        log(f"  {len(cases)} backward cases in {dtype}: against plain "
            "autograd within tolerance, flow and mask gradients "
            "bit-equal across two launches"
            + (", source gradients rounded once from f32"
               if dtype == torch.bfloat16 else "")
            + f" ({time.perf_counter() - t0:.1f} s in)")
        # the fixed-order variant (torch.use_deterministic_algorithms)
        for kind, shape, flows in fixed_cases:
            err = fixed_case(kind, shape, dtype, gen, flows)
            if dtype == torch.float32:
                fixed_worst[kind] = max(fixed_worst[kind], err)
        log(f"  {len(fixed_cases)} of them through the fixed-order variant "
            f"in {dtype}: source gradients bit-equal to the plain fixed-order "
            "version, every gradient within the same tolerance of plain "
            "autograd and bit-equal across two launches; f32 max |err| "
            f"{fixed_worst} "
            f"({time.perf_counter() - t0:.1f} s in)")
    return worst, fixed_worst


def grad_times(dev):
    """Phase 18 (e): `tools/warp_bench.py --backward`: each backward
    kernel's time at the 1080p P-frame's EL pair and grouped warp and at
    the training crop's, f32 and bf16, smooth and random flows, beside its
    byte bound, the wrapper's zero-fill and rounding passes, the plain
    autograd's backward and, for flow_warp, F.grid_sample's backward.
    Returns {(kind, shape, dtype, flows): row}."""
    out = {}
    for row in warp_bench.backward_run(dev):
        key = (row["kind"], tuple(row["shape"]), row["dtype"], row["flows"])
        out[key] = row
        lib = ("" if row["library_ms"] is None else
               f", F.grid_sample backward {row['library_ms']:.4f} ms")
        log(f"  {key[0]} {key[1]} {key[2]} {key[3]}: {row['ms']:.4f} ms "
            f"a call, the kernel {row['kernel_ms']:.4f} ms (bound "
            f"{row['bound_ms']:.4f} ms, {row['bound_by']}; "
            f"{row['share_of_bound']:.3f} of it), zero-fill and rounding "
            f"{row['outside_ms']:.4f} ms, plain autograd "
            f"{row['plain_ms']:.4f} ms{lib}; fixed-order variant "
            f"{row['fixed_ms']:.4f} ms a call, "
            f"{row['fixed_kernel_ms']:.4f} ms its C entry point"
            + ("" if row["fixed_library"] is None else
               f", F.grid_sample backward under the deterministic flag: "
               f"{row['fixed_library']}"))
    return out


def train_cpu_vs_card(dev):
    """Phase 18 (c): one fp32 `pair` loss and gradient at crop 128 from the
    same weights and batch on the CPU (plain warps) and the card (the
    kernels), and on the CPU in float64: the loss within 1e-4 relative;
    the whole gradient (all keys as one vector) within 1e-2 relative L2 and
    each key within 5e-2.  At random init many keys' f32 gradients are
    cancelling sums whose last digits are rounding: the CPU's own f32 and
    f64 gradients differ by up to about 1% on a key, which is printed."""
    params = init_lssvc(torch.Generator().manual_seed(0))
    batch = train_batch("pair", 128, 1, torch.device("cpu"), seed=3)
    loss_fn = ptrain.make_loss_fn(0.01, (128, 128), loss="pair")
    got = {}
    for name, where, dtype in (("cpu", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64),
                               ("card", dev, torch.float32)):
        p = {k: v.to(where, dtype) for k, v in params.items()}
        b = {k: v.to(where, dtype) for k, v in batch.items()}
        with precision_scope(Mode("fp32")):
            loss, _, grads = ptrain.value_and_grad(loss_fn, p, b)
        got[name] = (float(loss), {k: v.cpu().double() for k, v in
                                   grads.items()})

    def worst(a, b):
        rel = {k: float((a[k] - r).norm() / r.norm()) if float(r.norm())
               else float(a[k].norm()) for k, r in b.items()}
        key = max(rel, key=rel.get)
        keys = sorted(b)
        whole = float(torch.cat([(a[k] - b[k]).ravel() for k in keys]).norm()
                      / torch.cat([b[k].ravel() for k in keys]).norm())
        return key, rel[key], whole

    (l_cpu, g_cpu), (_, g64), (l_dev, g_dev) = (got["cpu"], got["cpu64"],
                                                got["card"])
    if abs(l_dev - l_cpu) > 1e-4 * abs(l_cpu):
        raise AssertionError(f"loss {l_dev} on the card, {l_cpu} on the CPU")
    key, rel, whole = worst(g_dev, g_cpu)
    key64, rel64, whole64 = worst(g_cpu, g64)
    log(f"  CPU against card, fp32 pair step at 128x128: loss {l_cpu:.8g} /"
        f" {l_dev:.8g}; worst gradient {key} at relative L2 {rel:.3g}, "
        f"the whole gradient {whole:.3g} ({len(g_cpu)} keys); the CPU's f32 "
        f"against its f64: worst {key64} at {rel64:.3g}, whole {whole64:.3g}")
    if whole > 1e-2 or rel > 5e-2:
        raise AssertionError(f"gradient {key}: relative L2 {rel}, whole "
                             f"{whole}")


def _train_cli(argv, what):
    """`python -m lssvc_tpu_torch.train` in this process: (s/step over the
    steps after the first, frames/s, peak GiB, the log)."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        trainer.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    rates = [float(r) for r in re.findall(r"\(([\d.]+) frames/s\)", text)]
    steps = re.findall(r"^step (\d+): loss=([\d.eE+-]+|nan|inf)", text,
                       re.M)
    if len(rates) < 2:
        raise AssertionError(f"{what}: too few log lines:\n{text}")
    fps = float(np.mean(rates[1:]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(float(v)) for _, v in steps):
        raise AssertionError(f"{what}: a loss is not finite:\n{text}")
    return fps, peak, wall, text


def train_cli_runs(d, cfg):
    """Phase 18 (d): the trainer's CLI on its default device at crop 256,
    synthetic data: each stage a few steps (s/step, frames/s, peak GiB),
    `pair` at batch 8, a crash resume, a fixed-batch `pair` run of 20
    steps whose loss must fall, and the saved checkpoints coding the GOP
    path's first 3 frames through the test CLI."""
    out = {}
    base = ["--crop", str(TRAIN_CROP), "--scan-steps", "1", "--log-every",
            "1"]
    runs = [("spynet", ["--stage", "spynet"], 4, 1, 1),
            ("mv", ["--stage", "mv"], 4, 1, 1),
            ("pair", ["--loss", "pair"], 4, 1, 1),
            ("cascade", ["--stage", "cascade", "--frames", "3"], 4, 1, 2),
            ("intra", ["--loss", "intra"], 4, 1, 1),
            ("pair_b8", ["--loss", "pair", "--batch-per-device", "8"], 3, 8,
             1)]
    for name, flags, steps, nb, fpi in runs:
        prefix = d / "train" / name
        fps, peak, wall, text = _train_cli(
            [*base, *flags, "--steps", str(steps), "--save-every", "2",
             "--out", str(prefix)], name)
        final = Path(f"{prefix}_step{steps}.npz")
        if not final.exists() or not Path(
                f"{prefix}_step{steps}.state.npz").exists():
            raise AssertionError(f"{name}: {final} or its state is missing")
        out[name] = {"s_per_step": nb * fpi / fps, "frames_per_s": fps,
                     "peak_gib": peak, "batch": nb, "steps": steps,
                     "wall_s": wall}
        log(f"  train {name}: {nb * fpi / fps:.4f} s/step, {fps:.2f} "
            f"frames/s, peak {peak:.2f} GiB ({steps} steps, batch {nb}, "
            f"{wall:.1f} s with the first step)")
    # a crash resume: the pair run's step-2 state restores the step
    prefix = d / "train" / "pair"
    _, _, _, text = _train_cli(
        [*base, "--loss", "pair", "--steps", "4", "--save-every", "2",
         "--out", str(prefix), "--resume", f"{prefix}_step2.npz"], "resume")
    if "restored optimizer state + step 2" not in text or \
            re.search(r"^step [12]:", text, re.M):
        raise AssertionError(f"resume did not restore step 2:\n{text}")
    log("  crash resume from pair_step2: restored the optimizer state and "
        "step 2, ran steps 3-4")
    # a fixed batch: 20 steps must lower the loss
    params = {k: v.cuda() for k, v in
              init_lssvc(torch.Generator().manual_seed(0)).items()}
    opt = ptrain.Adam(1e-4)
    state = opt.init(params)
    batch = train_batch("pair", TRAIN_CROP, 1, torch.device("cuda"), seed=5)
    step = ptrain.make_train_step(opt, 0.01, (TRAIN_CROP, TRAIN_CROP),
                                  precision="high")
    losses = []
    for _ in range(20):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fixed-batch pair losses {losses}")
    log(f"  fixed-batch pair, 20 steps: loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g}")
    out["fixed_batch_losses"] = [losses[0], losses[-1]]
    # the trained checkpoints code the GOP path's first 3 frames
    cli.main(["--test_config", str(cfg), "--i_frame_model_path",
              str(d / "train" / "intra_step4.npz"), "--model_path",
              str(prefix) + "_step4.npz", "--output_path",
              str(d / "out_trained"), "--ratios", "x2",
              "--force_frame_num", "3"])
    res = json.loads((d / "out_trained" / "x2_FL.json").read_text())
    log(f"  the trained pair checkpoint coded 3 frames through the test "
        f"CLI: {json.dumps(res)[:200]}")
    return out


def training_checks(dev):
    """Phase 18 (b), (a) and (c), which time nothing, in phase 2's window;
    the 1080p P-frame's warp shapes are tools/warp_bench.py's FRAME and
    GROUPED, which phase 4 holds phase 3's launches to.  Returns (b)'s
    launches and (a)'s worst f32 errors of both variants."""
    t0 = time.perf_counter()
    log("# phase 18 (a)-(c): training's untimed checks, in phase 2's window")

    def lap(part):
        log(f"  phase 18 {part}: {time.perf_counter() - t0:.1f} s in")

    counts, train_shapes = train_launches(dev)
    lap("(b)")
    frame_calls = ([(name, shape, 0) for name, shape in warp_bench.FRAME]
                   + [("grouped_warp", warp_bench.GROUPED, 0)])
    worst, fixed_worst = grad_kernels(dev, train_shapes, frame_calls)
    lap("(a)")
    train_cpu_vs_card(dev)
    lap("(c)")
    return counts, worst, fixed_worst


def phase_training(dev, d, cfg, checks):
    """Phase 18 (d) and (e), with (a)-(c)'s results `checks` (see the
    module docstring)."""
    t0 = time.perf_counter()
    log("# phase 18: training")
    counts, worst, fixed_worst = checks
    cli_runs = train_cli_runs(d, cfg)
    log(f"  phase 18 (d): {time.perf_counter() - t0:.1f} s in")
    times = grad_times(dev)
    log(json.dumps({"training": cli_runs, "launches": counts}))
    entries = []
    for name, shape in GRAD_TIMED:
        t = times[(name, shape, "float32", "random")]
        smooth = "smooth40" if name == "grouped_warp_backward" else "smooth"
        entries.append({
            "name": name, "route": "cuda", "source": GRAD_SOURCE,
            "replaces": (GRAD_FLOW_REPLACES if name == "flow_warp_backward"
                         else GRAD_GROUPED_REPLACES),
            "launches": counts["pair"][name], "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": list(shape),
            "cascade_launches": counts["cascade"][name],
            "kernel_ms": t["kernel_ms"],
            "bf16_ms": times[(name, shape, "bfloat16", "random")]["ms"],
            "smooth_ms": times[(name, shape, "float32", "smooth")]["ms"],
            f"{smooth}_ms": times[(name, shape, "float32", smooth)]["ms"],
            "bf16_smooth_ms":
                times[(name, shape, "bfloat16", "smooth")]["ms"],
            "fixed_ms": t["fixed_ms"], "fixed_kernel_ms": t["fixed_kernel_ms"],
            "fixed_smooth_ms":
                times[(name, shape, "float32", "smooth")]["fixed_ms"],
            "fixed_bf16_ms":
                times[(name, shape, "bfloat16", "random")]["fixed_ms"],
            "fixed_kernel_smooth_ms":
                times[(name, shape, "float32", "smooth")]["fixed_kernel_ms"],
            "fixed_max_abs_err": fixed_worst[name],
            "fixed_library": t["fixed_library"],
            "flows": "ms at random flows (+-6 px), the wrapper's call; "
                     "kernel_ms the kernel alone; smooth at 12 px; fixed_* "
                     "the fixed-order variant (deterministic flag), its "
                     "source gradients bit-equal to its plain version, "
                     "fixed_max_abs_err every gradient's against plain "
                     "autograd; "
                     "fixed_library the one PyTorch call under the flag"})
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")
    return entries


# ---------------------------------------------------------------------------
# phase 19: parallelism.  Two ranks share the one card on gloo (NCCL takes
# one card a rank); a world of 1 runs on NCCL.

PAR_HALO = 16  # the pair's smooth 12 px flows stay on the strip branch
PAR_GROUPED_HALO = 56  # 12 px motion + 40 px per-unit offsets
PAR_FLOW_PX, PAR_OFFSET_PX = 12.0, 40.0
PAR_FRAMES = 2  # the spatial forward's chain
PAR_SERVE_FRAMES = 3


def _par_entry(rank, world, store, out, dev, el_hw, bl_hw):
    """A gloo rank on `dev` (cuda:0 for both ranks on the card): (b)-(e) of
    phase 19, its results saved, or its traceback where it failed."""
    import traceback

    import torch.distributed as dist

    from lssvc_tpu_torch.parallel.mesh import make_mesh

    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    group = make_mesh(backend="gloo", device=dev, rank=rank, world=world,
                      init_method=f"file://{store}")
    try:
        torch.save(par_rank(rank, group, torch.device(dev), el_hw, bl_hw),
                   f"{out}{rank}.pt")
    except BaseException:
        Path(f"{out}{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _gloo_cuda_probe(group):
    """Which gloo collectives take CUDA tensors on this build (a probe: the
    port's exchanges stage CUDA tensors through the host by the group's
    backend, whatever this finds)."""
    import torch.distributed as dist

    t = torch.ones(4, device="cuda")
    found = {}
    for name, call in (
            ("all_reduce", lambda: dist.all_reduce(t.clone(), group=group)),
            ("broadcast", lambda: dist.broadcast(t.clone(), 0, group=group)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(t) for _ in range(2)], t, group=group))):
        try:
            call()
            torch.cuda.synchronize()
            found[name] = True
        except Exception as err:  # a probe of the backend, not the path
            found[name] = f"{type(err).__name__}: {str(err)[:80]}"
        dist.barrier(group)
    return found


def _launches():
    return wk.flow_warp.launches, wk.grouped_warp.launches


def par_halo_warps(rank, group, sh, dev, el_hw):
    """(b): the 1080p EL pair and OffsetDiversity's grouped warp on strips,
    each halo below and above the flows' reach, against the whole-frame
    kernel; one launch a call on either branch; rank 0 times the strip
    launch against the whole-frame one."""
    import torch.distributed as dist

    from lssvc_tpu_torch.parallel import spatial

    gen = torch.Generator(device=dev).manual_seed(19)
    n, h, w = 1, *el_hw
    a = uniform(gen, (n, h, w, 3), 0, 1)
    b = uniform(gen, (n, h, w, 48), -1, 1)
    flow = smooth_field(gen, (n, h, w, 2), PAR_FLOW_PX)
    units = (n, h, w, 32)
    base = smooth_field(gen, (n, h, w, 2), PAR_FLOW_PX)
    fx, fy = (base[..., i:i + 1] + smooth_field(gen, units, PAR_OFFSET_PX)
              for i in range(2))
    mask = uniform(gen, units, 0, 1)
    x = uniform(gen, (n, h, w, 48), -1, 1)
    ref_a, ref_b = wk.flow_warp_pair(a, b, flow)
    ref_g = wk.grouped_warp(x, fx, fy, mask, 16)
    out = {"fy_max": [float(flow[..., 1].abs().max()),
                      float(fy.abs().max())]}
    for kind, halo in (("pair", PAR_HALO), ("pair", 8),
                       ("grouped", PAR_GROUPED_HALO), ("grouped", 44)):
        spatial.reset_counts()
        before = _launches()
        if kind == "pair":
            got = spatial.flow_warp_pair_sharded_auto(
                sh.shard(a), sh.shard(b), sh.shard(flow), group, halo=halo)
            refs = (sh.shard(ref_a), sh.shard(ref_b))
        else:
            got = (spatial.grouped_warp_sharded_auto(
                *(sh.shard(t) for t in (x, fx, fy, mask)), 16, group,
                halo=halo),)
            refs = (sh.shard(ref_g),)
        _sync(dev)
        after = _launches()
        errs = [float((g - r).abs().max()) for g, r in zip(got, refs)]
        differ = sum(int((g != r).sum()) for g, r in zip(got, refs))
        which = "flow_warp" if kind == "pair" else "grouped_warp"
        counts = spatial.branch_counts()[which]
        launched = after[0] - before[0] if kind == "pair" else \
            after[1] - before[1]
        out[f"{kind}_halo{halo}"] = {
            "max_abs_err": max(errs), "differing": differ,
            "launches": launched, "branch": counts}
        if max(errs) > 1e-4 or launched != int(dev.type == "cuda") or \
                sum(counts.values()) != 1:
            raise AssertionError(f"{kind} halo {halo}: errors {errs}, "
                                 f"launches {launched}, branches {counts}")
    dist.barrier(group)
    if rank == 0 and dev.type == "cuda":  # the other rank waits
        halo_px = PAR_HALO
        rows = h // 2
        a_pad = a[:, :rows + 2 * halo_px].contiguous()
        b_pad = b[:, :rows + 2 * halo_px].contiguous()
        f_pad = flow[:, :rows + 2 * halo_px].contiguous()
        g_pad = [t[:, :rows + 2 * PAR_GROUPED_HALO].contiguous()
                 for t in (x, fx, fy, mask)]
        out["times"] = {
            "pair_whole_ms": time_ms(lambda: wk.flow_warp_pair(a, b, flow)),
            "pair_strip_ms": time_ms(
                lambda: wk.flow_warp_pair(a_pad, b_pad, f_pad)),
            "grouped_whole_ms": time_ms(
                lambda: wk.grouped_warp(x, fx, fy, mask, 16)),
            "grouped_strip_ms": time_ms(
                lambda: wk.grouped_warp(*g_pad, 16))}
    dist.barrier(group)
    return out


def _clamped(dpb):
    """The DPB the next frame reads: its pictures clamped to [0, 1], as the
    GOP loop feeds them back (harness/runner.py)."""
    return {k: v.clamp(0, 1) if k.startswith("ref_frame") else v
            for k, v in dpb.items()}


def par_frames(rank, group, sh, dev, el_hw, bl_hw):
    """(c): the spatial P-frame forward at full width, K=2 chained frames
    from a random DPB (the pictures fed back clamped, as the GOP loop does:
    a random-init codec's unclamped recons grow chaotic, `tests/
    test_torch_lssvc.py` `test_dpb_chain_three_frames`), fp32, cap 10 px,
    on strips; rank 0 holds it to its own unsharded forward."""
    import torch.distributed as dist

    from lssvc_tpu_torch.models import lssvc as lssvc_model
    from lssvc_tpu_torch.parallel import spatial

    params = {k: v.to(dev) for k, v in
              init_lssvc(torch.Generator().manual_seed(0)).items()}
    gen = torch.Generator(device=dev).manual_seed(20)
    frames = [(uniform(gen, (1, *bl_hw, 3), 0, 1),
               uniform(gen, (1, *el_hw, 3), 0, 1))
              for _ in range(PAR_FRAMES)]
    dpb0 = {"ref_frame_bl": uniform(gen, (1, *bl_hw, 3), 0, 1),
            "ref_frame_el": uniform(gen, (1, *el_hw, 3), 0, 1),
            "ref_feature_bl": uniform(gen, (1, *bl_hw, 64), 0, 1),
            "ref_feature_el": uniform(gen, (1, *el_hw, 48), 0, 1)}
    fwd = spatial.make_spatial_forward(
        group, el_hw, 2.0, (0, 0, 0, 0), kernel_warps=True,
        od_offset_cap=OD_OFFSET_CAP_SERVING)
    dpb = {k: sh.shard(v).contiguous() for k, v in dpb0.items()}
    # a warm-up frame (the chain's first), its counts discarded, each
    # public op's output digested (tools/op_digests.py); it probes each
    # conv shape's route (`ops/strips.py` `conv2d`)
    t0 = time.perf_counter()
    with precision_scope(Mode("fp32")), OpDigests() as digests:
        fwd(params, sh.shard(frames[0][0]), sh.shard(frames[0][1]), dpb)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    rank_digests = [None] * dist.get_world_size(group)
    dist.all_gather_object(rank_digests, digests.records, group=group)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spatial.reset_counts()
    strips.reset_route_calls()
    before = _launches()
    outs, secs = [], []
    for x_bl, x_el in frames:
        dist.barrier(group)
        t0 = time.perf_counter()
        with precision_scope(Mode("fp32")):
            dpb, bits = fwd(params, sh.shard(x_bl), sh.shard(x_el), dpb)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        outs.append(({k: sh.gather(v) for k, v in dpb.items()},
                     float(bits)))
        dpb = _clamped(dpb)
    after = _launches()
    res = {"s_per_frame": secs, "warm_up_s": warm_s,
           "conv_routes": strips.route_counts(), "peak_gib":
           torch.cuda.max_memory_allocated() / 2 ** 30
           if dev.type == "cuda" else None,
           "launches_per_frame": [(after[0] - before[0]) / PAR_FRAMES,
                                  (after[1] - before[1]) / PAR_FRAMES],
           "branches": spatial.branch_counts(),
           "plan": spatial.level_plan([el_hw[0] >> i for i in range(7)]
                                      + [bl_hw[0] >> i for i in range(7)],
                                      group)}
    if res["launches_per_frame"] != ([14, 1] if dev.type == "cuda"
                                     else [0, 0]):
        raise AssertionError(f"rank {rank}: spatial launches a frame "
                             f"{res['launches_per_frame']}, expected 14, 1")
    if rank == 0:
        errs = []
        refs = {}
        # the unsharded chain, and the same with the frames moved by 1e-6
        # relative: the card's own spread at a near-tie rounding
        for key, scale in (("ref", 1.0), ("moved", 1.0 + 1e-6)):
            ref_dpb, chain = dpb0, []
            with torch.no_grad(), precision_scope(Mode("fp32")):
                for i, (x_bl, x_el) in enumerate(frames):
                    with OpDigests() as ref_digests:
                        out = lssvc_model.forward_one_frame(
                            params, x_bl * scale, x_el * scale,
                            ref_dpb["ref_frame_bl"], ref_dpb["ref_frame_el"],
                            ref_dpb["ref_feature_bl"],
                            ref_dpb["ref_feature_el"], el_hw, 2.0,
                            (0, 0, 0, 0), OD_OFFSET_CAP_SERVING)
                    if key == "ref" and i == 0:
                        # the first ops whose outputs the strips change
                        res["first_differences"] = first_differences(
                            ref_digests.records, rank_digests)
                    chain.append((dict(out["dpb"]),
                                  float(out["bit_bl"] + out["bit_el"])))
                    ref_dpb = _clamped(out["dpb"])
            refs[key] = chain
        for i, (got_dpb, got_bits) in enumerate(outs):
            (ref_dpb, bits_ref), (moved_dpb, _) = refs["ref"][i], \
                refs["moved"][i]
            frame = {"bits": got_bits, "bits_ref": bits_ref}
            for k, want in ref_dpb.items():
                d = (got_dpb[k] - want).abs()
                moved = (moved_dpb[k] - want).abs()
                # the elementwise bound of `tests/test_spatial.py` (and of
                # the CPU tests), rtol = atol = 1e-3
                tol = 1e-3 + 1e-3 * want.abs()
                frame[k] = {
                    "max_abs_err": float(d.max()),
                    "max_ref": float(want.abs().max()),
                    "beyond_tol": float((d > tol).float().mean()),
                    "differing": float((d != 0).float().mean()),
                    "rel_rms": float(d.norm() / want.norm()),
                    "moved_rel_rms": float(moved.norm() / want.norm()),
                    "moved_beyond_tol": float((moved > tol).float().mean())}
            errs.append(frame)
        res["against_unsharded"] = errs
        # the JAX test's elementwise bound on both frames, and no op whose
        # output the strips change: each conv takes a route whose rows are
        # the frame's bits, the row-local GEMMs one shape
        past = [i for i, f in enumerate(errs)
                if abs(f["bits"] - f["bits_ref"]) > 1e-3 * max(
                    f["bits_ref"], 1.0)
                or any(f[k]["beyond_tol"] > 0 for k in refs["ref"][0][0])]
        if past or res["first_differences"]:
            raise AssertionError(
                f"spatial frames {past} past the bound: {errs}; ops whose "
                f"outputs the strips change: {res['first_differences']}")
    dist.barrier(group)
    return res


def par_intra(rank, group, sh, dev, el_hw, bl_hw):
    """(d): the IntraSS spatial I-frame at 1080p, twice (the first call
    probes each conv shape's route, `ops/strips.py` `conv2d`), against the
    unsharded one (rank 0): the picture bit for bit, the bits within
    1e-3."""
    from lssvc_tpu_torch.models import intra_ss
    from lssvc_tpu_torch.parallel import spatial

    params = {k: v.to(dev) for k, v in
              init_intra_ss(torch.Generator().manual_seed(1), 192).items()}
    bl_prefix = "base_layer_model."
    el = {k: v for k, v in params.items() if not k.startswith(bl_prefix)}
    bl = {k[len(bl_prefix):]: v for k, v in params.items()
          if k.startswith(bl_prefix)}
    gen = torch.Generator(device=dev).manual_seed(21)
    x_bl = uniform(gen, (1, *bl_hw, 3), 0, 1)
    x_el = uniform(gen, (1, *el_hw, 3), 0, 1)
    fwd = spatial.make_spatial_intra_forward(group, el_hw)
    secs = []
    for _ in range(2):
        strips.reset_route_calls()
        _sync(dev)
        t0 = time.perf_counter()
        with precision_scope(Mode("fp32")):
            x_hat, bits = fwd(el, bl, sh.shard(x_bl), sh.shard(x_el))
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    res = {"s": secs[1], "first_s": secs[0], "bits": float(bits),
           "conv_routes": strips.route_counts()}
    full = sh.gather(x_hat)
    if rank == 0:
        with torch.no_grad(), precision_scope(Mode("fp32")):
            ref = intra_ss.forward(el, bl, x_bl, x_el, el_hw, (0, 0, 0, 0))
        r = ref["x_hat_el"]
        bits_ref = float(ref["bit_bl"] + ref["bit_el"])
        err = float((full - r).abs().max())
        tol = max(1e-3, 1e-3 * float(r.abs().max()))
        res.update(max_abs_err=err, tol=tol, bits_ref=bits_ref)
        if err != 0 or abs(res["bits"] - bits_ref) > 1e-3 * bits_ref:
            raise AssertionError(f"spatial intra: {res}")
    return res


def par_serve(rank, group, dev, el_hw, bl_hw):
    """(e): `serve_streams`, two streams on the two ranks, 3 bf16 P-frames
    at 1080p each; each rank then runs its stream alone: bits and DPB
    bit-equal."""
    from lssvc_tpu_torch.models import lssvc as lssvc_model
    from lssvc_tpu_torch.parallel.serve import serve_streams

    params = {k: v.to(dev) for k, v in
              init_lssvc(torch.Generator().manual_seed(0)).items()}
    gen = torch.Generator(device=dev).manual_seed(22)
    t, b = PAR_SERVE_FRAMES, 2
    frames_bl = uniform(gen, (t, b, *bl_hw, 3), 0, 1)
    frames_el = uniform(gen, (t, b, *el_hw, 3), 0, 1)
    dpb0 = {"ref_frame_bl": uniform(gen, (b, *bl_hw, 3), 0, 1),
            "ref_frame_el": uniform(gen, (b, *el_hw, 3), 0, 1),
            "ref_feature_bl": uniform(gen, (b, *bl_hw, 64), 0, 1),
            "ref_feature_el": uniform(gen, (b, *el_hw, 48), 0, 1)}
    _sync(dev)
    t0 = time.perf_counter()
    dpb, bits = serve_streams(params, frames_bl, frames_el, dpb0, group,
                              el_hw, precision="bf16",
                              od_offset_cap=OD_OFFSET_CAP_SERVING)
    _sync(dev)
    secs = time.perf_counter() - t0
    alone = {k: v[rank:rank + 1] for k, v in dpb0.items()}
    with torch.no_grad(), precision_scope(Mode("bf16")):
        for i in range(t):
            out = lssvc_model.forward_one_frame(
                params, frames_bl[i, rank:rank + 1],
                frames_el[i, rank:rank + 1], alone["ref_frame_bl"],
                alone["ref_frame_el"], alone["ref_feature_bl"],
                alone["ref_feature_el"], el_hw, 2.0, (0, 0, 0, 0),
                OD_OFFSET_CAP_SERVING)
            alone = out["dpb"]
            mine = (float(out["bit_bl"]), float(out["bit_el"]))
            if tuple(bits[i, rank].tolist()) != mine:
                raise AssertionError(f"stream {rank} frame {i}: bits "
                                     f"{bits[i, rank].tolist()} served, "
                                     f"{mine} alone")
    for k, v in alone.items():
        if not torch.equal(dpb[k], v):
            raise AssertionError(f"stream {rank}: DPB {k} differs alone")
    return {"s_per_frame": secs / t, "bits": bits.tolist()}


def par_rank(rank, group, dev, el_hw, bl_hw):
    """(b)-(e) of phase 19 on one gloo rank (on the CPU too, at a small
    size, to rehearse it)."""
    from lssvc_tpu_torch.parallel import spatial

    sh = spatial.h_sharding(group)
    out = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        out["gloo_cuda"] = _gloo_cuda_probe(group)
    out["halo"] = par_halo_warps(rank, group, sh, dev, el_hw)
    out["frames"] = par_frames(rank, group, sh, dev, el_hw, bl_hw)
    out["intra"] = par_intra(rank, group, sh, dev, el_hw, bl_hw)
    out["serve"] = par_serve(rank, group, dev, el_hw, bl_hw)
    return out


def _same_checkpoints(a, b):
    """Whether two checkpoint files hold the same numbers (their metadata,
    which names each run's --out, apart): (equal, max |diff|)."""
    equal, worst = True, 0.0
    for path_a, path_b in ((f"{a}.npz", f"{b}.npz"),
                           (f"{a}.state.npz", f"{b}.state.npz")):
        x, y = np.load(path_a), np.load(path_b)
        for k in y.files:
            if y[k].dtype.kind not in "fiub":
                continue
            equal = equal and np.array_equal(x[k], y[k])
            if y[k].dtype.kind == "f":
                worst = max(worst, float(np.abs(x[k].astype(np.float64)
                                                - y[k]).max()))
    return equal, worst


# phase 19 (a)'s spynet runs: 3 steps at crop 256
SPYNET_ARGV = ["--crop", str(TRAIN_CROP), "--steps", "3", "--scan-steps",
               "1", "--save-every", "100", "--log-every", "1", "--stage",
               "spynet"]


def _spynet_prefix(d, name):
    return d / "par" / name / "lssvc"


def world1_torchrun(d):
    """Phase 19 (a)'s torchrun run, started in the background in phase 2's
    window: `--stage spynet` as torchrun starts the trainer, a world of 1
    on NCCL."""
    return Background(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "lssvc_tpu_torch.train",
         *SPYNET_ARGV, "--out", str(_spynet_prefix(d, "torchrun"))],
        "torchrun train", d)


def world1_plain(d):
    """Phase 19 (a)'s plain CLI run of the same stage, in this process, in
    phase 2's window."""
    _train_cli([*SPYNET_ARGV, "--out", str(_spynet_prefix(d, "plain"))],
               "plain spynet")


def par_train_world1(d, torchrun):
    """(a): the trainer as torchrun starts it, a world of 1 on NCCL, against
    the plain CLI (both run in phase 2's window; `torchrun` its output and
    seconds), their checkpoints bit for bit at crop 256 after 3 steps
    of `--stage spynet`, whose gradients reach the warps only through the
    flows (a pixel's flow gradient is one thread's sum); then, in this
    process, a world of 1 on NCCL, under
    `torch.use_deterministic_algorithms(True)` (set for the block and
    restored after): one data-parallel `pair` step with the backward
    kernels' launches counted as phase 18 counts them, all of them the
    fixed-order variant, bit-equal to the plain step from the same state,
    and two plain steps bit-equal; one plain step with the flag off shows
    the default path's atomic sums against them."""
    import torch.distributed as dist

    text, torchrun_s = torchrun
    if "data-parallel: 1 rank(s), global batch 1" not in text:
        raise AssertionError(f"torchrun train:\n{text}")
    equal, worst = _same_checkpoints(
        f"{_spynet_prefix(d, 'torchrun')}_step3",
        f"{_spynet_prefix(d, 'plain')}_step3")
    log(f"  (a) spynet stage, crop {TRAIN_CROP}, 3 steps: torchrun world 1 "
        f"(nccl) against the plain CLI: bit-equal {equal} (max |diff| "
        f"{worst:.3g}; torchrun {torchrun_s:.1f} s with its processes, "
        "beside phase 2's other checks)")
    if not equal:
        raise AssertionError("torchrun world 1 differs from the plain run")
    res = {"spynet_bit_equal": equal, "torchrun_s": torchrun_s}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            params = {k: v.cuda() for k, v in
                      init_lssvc(torch.Generator().manual_seed(0)).items()}
            opt = ptrain.Adam(1e-4)
            args = (opt, 0.01, (TRAIN_CROP, TRAIN_CROP))
            sharded = ptrain.make_sharded_train_step(None, *args,
                                                     precision="fp32")
            plain = ptrain.make_train_step(*args, precision="fp32")
            batch = train_batch("pair", TRAIN_CROP, 1, torch.device("cuda"))
            with deterministic():
                torch.cuda.synchronize()
                _reset_grad_counts()
                dp, _, _ = sharded(params, opt.init(params), batch)
                torch.cuda.synchronize()
                counts, fixed = _grad_counts(), _fixed_counts()
                one, _, _ = plain(params, opt.init(params), batch)
                two, _, _ = plain(params, opt.init(params), batch)
            atomic, _, _ = plain(params, opt.init(params), batch)
        finally:
            dist.destroy_process_group()

    def diff(x, y):
        return max(float((x[k] - y[k]).abs().max()) for k in x)

    def equal(x, y):
        return all(same_bits(x[k], y[k]) for k in x)

    res.update(launches=counts, fixed_launches=fixed,
               pair_dp_bit_equal=equal(dp, one),
               pair_plain_bit_equal=equal(one, two),
               pair_dp_vs_plain=diff(dp, one),
               pair_plain_vs_plain=diff(one, two),
               pair_default_vs_fixed=diff(atomic, one))
    log(f"  (a) under torch.use_deterministic_algorithms(True): one "
        f"data-parallel pair step, world 1 on nccl, crop {TRAIN_CROP}: "
        f"launches {counts}, of them the fixed-order variant {fixed}; its "
        f"parameters bit-equal to the plain step's: "
        f"{res['pair_dp_bit_equal']} (max |diff| "
        f"{res['pair_dp_vs_plain']:.3g}); two plain steps bit-equal: "
        f"{res['pair_plain_bit_equal']} (max |diff| "
        f"{res['pair_plain_vs_plain']:.3g}); a plain step with the flag off "
        f"(atomic f32 sums) against them: max |diff| "
        f"{res['pair_default_vs_fixed']:.3g}")
    # the fixed-order variant where a source takes a gradient: 6 of the
    # pair warps' 12 (the other 6, SpyNet's, take the flow's alone, one
    # thread's sums, the same bits on the default path) and the grouped warp
    if (counts["flow_warp_backward"], counts["grouped_warp_backward"]) != \
            (12, 1) or (fixed["flow_warp_backward"],
                        fixed["grouped_warp_backward"]) != (6, 1):
        raise AssertionError(f"data-parallel step launches {counts}, "
                             f"fixed-order {fixed}")
    if not (res["pair_dp_bit_equal"] and res["pair_plain_bit_equal"]):
        raise AssertionError(f"the pair step under the deterministic flag "
                             f"is not reproducible: {res}")
    return res


def par_ranks(d, dev, el_hw, bl_hw):
    """(b)-(e) on two gloo ranks of `dev`: each rank's results (a rank's
    traceback is printed where it failed)."""
    import torch.multiprocessing as mp

    store, out = d / "par_store", str(d / "par_rank")
    t0 = time.perf_counter()
    try:
        mp.spawn(_par_entry, args=(2, str(store), out, dev, el_hw, bl_hw),
                 nprocs=2, join=True)
    except Exception:
        for r in range(2):
            err = Path(f"{out}{r}.err")
            if err.exists():
                log(f"  rank {r} failed:\n{err.read_text()}")
        raise
    ranks = [torch.load(f"{out}{r}.pt", weights_only=False)
             for r in range(2)]
    ranks[0]["seconds"] = time.perf_counter() - t0
    return ranks


def phase_parallel(d, smi, window):
    """Phase 19: parallelism (see the module docstring); `window` the
    outputs and seconds of (a)'s torchrun run and (f)'s dry run, which ran
    in phase 2's window."""
    t_phase = time.perf_counter()
    log("# phase 19: parallelism")
    train = par_train_world1(d, window["torchrun"])
    log(f"  (a) {time.perf_counter() - t_phase:.1f} s")
    ranks = par_ranks(d, "cuda:0", EL_HW, BL_HW)
    log(f"  (b)-(e) two gloo ranks on cuda:0: {ranks[0]['seconds']:.1f} s "
        "with the ranks' start")
    log(f"  gloo collectives taking CUDA tensors (a probe; the exchanges "
        f"stage through the host): {ranks[0]['gloo_cuda']}")
    for r, rk in enumerate(ranks):
        halo = rk["halo"]
        log(f"  (b) rank {r}: max |flow_y| pair {halo['fy_max'][0]:.2f} px, "
            f"grouped {halo['fy_max'][1]:.2f} px")
        for key in ("pair_halo16", "pair_halo8", "grouped_halo56",
                    "grouped_halo44"):
            v = halo[key]
            log(f"    {key}: max |err| {v['max_abs_err']:.3g} against the "
                f"whole-frame kernel, {v['differing']} values differ, "
                f"{v['launches']} launch, branches {v['branch']}")
        fr = rk["frames"]
        log(f"  (c) rank {r}: spatial P-frame 1080p fp32 cap 10: s/frame "
            f"{[round(s, 4) for s in fr['s_per_frame']]}, peak "
            f"{fr['peak_gib']:.2f} GiB, launches a frame (flow_warp, "
            f"grouped_warp) {fr['launches_per_frame']}, branches "
            f"{fr['branches']} ({smi}); the warm-up frame, each conv "
            f"shape's route probed, {fr['warm_up_s']:.4f} s; conv routes "
            f"{json.dumps(fr['conv_routes'])}")
        if r == 0:
            log(f"    level plan {fr['plan']}")
            log(f"    ops whose outputs the strips change (frame 1; "
                f"tools/op_digests.py): {len(fr['first_differences'])}")
            for i, frame in enumerate(fr["against_unsharded"]):
                log(f"    frame {i + 1} against the unsharded card forward: "
                    f"{json.dumps(frame)}")
        it = rk["intra"]
        log(f"  (d) rank {r}: spatial I-frame 1080p: {it['s']:.3f} s "
            f"({it['first_s']:.3f} s the first call, its convs' routes "
            f"probed; the second's routes {json.dumps(it['conv_routes'])}), "
            f"bits {it['bits']:.1f}" + (
                f" (unsharded {it['bits_ref']:.1f}), max |err| "
                f"{it['max_abs_err']:.3g} (0 required)"
                if r == 0 else ""))
        sv = rk["serve"]
        log(f"  (e) rank {r}: serve_streams bf16: {sv['s_per_frame']:.4f} "
            "s a frame, bits and DPB bit-equal to the stream alone")
    times = ranks[0]["halo"]["times"]
    log(f"  (b) times (rank 0 alone on the card; {smi}): pair whole "
        f"{times['pair_whole_ms']:.4f} ms, strip of 576 + 2 x {PAR_HALO} rows "
        f"{times['pair_strip_ms']:.4f} ms; grouped whole "
        f"{times['grouped_whole_ms']:.4f} ms, strip of 576 + 2 x "
        f"{PAR_GROUPED_HALO} rows {times['grouped_strip_ms']:.4f} ms")
    # (f) the dry run on the card, two gloo ranks sharing it (run in phase
    # 2's window)
    text, dry_s = window["dryrun"]
    if "dryrun_multichip: 2 ranks passed" not in text:
        raise AssertionError(f"dryrun:\n{text}")
    for line in text.splitlines():
        if line.startswith("dryrun_multichip"):
            log(f"  (f) {line[:300]}")
    log(f"  (f) {dry_s:.1f} s in phase 2's window, beside its other checks")
    log(f"  phase 19: {time.perf_counter() - t_phase:.1f} s")
    return train, ranks


# ---------------------------------------------------------------------------
# phase 20: the root tools' twins

TOOLS_LAMBDAS = ("0.003", "0.03")
# two rate points at full width: 2 steps a stage (the trainer's chunk of 8
# at its default --scan-steps), crop 128, the evaluation at 128x128, 4
# frames at gop 2
TOOLS_ARGV = ["--lambdas", *TOOLS_LAMBDAS, "--stages", "full",
              "--steps-intra", "2", "--steps-video", "2", "--crop", "128",
              "--eval-size", "128", "--frames", "4", "--gop", "2"]
TOOLS_MODES = ("fp32", "bf16", "int8")
RD_POINT = re.compile(r"^  (\w+) lmbda=([0-9.e-]+): bpp=([0-9.]+) "
                      r"rgb-psnr=([0-9.]+)$")
PROBE_FRAME = re.compile(r"^frame (\d+): EL rgb psnr ([0-9.-]+) dB$")


def _tool(name, *argv, env=None, codes=(0,)):
    """`python -m lssvc_tpu_torch.tools.<name> argv` on its default device
    (the card): (its stdout, its exit code, which must be in `codes`)."""
    res = subprocess.run([sys.executable, "-m",
                          f"lssvc_tpu_torch.tools.{name}", *argv],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    if res.returncode not in codes:
        raise AssertionError(f"{name} exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout, res.returncode


def phase_tools(d, smi):
    """Phase 20: the root tools' twins on the card (see the module
    docstring).  Returns the launches of rd_experiment's evaluation
    process and of its training processes, and the phase's results."""
    t0 = time.perf_counter()
    log("# phase 20: the root tools' twins")
    out, counts_dir = d / "tools_rd", d / "tools_launches"
    counts_dir.mkdir()
    env = dict(os.environ, **{launch_counts.ENV: str(counts_dir)})
    # (a) rd_experiment: train, then evaluate in three precisions
    text, _ = _tool("rd_experiment", "--out", str(out), *TOOLS_ARGV,
                    "--modes", *TOOLS_MODES, env=env)
    rd_s = time.perf_counter() - t0
    report = json.loads((out / "rd_report.json").read_text())
    points = [m.groups() for m in map(RD_POINT.match, text.splitlines())
              if m]
    curves = report["curves"]
    if list(curves) != list(TOOLS_MODES) or len(points) != \
            len(TOOLS_MODES) * len(TOOLS_LAMBDAS):
        raise AssertionError(f"rd_experiment: curves {curves}, lines "
                             f"{points}")
    for mode, lm, bpp, psnr in points:
        got = curves[mode][TOOLS_LAMBDAS.index(lm)]
        if (f"{got[0]:.4f}", f"{got[1]:.2f}") != (bpp, psnr) or not (
                0 < got[0] < 100 and math.isfinite(got[1])):
            raise AssertionError(f"rd_experiment {mode} {lm}: line "
                                 f"{bpp} {psnr}, report {got}")
        log(f"  (a) rd_experiment {mode} lmbda={lm}: bpp {got[0]:.4f}, "
            f"rgb-psnr {got[1]:.2f} dB")
        for layer in ("BL", "EL", "FL"):
            if not (out / f"json_{mode}" / f"x2_{layer}.json").exists():
                raise AssertionError(f"no json_{mode}/x2_{layer}.json")
    dumps = launch_counts.read_dumps(counts_dir)
    evaluation = [x["launches"] for x in dumps
                  if Path(x["argv"][0]).stem == "rd_experiment"]
    training = [x["launches"] for x in dumps
                if Path(x["argv"][0]).stem == "train"]
    if len(evaluation) != 1 or len(training) != 2 * len(TOOLS_LAMBDAS):
        raise AssertionError(f"launch dumps of {[x['argv'][:1] for x in dumps]}")
    evaluation = evaluation[0]
    trained = {k: sum(t[k] for t in training) for k in training[0]}
    log(f"  (a) {rd_s:.1f} s ("
        + "; ".join(x for x in text.splitlines()
                    if x.startswith("trained "))
        + f"); the evaluation process's launches {evaluation}; the "
        f"training processes' {trained}")
    if min(evaluation["flow_warp"], evaluation["grouped_warp"],
           evaluation["int8_conv"], trained["flow_warp_backward"],
           trained["grouped_warp_backward"]) <= 0:
        raise AssertionError("phase 20 did not launch every kernel of its "
                             "path")
    # (b) rd_reconstruct on the run's log: the report's points as printed
    (d / "rd_log.txt").write_text(text)
    rebuilt = d / "rd_rebuilt.json"
    _tool("rd_reconstruct", str(d / "rd_log.txt"), "--out", str(rebuilt),
          "--modes", *TOOLS_MODES, "--lambdas", *TOOLS_LAMBDAS)
    got = json.loads(rebuilt.read_text())
    want = {m: [[float(f"{b:.4f}"), float(f"{p:.2f}")] for b, p in pts]
            for m, pts in curves.items()}
    if got["curves"] != want or got["lambdas"] != report["lambdas"]:
        raise AssertionError(f"rd_reconstruct: {got} against {report}")
    log("  (b) rd_reconstruct on the log: rd_experiment's report, as "
        f"printed ({time.perf_counter() - t0:.1f} s in)")
    # (c) chain_probe on the first rate point's pair, in bf16
    tag = "l0p003"
    probe, code = _tool(
        "chain_probe", "--video", str(out / f"video_{tag}_full_step2.npz"),
        "--intra", str(out / f"intra_{tag}_step2.npz"), "--yuv",
        str(out / "eval_ds" / "eval" / "x1.yuv"), "--size", "128",
        "--frames", "4", "--precision", "bf16", codes=(0, 1))
    psnrs = [float(m.group(2)) for m in map(PROBE_FRAME.match,
                                             probe.splitlines()) if m]
    if len(psnrs) != 4 or not all(map(math.isfinite, psnrs)) or \
            code != int(psnrs[2] < 0.6 * psnrs[1]):
        raise AssertionError(f"chain_probe (exit {code}):\n{probe}")
    log(f"  (c) chain_probe bf16: EL rgb psnr a frame {psnrs} dB, exit "
        f"{code} ({time.perf_counter() - t0:.1f} s in)")
    # (d) ref_scale_eval: 3 frames of the 1080p sequence
    ref_out = d / "ref_scale"
    printed, _ = _tool("ref_scale_eval", "--out", str(ref_out), "--frames",
                       "3")
    yuv = ref_out / "ds" / "seq1080" / "x1.yuv"
    cfg = json.loads((ref_out / "config.json").read_text())
    if yuv.stat().st_size != 3 * 1920 * 1080 * 3 // 2 or \
            cfg["SYN1080"]["sequences"]["seq1080"]["frames"] != 3 or \
            "python -m lssvc_tpu_torch.test" not in printed:
        raise AssertionError(f"ref_scale_eval:\n{printed}")
    log(f"  (d) ref_scale_eval: {yuv.stat().st_size} bytes of 3 1080p "
        "frames, its config, the CLI's command")
    seconds = time.perf_counter() - t0
    log(f"  phase 20: {seconds:.1f} s ({smi})")
    return evaluation, trained, {"seconds": seconds, "curves": curves,
                                 "chain_probe_psnrs": psnrs}


def phase_window(dev, d, late):
    """Phase 2's window: while conv_chain.cu and int8_conv.cu build, the
    checks that time nothing and need only the early sources: phase 19
    (f)'s dry run and (a)'s torchrun run in the background, phase 18
    (a)-(c) and (a)'s plain spynet run in this process; then the late
    builds and both background runs are waited for, so that nothing runs
    beside a timed phase.  Returns phase 18's checks and the background
    runs' (output, seconds)."""
    t0 = time.perf_counter()
    runs = {"dryrun": Background(
                [sys.executable, "-m", "lssvc_tpu_torch.dryrun", "--n", "2",
                 "--backend", "gloo"], "dryrun", d),
            "torchrun": world1_torchrun(d)}
    try:
        checks = training_checks(dev)
        world1_plain(d)
        log(f"  phase 19 (a): the plain spynet run ("
            f"{time.perf_counter() - t0:.1f} s in)")
        phase_build_late(late)
        window = {k: (r.result(), r.seconds) for k, r in runs.items()}
    finally:
        for r in runs.values():
            r.stop()
    return checks, window


def main():
    t_start = time.perf_counter()

    def lap(phase):
        log(f"# after phase {phase}: {time.perf_counter() - t_start:.1f} s")

    smi = phase_device()
    dev = torch.device("cuda")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="gop_", dir=build.BUILD_DIR) as d:
        d = Path(d)
        late = phase_build()
        lap("2, started")
        checks, window = phase_window(dev, d, late)
        lap("2, finished, with the untimed checks")
        calls, launches = phase_main_path(dev)
        kernels = phase_kernels(dev, calls)
        phase_cpu_vs_card(dev)
        chain_entry = phase_conv_chain(dev)
        tiers = phase_warp_tiers(dev)
        lap(7)
        gop = gop_inputs(d)
        gop_launches, estimated_bpp = phase_gop(
            iframe_flops(GOP_EL_HW, GOP_BL_HW), d, *gop)
        phase_iframe_cpu_vs_card(dev)
        lap(9)
        stream_launches = phase_stream(dev, d, *gop, estimated_bpp)
        lap(10)
        modes = phase_modes(dev)
        phase_precision_gates(dev)
        pair_packed, grouped_packed, _ = phase_packed_stores(dev)
        bf16_stream = phase_bf16_stream(dev, d, *gop)
        lap(14)
        int8_entry = phase_int8(dev, d, *gop, modes)
        lap(15)
        pipelined, staged = phase_serving(dev, d, *gop, modes)
        lap(16)
        phase_evaluation(dev, d, *gop)
        lap(17)
        grad_entries = phase_training(dev, d, gop[0], checks)
        lap(18)
        par_train, par_ranks = phase_parallel(d, smi, window)
        lap(19)
        tools_eval, tools_train, _ = phase_tools(d, smi)
        lap(20)
    n_p = GOP_FRAMES - -(-GOP_FRAMES // GOP)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_frame"] = launches[k["name"]] / K
        k["gop_launches"] = gop_launches[k["name"]]
        k["stream_launches"] = stream_launches[k["name"]]
        k["stream_launches_per_p_frame"] = stream_launches[k["name"]] / n_p
        k["warp_tier_bench"] = tiers[k["name"]]
        k["bf16_launches"] = modes["bf16"]["launches"][k["name"]]
        k["bf16_stream_launches"] = bf16_stream[k["name"]]
        k["pipelined_launches_per_p_frame"] = pipelined[k["name"]]
        k["staged_launches_per_frame"] = staged[k["name"]]
    # the pair's packed store on its path, the bf16_packed chain with
    # LSSVC_PACKED_CTX=1
    ctx = modes["bf16_packed+packed_ctx"]
    pair_packed["launches"] = ctx["launches"]["flow_warp_packed"]
    pair_packed["launches_per_frame"] = \
        ctx["launches_per_frame"]["flow_warp_packed"]
    for k in (pair_packed, grouped_packed):
        k["pipelined_launches_per_p_frame"] = pipelined[k["name"]]
        k["staged_launches_per_frame"] = staged[k["name"]]
    # phase 19: a rank's launches a spatial P-frame, the branches its halo
    # warps took, and a data-parallel pair step's backward launches
    for k in kernels:
        if k["name"] in ("flow_warp", "grouped_warp"):
            i = 0 if k["name"] == "flow_warp" else 1
            k["spatial_launches_per_frame_per_rank"] = [
                r["frames"]["launches_per_frame"][i] for r in par_ranks]
            k["spatial_branches_per_rank"] = [
                r["frames"]["branches"][k["name"]] for r in par_ranks]
            k["halo_warps"] = {key: v for key, v in
                               par_ranks[0]["halo"].items()
                               if key.startswith("pair" if i == 0
                                                 else "grouped")}
    for k in grad_entries:
        k["data_parallel_launches"] = par_train["launches"][k["name"]]
    kernels += [pair_packed, grouped_packed, chain_entry, int8_entry,
                *grad_entries]
    # phase 20: rd_experiment's evaluation process and its training stages
    for k in kernels:
        k["tools_eval_launches"] = tools_eval.get(k["name"], 0)
        k["tools_train_launches"] = tools_train.get(k["name"], 0)
    log(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernels' "
        "build included")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A frozen copy of the model math of `lssvc_tpu_torch` (commit 4d8626f),
the benchmark's plain reference.

Copied: `convert.py`, `ops/{nn,warp,packed}.py`, `models/{base,components,
dmc,dmc_stream,four_part_prior,intra_noar,intra_ss,intra_ss_stream,lssvc,
lssvc_blocks,lssvc_stream,packed_blocks}.py`, `entropy/{models,coder}.py` and
`utils/{checks,platform,stream,host,padding}.py`.  Changed from the program:

  * the H-strips of one frame over several ranks (`ops/strips.py`,
    `ops/spatial_ctx.py`, `utils/collectives.py`) and the int8 precision
    (`ops/int8.py`, its sites in `models/packed_blocks.py`, its tables in
    `models/base.py`) are left out: every function takes its whole-frame
    path, and the precisions are fp32, high, bf16 and bf16_f32out;
  * `ops/warp_kernels.py` holds the warps' plain formulas (`ops/warp.py`)
    in place of the CUDA kernels, on every device;
  * `ops/__init__.py` drops the conv-chain kernel;
  * `native/` is a plain Python rANS decoder and CDF quantizer
    (`rans.py`), in place of the C++ library;
  * `ops/nn.py` `conv2d` and `conv_transpose2d` can round their operands
    to a lower precision (`lower_precision`), for the control of the
    benchmark's comparison.

The reference runs in the fp32 parity mode (TF32 off) and imports nothing
of the program.
"""

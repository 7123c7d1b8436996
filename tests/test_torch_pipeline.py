"""The pipelined P-frame encoder and the overlapped decoder of the port
(`lssvc_tpu_torch/models/pipeline.py`) against its sequential stream path
and against the JAX package's pipeline.

EL 128x128 / BL 64x64, full widths, fp32, the OffsetDiversity cap at the
serving 10 px on both sides, weights from the JAX package's
`init_lssvc(0)` bridged by `params_from_jax`, 3 P-frames from a random
DPB.  `encode_sequence` writes the bins of the sequential
`LSSVCExtend.encode_decode` loop under the runner's in-place clamp byte
for byte, with its bits and its final DPB; `decode_sequence` on them ends
on that DPB bit for bit.  Against the JAX package's `encode_sequence` over
2 frames: bits within 1%, the DPB within 5% relative RMS, as
tests/torch_stream_utils.py and tests/test_torch_stream_lssvc.py hold the
sequential streams.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parity_utils import assert_rel_rms
from torch_stream_utils import assert_bits_close
from lssvc_tpu.models import pipeline as jpipe
from lssvc_tpu.models.init import init_lssvc as j_init_lssvc
from lssvc_tpu.models.lssvc import LSSVCExtend as JLSSVC
from lssvc_tpu.ops.nn import set_od_offset_cap
from lssvc_tpu_torch.convert import params_from_jax
from lssvc_tpu_torch.models import pipeline
from lssvc_tpu_torch.models.lssvc_stream import LSSVCExtend
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING

from torch_threads import share_cores

share_cores()

EL, BL = (128, 128), (64, 64)
FRAMES, JAX_FRAMES = 3, 2
DPB = ("ref_frame_bl", "ref_feature_bl", "ref_frame_el", "ref_feature_el")


@pytest.fixture(scope="module")
def models():
    jparams = j_init_lssvc(0)
    tm = LSSVCExtend(params_from_jax({k: np.asarray(v)
                                      for k, v in jparams.items()}, "lssvc"),
                     device="cpu", od_offset_cap=OD_OFFSET_CAP_SERVING)
    jm = JLSSVC(jparams)
    for m in (tm, jm):
        m.set_scale_information(2.0, EL, (0, 0, 0, 0))
        m.update(force=True)
    set_od_offset_cap(OD_OFFSET_CAP_SERVING)  # read when JAX traces
    jax.clear_caches()
    yield jm, tm
    set_od_offset_cap(None)
    jax.clear_caches()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)

    def a(*shape):
        return rng.random((1, *shape), np.float32)

    frames = [(a(*BL, 3), a(*EL, 3)) for _ in range(FRAMES)]
    dpb = {"ref_frame_bl": a(*BL, 3), "ref_feature_bl": a(*BL, 64),
           "ref_frame_el": a(*EL, 3), "ref_feature_el": a(*EL, 48)}
    return frames, dpb


def _torch_dpb(dpb):
    return {k: torch.from_numpy(v.copy()) for k, v in dpb.items()}


def _paths(folder, n):
    return ([folder / f"bl{t}.bin" for t in range(n)],
            [folder / f"el{t}.bin" for t in range(n)])


@pytest.fixture(scope="module")
def sequential(models, inputs, tmp_path_factory):
    """The runner's stream loop: `encode_decode` a frame, then the DPB
    pictures clamped in place (`harness/runner.py`)."""
    _, tm = models
    frames, dpb0 = inputs
    folder = tmp_path_factory.mktemp("sequential")
    bl_paths, el_paths = _paths(folder, FRAMES)
    dpb, bits = _torch_dpb(dpb0), []
    for t, (x_bl, x_el) in enumerate(frames):
        res = tm.encode_decode(torch.from_numpy(x_bl), torch.from_numpy(x_el),
                               dpb, bl_paths[t], el_paths[t], EL[1], EL[0],
                               BL[1], BL[0])
        dpb = res["dpb"]
        dpb["ref_frame_bl"].clamp_(0, 1)
        dpb["ref_frame_el"].clamp_(0, 1)
        bits.append((res["bit_bl"], res["bit_el"]))
    return bl_paths, el_paths, bits, dpb


@pytest.fixture(scope="module")
def pipelined(models, inputs, tmp_path_factory):
    """`encode_sequence` over the first JAX_FRAMES frames, then on from
    its DPB over the rest: (BL paths, EL paths, bits, final DPB, the DPB
    after JAX_FRAMES frames)."""
    _, tm = models
    frames, dpb0 = inputs
    folder = tmp_path_factory.mktemp("pipelined")
    bl_paths, el_paths = _paths(folder, FRAMES)
    dpb, bits = _torch_dpb(dpb0), []
    for run in (slice(0, JAX_FRAMES), slice(JAX_FRAMES, FRAMES)):
        dpb, run_bits = pipeline.encode_sequence(
            tm, [torch.from_numpy(f[0]) for f in frames[run]],
            [torch.from_numpy(f[1]) for f in frames[run]], dpb,
            bl_paths[run], el_paths[run])
        bits += run_bits
        if run.start == 0:
            dpb_jax_frames = dpb
    return bl_paths, el_paths, bits, dpb, dpb_jax_frames


def test_pipelined_bins_equal_the_sequential_loop(sequential, pipelined):
    seq_bl, seq_el, seq_bits, seq_dpb = sequential
    pip_bl, pip_el, pip_bits, pip_dpb, _ = pipelined
    for a, b in zip(seq_bl + seq_el, pip_bl + pip_el):
        assert a.read_bytes() == b.read_bytes(), b.name
    assert pip_bits == seq_bits
    for k in DPB:
        assert torch.equal(pip_dpb[k], seq_dpb[k]), k


def test_overlapped_decode_rebuilds_the_dpb(models, inputs, sequential,
                                            pipelined):
    """`decode_sequence` on the pipelined bins ends on the sequential
    decoder chain's DPB (the sequential loop decodes its files) and on
    the pipelined encoder's, bit for bit."""
    _, tm = models
    bl_paths, el_paths, _, enc_dpb, _ = pipelined
    dpb = pipeline.decode_sequence(tm, bl_paths, el_paths,
                                   _torch_dpb(inputs[1]), *BL, *EL)
    for k in DPB:
        assert torch.equal(dpb[k], sequential[3][k]), k
        assert torch.equal(dpb[k], enc_dpb[k]), k


def test_pipelined_encode_matches_jax(models, inputs, pipelined,
                                      tmp_path):
    jm, _ = models
    frames, dpb0 = inputs
    bl_paths, el_paths = _paths(tmp_path, JAX_FRAMES)
    jdpb, jbits = jpipe.encode_sequence(
        jm, [jnp.asarray(f[0]) for f in frames[:JAX_FRAMES]],
        [jnp.asarray(f[1]) for f in frames[:JAX_FRAMES]],
        {k: jnp.asarray(v) for k, v in dpb0.items()},
        [str(p) for p in bl_paths], [str(p) for p in el_paths])
    for (pb, pe), (jb, je) in zip(pipelined[2][:JAX_FRAMES], jbits):
        assert_bits_close(pb, jb, "BL")
        assert_bits_close(pe, je, "EL")
    for k in DPB:
        assert_rel_rms(pipelined[4][k].numpy(), np.asarray(jdpb[k]))

"""The comparison that decides `correct` fails a broken timed path.

Each case drives a whole run of a cell (set-up, window, comparison; not
the look for a card) on the CPU at a size a test run holds (EL 256x256,
GOPs of 4 from 8 held frames), with the cell's own limits, and a fault
planted underneath:

  * none: the run is correct (else the faults below would prove nothing);
  * state: a P-frame's encoder (`pipeline.frame_device`) or decoder
    (`decode_frame_overlapped`) hands on the DPB it was given, its state
    unchanged;
  * answer: one byte of each P-frame's EL bitstream altered where the
    coder produces it (encode cells);
  * token: one symbol of each P-frame's EL planes altered where the rANS
    decoder produces it (decode cells);
  * stale: a stale DPB.  Encode cells: the GOP loop hands each P-frame
    the DPB that the frame before it was given.  Decode cells: the frame
    decoder hands on the pictures it was given with its new features.
    Either chain is consistent in itself, so each stage judged from the
    program's own state agrees with the reference: only the hand-off
    check (encode) and the decoder against the encoder (decode) see it.

The cells have no batch to halve (one stream, one frame at a time) and no
exchange between chips (one card).
"""

import tempfile
import time

import pytest
import torch

from benchmark import run as R

SIZE = {"height": 256, "width": 256}
MIX = {"frames": 8, "gop": 4}


class _StalePipeline:
    """The program's `pipeline` module as `harness.serving` sees it, but
    each P-frame gets the DPB that the one before it was given."""

    def __init__(self, pipeline):
        self.pipeline, self.given = pipeline, None

    def __getattr__(self, name):
        return getattr(self.pipeline, name)

    def submit_p_frame(self, model, x_bl, x_el, dpb, *rest):
        stale = dpb if self.given is None else self.given
        self.given = dpb
        return self.pipeline.submit_p_frame(model, x_bl, x_el, stale, *rest)


def _fault(name, decode, monkeypatch):
    from lssvc_tpu_torch.harness import serving
    from lssvc_tpu_torch.models import lssvc_stream, pipeline

    if name == "stale" and decode:
        real = lssvc_stream.decode_frame_overlapped

        def decode_frame_overlapped(model, s_bl, s_el, *args):
            out = real(model, s_bl, s_el, *args)
            dpb = args[4]
            return dict(out, dpb=dict(
                out["dpb"], ref_frame_bl=dpb["ref_frame_bl"],
                ref_frame_el=dpb["ref_frame_el"]))

        monkeypatch.setattr(lssvc_stream, "decode_frame_overlapped",
                            decode_frame_overlapped)
    elif name == "stale":
        monkeypatch.setattr(serving, "pipeline", _StalePipeline(pipeline))
    elif name == "state" and decode:
        real = lssvc_stream.decode_frame_overlapped

        def decode_frame_overlapped(model, s_bl, s_el, *args):
            out = real(model, s_bl, s_el, *args)
            dpb = args[4]
            return dict(out, dpb={k: dpb[k] for k in (
                "ref_frame_bl", "ref_feature_bl", "ref_frame_el",
                "ref_feature_el")})

        monkeypatch.setattr(lssvc_stream, "decode_frame_overlapped",
                            decode_frame_overlapped)
    elif name == "state":
        real = pipeline.frame_device

        def frame_device(model, x_bl, x_el, dpb):
            bl, el, _ = real(model, x_bl, x_el, dpb)
            return bl, el, {k: dpb[k] for k in (
                "ref_frame_bl", "ref_feature_bl", "ref_frame_el",
                "ref_feature_el")}

        monkeypatch.setattr(pipeline, "frame_device", frame_device)
    elif name == "answer":
        real = lssvc_stream.write_planes

        def write_planes(coder, planes):
            data = bytearray(real(coder, planes))
            data[len(data) // 2] ^= 0x5A
            return bytes(data)

        monkeypatch.setattr(lssvc_stream, "write_planes", write_planes)
    elif name == "token":
        real = lssvc_stream._gaussian_host

        def gaussian_host(dec, index):
            vals = real(dec, index).copy()
            vals[len(vals) // 2] += 7
            return vals

        monkeypatch.setattr(lssvc_stream, "_gaussian_host", gaussian_host)


@pytest.mark.parametrize("cell, fault", [
    ("x2.encode.bf16", "none"), ("x2.encode.bf16", "state"),
    ("x2.encode.bf16", "answer"), ("x2.encode.bf16", "stale"),
    ("x2.decode.bf16", "none"), ("x2.decode.bf16", "state"),
    ("x2.decode.bf16", "token"), ("x2.decode.bf16", "stale")])
def test_fault_fails_the_comparison(cell, fault, monkeypatch):
    torch.manual_seed(0)
    bench = R.load_benchmark()
    ctx = R.find_cell(bench, cell)
    ctx["config"].update(SIZE)
    ctx["mix"].update(MIX)
    ctx.update(seed=2 ** 33 + 101, t_start=time.perf_counter())
    monkeypatch.setattr(R, "sampled_frames",
                        lambda seed, gop, horizon: [0, 1, 2])
    _fault(fault, "decode" in cell, monkeypatch)
    with tempfile.TemporaryDirectory() as d:
        res = R.run_cell(ctx, torch.device("cpu"), 0.1, False, d)
    assert res["failed"] == 0
    assert res["correct"] is (fault == "none"), res["compared"]
    if fault == "stale":
        # the stages judged from the program's own state see nothing
        judged = {k for k, v, lim in res["compared"] if v > lim}
        assert judged <= {"handoff_errors", "sym_errors", "dpb_gap"}, \
            res["compared"]

"""The span recorder of the port's frame loops (`utils/spans.py`).

On the CPU, EL 256x256, fp32, random weights from `models/init.py`: one
GOP of 3 frames (I P P) encoded by `harness.serving.encode_gop` and
decoded as the decode CLI does (`intra_ss_stream.decompress_stream`, then
`lssvc_stream.decode_frame_overlapped` with the runner's clamp), once with
the recorder off and once on.  Off, nothing is recorded; on, each frame
has one frame span, the worker's spans carry their frame and the span
that submitted them, every entropy and wait span lies inside a frame, and
the .bin files are byte for byte those of the run with the recorder off.
Under `torch.profiler` each span is a `record_function` range of the
exported trace.  The `cuda` case (skips without a card): under
`torch.cuda.set_sync_debug_mode("warn")`, every synchronising call of an
encoded and a decoded P-frame lies inside a `lssvc.wait.*` span.
"""

import collections
import json
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from lssvc_tpu_torch.harness.serving import encode_gop
from lssvc_tpu_torch.models import intra_ss_stream, lssvc_stream
from lssvc_tpu_torch.models.init import init_intra_ss, init_lssvc
from lssvc_tpu_torch.models.intra_ss import IntraSS
from lssvc_tpu_torch.models.lssvc_stream import LSSVCExtend
from lssvc_tpu_torch.ops import OD_OFFSET_CAP_SERVING
from lssvc_tpu_torch.ops.nn import serving_mode
from lssvc_tpu_torch.utils import spans
from lssvc_tpu_torch.utils.host import clamp_dpb
from lssvc_tpu_torch.utils.stream import decode_p

from torch_threads import share_cores

share_cores()

SIZE, FRAMES = 256, 3
FRAME_SPANS = ("lssvc.p.encode", "lssvc.p.decode", "lssvc.i.encode",
               "lssvc.i.decode")


def _codec(device, precision="fp32"):
    mode = serving_mode(precision)
    video = LSSVCExtend(init_lssvc(torch.Generator().manual_seed(0)),
                        device=device, od_offset_cap=OD_OFFSET_CAP_SERVING,
                        **mode)
    intra = IntraSS(init_intra_ss(torch.Generator().manual_seed(1), 192),
                    device=device, **mode)
    for m in (video, intra):
        m.set_scale_information(2.0, (SIZE, SIZE), (0, 0, 0, 0))
        m.update(force=True)
    g = torch.Generator().manual_seed(2)
    x_el = [torch.rand(1, SIZE, SIZE, 3, generator=g) for _ in range(FRAMES)]
    x_bl = [torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 2)
            .permute(0, 2, 3, 1).contiguous() for x in x_el]
    return video, intra, [x.to(device) for x in x_bl], \
        [x.to(device) for x in x_el]


def _encode(codec, folder):
    video, intra, x_bl, x_el = codec
    folder.mkdir()
    paths = ([folder / f"{t}_bl.bin" for t in range(FRAMES)],
             [folder / f"{t}_el.bin" for t in range(FRAMES)])
    encode_gop(intra, video, x_bl, x_el, 32, *paths, (SIZE // 2, SIZE // 2),
               (SIZE, SIZE))
    return paths


def _decode_pass(codec, paths, frames=FRAMES):
    video, intra = codec[:2]
    h, w = SIZE // 2, SIZE // 2
    dpb = None
    with ThreadPoolExecutor(max_workers=1) as pool:
        for t in range(frames):
            if t == 0:
                res = intra_ss_stream.decompress_stream(
                    intra, paths[0][0], paths[1][0])
                dpb = clamp_dpb({"ref_frame_bl": res["x_hat_bl"],
                                 "ref_frame_el": res["x_hat_el"],
                                 "ref_feature_bl": None,
                                 "ref_feature_el": res["feature_el"]})
            else:
                out = lssvc_stream.decode_frame_overlapped(
                    video, decode_p(paths[0][t]), decode_p(paths[1][t]), h,
                    w, SIZE, SIZE, dpb, pool)
                dpb = clamp_dpb(out["dpb"])
    return dpb


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The bins with the recorder off and its snapshot; the bins with it
    on and its snapshot over the encode and the decode pass; the main
    thread's id; the codec."""
    codec = _codec("cpu")
    folder = tmp_path_factory.mktemp("spans")
    spans.enable(False)
    spans.clear()
    off = _encode(codec, folder / "off")
    off_snap = spans.snapshot()
    spans.enable()
    try:
        on = _encode(codec, folder / "on")
        _decode_pass(codec, on)
    finally:
        spans.enable(False)
    on_snap = spans.snapshot()
    spans.clear()
    return {"off": off, "off_snap": off_snap, "on": on, "on_snap": on_snap,
            "main": threading.get_ident(), "codec": codec}


def test_off_records_nothing(runs):
    assert runs["off_snap"] == {"spans": [], "dropped": 0}


def test_each_frame_has_one_frame_span(runs):
    recs = runs["on_snap"]["spans"]
    frames = [r for r in recs if r["name"] in FRAME_SPANS]
    assert collections.Counter(r["name"] for r in frames) == {
        "lssvc.i.encode": 1, "lssvc.p.encode": FRAMES - 1,
        "lssvc.i.decode": 1, "lssvc.p.decode": FRAMES - 1}
    assert len({r["frame"] for r in frames}) == len(frames)
    assert all(r["parent"] is None and r["thread"] == runs["main"]
               for r in frames)
    ids = {r["frame"] for r in frames}
    # every span of the run belongs to one of them
    assert {r["frame"] for r in recs} == ids


def test_worker_spans_carry_their_frame_and_parent(runs):
    recs = runs["on_snap"]["spans"]
    by_id = {r["id"]: r for r in recs}
    worker = [r for r in recs if r["thread"] != runs["main"]]
    names = collections.Counter(r["name"] for r in worker)
    # the encoder's rANS and file writes, the decoder's planes on the worker
    assert names["lssvc.p.write"] == FRAMES - 1
    assert names["lssvc.entropy.encode"] == 2 * (FRAMES - 1)
    assert names["lssvc.entropy.decode"] == 3 * (FRAMES - 1)
    for r in worker:
        parent = by_id[r["parent"]]
        assert parent["frame"] == r["frame"] is not None, r
        if parent["thread"] == runs["main"]:
            # the span that submitted the work: the frame's own, or the
            # decoder's stage that submits it
            assert parent["name"] in ("lssvc.p.encode", "lssvc.p.decode") \
                or parent["name"].startswith("lssvc.p.decode."), r
    writes = [r for r in worker if r["name"] == "lssvc.p.write"]
    assert all(by_id[r["parent"]]["name"] == "lssvc.p.encode"
               for r in writes)


def test_entropy_and_wait_spans_lie_inside_a_frame(runs):
    recs = runs["on_snap"]["spans"]
    frames = {r["frame"]: r for r in recs if r["name"] in FRAME_SPANS}
    inner = [r for r in recs if r["name"].startswith(("lssvc.entropy.",
                                                      "lssvc.wait."))]
    assert {r["name"] for r in inner} >= {
        "lssvc.entropy.encode", "lssvc.entropy.decode", "lssvc.wait.pace",
        "lssvc.wait.worker"}
    for r in inner:
        f = frames[r["frame"]]
        assert r["start_ns"] >= f["start_ns"], r
        if r["thread"] == f["thread"]:
            assert r["end_ns"] <= f["end_ns"], r
        assert r["cpu_start_ns"] is None
    # the thread-CPU clock is read only at a frame span's ends
    for f in frames.values():
        assert f["cpu_end_ns"] >= f["cpu_start_ns"] is not None


def test_streams_are_byte_equal_with_spans_on_and_off(runs):
    for off, on in zip(runs["off"], runs["on"]):
        for a, b in zip(off, on):
            assert a.read_bytes() == b.read_bytes(), (a, b)


def test_profiler_ranges_match_the_snapshot(runs, tmp_path):
    """One decoded P-frame under the profiler (all threads): each thread's
    `lssvc.` ranges in the exported trace are its recorded spans, in the
    order they started."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    spans.clear()
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        _decode_pass(runs["codec"], runs["on"], frames=2)
    snap = spans.snapshot()
    spans.clear()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    traced = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("lssvc."):
            traced[e["tid"]].append((float(e["ts"]), e["name"]))
    recorded = collections.defaultdict(list)
    for r in snap["spans"]:
        recorded[r["thread"]].append((r["start_ns"], r["name"]))
    assert len(snap["spans"]) > 30
    assert sorted([n for _, n in sorted(v)] for v in traced.values()) == \
        sorted([n for _, n in sorted(v)] for v in recorded.values())


def test_ring_drops_and_counts_past_its_bound(monkeypatch):
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=4))
    spans.clear()
    spans.enable()
    try:
        with spans.frame("lssvc.p.decode"):
            for i in range(9):
                with spans.span(f"lssvc.wait.d2h.{i}"):
                    pass
    finally:
        spans.enable(False)
    snap = spans.snapshot()
    spans.clear()
    assert snap["dropped"] == 6
    # the newest records are kept
    assert [r["name"] for r in snap["spans"]] == [
        "lssvc.wait.d2h.6", "lssvc.wait.d2h.7", "lssvc.wait.d2h.8",
        "lssvc.p.decode"]


def test_a_wait_is_a_span_only_where_there_is_a_card():
    spans.clear()
    spans.enable()
    try:
        with spans.wait("lssvc.wait.h2d", False):
            pass
        with spans.wait("lssvc.wait.d2h", True):
            pass
    finally:
        spans.enable(False)
    with spans.wait("lssvc.wait.d2h", True):
        pass
    snap = spans.snapshot()
    spans.clear()
    assert [r["name"] for r in snap["spans"]] == ["lssvc.wait.d2h"]


@pytest.mark.cuda
def test_every_sync_of_a_p_frame_lies_in_a_wait_span(tmp_path):
    """bf16 as served: a GOP of 3 frames encoded and decoded once to warm
    up, then again under the sync debug mode with the recorder on; each
    "synchronizing CUDA operation" warning's time and thread fall inside a
    `lssvc.wait.*` span of a P-frame's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    codec = _codec(torch.device("cuda"), "bf16")
    _decode_pass(codec, _encode(codec, tmp_path / "warm"))
    torch.cuda.synchronize()
    hits = []

    def hook(message, *args, **kwargs):
        if "synchroniz" in str(message):
            hits.append((threading.get_ident(), time.perf_counter_ns()))

    spans.clear()
    spans.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _decode_pass(codec, _encode(codec, tmp_path / "run"))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        spans.enable(False)
    recs = spans.snapshot()["spans"]
    spans.clear()
    kinds = {r["frame"]: r["name"] for r in recs if r["name"] in FRAME_SPANS}
    p_frames = {f for f, name in kinds.items() if ".p." in name}
    in_p = [(t, ns) for t, ns in hits if any(
        r["thread"] == t and r["start_ns"] <= ns <= r["end_ns"]
        and r["frame"] in p_frames for r in recs)]
    outside = [(t, ns) for t, ns in in_p if not any(
        r["thread"] == t and r["start_ns"] <= ns <= r["end_ns"]
        and r["name"].startswith("lssvc.wait.") for r in recs)]
    assert in_p, "no synchronising call seen in a P-frame"
    assert not outside, f"{len(outside)} of {len(in_p)} outside a wait span"

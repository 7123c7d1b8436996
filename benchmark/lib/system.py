"""The system under test: `lssvc_tpu_torch` built from the benchmark's
weights, and the benchmark's own wrappers around the calls into its
layers, which record per frame what the metrics and the comparison read.

Nothing of the program is edited.  `FrameLog.installed()` replaces, for a
block, module attributes that the program looks up at each call:

  * `models.pipeline.submit_p_frame` (the main thread's block of one
    pipelined P-frame) and `models.pipeline._host_code_frame` (the
    worker's rANS encode and file writes of that frame): a P-frame's
    latency runs from the first to the end of the second;
  * `harness.serving.compress_stream` (an I-frame, encoded and written
    inline);
  * the P-frames' rANS encoder calls (`entropy.coder.VideoCoder`),
    timed on the host clock.

For the frames drawn for the comparison they also keep the inputs, the
DPB before the frame and the DPB it hands on, each stage's state
(`reference.judge.capturing`), the planes handed to the coder and the
bytes of the two files; for the frame after each drawn one, the DPB it
was given (`handed`).  With a profiler running, each frame that is not
drawn is a `bench.iframe` / `bench.pframe` span, the worker's half of a
P-frame `bench.pframe.host`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import numpy as np
import torch

# the P-frames' rANS encoder calls, all on the worker, on host planes (the
# I-frame's coder calls also wait for the card and are left out)
RANS_ENCODE = (("VideoCoder", "encode_factorized"),
               ("VideoCoder", "encode_gaussian"), ("VideoCoder", "flush"))
# the P-frames' rANS decoder calls, on host planes
RANS_DECODE = (("_StreamDecodeMixin", "factorized_symbols"),
               ("_StreamDecodeMixin", "gaussian_symbols"))


def build_models(video_params, intra_params, config, pad, device):
    """The program's two-layer I- and P-frame codecs in the configuration's
    precision, their scale set and CDF tables built, as the CLIs' loaders
    (`parallel/scheduler.py` `load_video`, `load_intra`) build them."""
    from lssvc_tpu_torch.models.intra_ss import IntraSS
    from lssvc_tpu_torch.models.lssvc_stream import LSSVCExtend
    from lssvc_tpu_torch.ops.nn import serving_mode

    mode = serving_mode(config["precision"])
    video = LSSVCExtend(video_params, device=device,
                        od_offset_cap=config["od_offset_cap"] or None, **mode)
    intra = IntraSS(intra_params, device=device, **mode)
    for m in (video, intra):
        m.set_scale_information(config["ratio"], pad["el"], (0, 0, 0, 0))
        m.update(force=True)
    return video, intra


class HostClock:
    """What the host did in the window, for the record on standard error
    (no metric reads it): the main thread's CPU seconds (it launches the
    card's work), the process's CPU seconds over all threads, and the rANS
    coder's seconds.  Started on the main thread."""

    def __init__(self):
        self.t0, self.cpu0 = time.perf_counter(), time.process_time()
        self.main0 = time.thread_time()
        self.out = {}

    def stop(self, rans_s):
        self.out = {"window_s": time.perf_counter() - self.t0,
                    "main_cpu_s": time.thread_time() - self.main0,
                    "process_cpu_s": time.process_time() - self.cpu0,
                    "rans_s": rans_s}

    def reading(self) -> dict:
        return dict(self.out)


def i_frame_dpb(res) -> dict:
    """A copy of the DPB an I-frame's coder hands on, before the clamp."""
    return clone_tree({"ref_frame_bl": res["x_hat_bl"],
                       "ref_frame_el": res["x_hat_el"],
                       "ref_feature_bl": None,
                       "ref_feature_el": res["feature_el"]})


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class FrameLog:
    """Per-frame record of a run (module docstring).  Frames are numbered
    in coding order from `reset()`; `sampled` holds the numbers whose
    frames are kept for the comparison, and `handed` gets the DPB given to
    each frame that follows one of them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tracing = False
        self.rans_s = 0.0
        self.reset(())

    def reset(self, sampled):
        self.sampled = set(sampled)
        self.handoff = {n + 1 for n in self.sampled}
        self.handed = {}
        self.count = 0
        self.start, self.end, self.kind = {}, {}, {}
        self.samples = {}
        self._by_path = {}
        self.rans_s = 0.0

    def _next(self, kind):
        n = self.count
        self.count += 1
        self.kind[n] = kind
        self.start[n] = time.perf_counter()
        return n

    def _span(self, name):
        if self.tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def latencies_s(self) -> list[float]:
        return [self.end[n] - self.start[n] for n in sorted(self.end)]

    @contextlib.contextmanager
    def installed(self):
        from benchmark.reference.judge import capturing
        from lssvc_tpu_torch.entropy import coder
        from lssvc_tpu_torch.harness import serving
        from lssvc_tpu_torch.models import pipeline

        real_submit = pipeline.submit_p_frame
        real_host = pipeline._host_code_frame
        real_intra = serving.compress_stream
        log = self

        def submit_p_frame(model, x_bl, x_el, dpb, bl_path, el_path, pool):
            n = log._next("P")
            keep = n in log.sampled
            with log.lock:
                log._by_path[str(bl_path)] = n
            if n in log.handoff:
                log.handed[n] = clone_tree(dpb)
            if not keep:
                with log._span("bench.pframe"):
                    return real_submit(model, x_bl, x_el, dpb, bl_path,
                                       el_path, pool)
            sample = log.samples[n] = {
                "kind": "P", "x_bl": x_bl.clone(), "x_el": x_el.clone(),
                "dpb_in": clone_tree(dpb), "cap": {}}
            with capturing("lssvc_tpu_torch", sample["cap"]):
                out, fut = real_submit(model, x_bl, x_el, dpb, bl_path,
                                       el_path, pool)
            sample["dpb_out"] = clone_tree(out)
            return out, fut

        def host_code_frame(model, planes, bl_path, el_path):
            with log._span("bench.pframe.host"):
                bits = real_host(model, planes, bl_path, el_path)
            t = time.perf_counter()
            with log.lock:
                n = log._by_path.pop(str(bl_path))
            log.end[n] = t
            if n in log.sampled:
                log.samples[n]["planes"] = planes.get()
                log.samples[n]["bins"] = (Path(bl_path).read_bytes(),
                                          Path(el_path).read_bytes())
            return bits

        def compress_stream(model, x_bl, x_el, bl_path, el_path, *args,
                            **kwargs):
            n = log._next("I")
            if n not in log.sampled:
                with log._span("bench.iframe"):
                    res = real_intra(model, x_bl, x_el, bl_path, el_path,
                                     *args, **kwargs)
                log.end[n] = time.perf_counter()
                return res
            cap = {}
            with capturing("lssvc_tpu_torch", cap):
                res = real_intra(model, x_bl, x_el, bl_path, el_path, *args,
                                 **kwargs)
            log.end[n] = time.perf_counter()
            log.samples[n] = {
                "kind": "I", "x_bl": x_bl.clone(), "x_el": x_el.clone(),
                "cap": cap, "x_hat_bl": res["x_hat_bl"].clone(),
                "feature_el": res["feature_el"].clone(),
                "dpb_out": i_frame_dpb(res),
                "bins": (Path(bl_path).read_bytes(),
                         Path(el_path).read_bytes())}
            return res

        pipeline.submit_p_frame = submit_p_frame
        pipeline._host_code_frame = host_code_frame
        serving.compress_stream = compress_stream
        try:
            with self.rans_timed(RANS_ENCODE):
                yield self
        finally:
            pipeline.submit_p_frame = real_submit
            pipeline._host_code_frame = real_host
            serving.compress_stream = real_intra

    @contextlib.contextmanager
    def rans_timed(self, methods):
        """Within the block the host seconds inside the coder's `methods`
        ((class name, method) of `entropy.coder`) add to `rans_s`."""
        from lssvc_tpu_torch.entropy import coder

        saved = []
        for cls_name, meth in methods:
            cls = getattr(coder, cls_name)
            real = cls.__dict__[meth]
            saved.append((cls, meth, real))
            setattr(cls, meth, self._timed(real))
        try:
            yield self
        finally:
            for cls, meth, real in saved:
                setattr(cls, meth, real)

    def _timed(self, real):
        log = self

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with log.lock:
                    log.rans_s += dt

        return call


@contextlib.contextmanager
def decode_capture(target):
    """While one frame decodes, record into `target` what its decoders
    read from the streams and hand on, for the comparison: each stage's
    state (`reference.judge.capturing`: flows, contexts); the P-frame
    decoders' symbols with the index planes and shapes they were decoded
    with (`lssvc_stream._gaussian_host`, `StreamDecoder.factorized_symbols`,
    per stream in the order the streams were opened); the I-frame's
    rebuilt latents with their medians, means and index planes
    (`IntraCoder.eb_decompress`, `gc_decompress`)."""
    from benchmark.reference.judge import capturing
    from lssvc_tpu_torch.entropy import coder
    from lssvc_tpu_torch.models import lssvc_stream

    lock = threading.Lock()
    streams = target.setdefault("streams", [])
    by_id = {}
    real_open = coder.VideoCoder.open_stream
    real_fact = coder._StreamDecodeMixin.factorized_symbols
    real_gauss = lssvc_stream._gaussian_host
    real_eb = coder.IntraCoder.eb_decompress
    real_gc = coder.IntraCoder.gc_decompress

    def record(dec, entry):
        with lock:
            by_id[id(dec)]["calls"].append(entry)

    def open_stream(self, string):
        dec = real_open(self, string)
        with lock:
            by_id[id(dec)] = {"calls": []}
            streams.append(by_id[id(dec)])
        return dec

    def factorized_symbols(self, shape_nhwc, table):
        vals = real_fact(self, shape_nhwc, table)
        if id(self) in by_id:
            record(self, ("fact", tuple(shape_nhwc), vals.copy()))
        return vals

    def gaussian_host(dec, index):
        vals = real_gauss(dec, index)
        if id(dec) in by_id:
            record(dec, ("gauss", index.get().clone(), vals.copy()))
        return vals

    def eb_decompress(self, strings, hw, device):
        out = real_eb(self, strings, hw, device)
        target.setdefault("i.eb", []).append((
            out.detach().clone(),
            torch.from_numpy(np.asarray(self.medians, dtype=np.float32))))
        return out

    def gc_decompress(self, strings, index_nhwc, means_nhwc):
        out = real_gc(self, strings, index_nhwc, means_nhwc)
        target.setdefault("i.gc", []).append(
            (out.detach().clone(), index_nhwc.detach().clone(),
             means_nhwc.detach().clone()))
        return out

    coder.VideoCoder.open_stream = open_stream
    coder._StreamDecodeMixin.factorized_symbols = factorized_symbols
    lssvc_stream._gaussian_host = gaussian_host
    coder.IntraCoder.eb_decompress = eb_decompress
    coder.IntraCoder.gc_decompress = gc_decompress
    try:
        with capturing("lssvc_tpu_torch", target):
            yield target
    finally:
        coder.VideoCoder.open_stream = real_open
        coder._StreamDecodeMixin.factorized_symbols = real_fact
        lssvc_stream._gaussian_host = real_gauss
        coder.IntraCoder.eb_decompress = real_eb
        coder.IntraCoder.gc_decompress = real_gc


def _nhwc(vals, shape):
    n, h, w, c = shape
    return torch.from_numpy(np.asarray(vals)).reshape(n, c, h, w) \
        .permute(0, 2, 3, 1).contiguous()


def decoded_planes(target):
    """The symbol and index planes a P-frame's two streams were decoded
    into (the encoder's plane names): (BL planes, EL planes)."""
    out = []
    for stream in target["streams"][:2]:
        fact = [(s, v) for kind, s, v in stream["calls"] if kind == "fact"]
        gauss = [(i, v) for kind, i, v in stream["calls"] if kind == "gauss"]
        planes = {"mv_z_hat": _nhwc(fact[0][1], fact[0][0]),
                  "z_hat": _nhwc(fact[1][1], fact[1][0]),
                  "mv_idx": gauss[0][0],
                  "mv_y_q": _nhwc(gauss[0][1], gauss[0][0].shape)}
        if len(gauss) == 2:
            planes["y_idx"] = gauss[1][0]
            planes["y_q"] = _nhwc(gauss[1][1], gauss[1][0].shape)
        else:
            planes["y_idxs"] = [i for i, _ in gauss[1:]]
            planes["y_syms"] = [_nhwc(v, i.shape) for i, v in gauss[1:]]
        out.append(planes)
    return tuple(out)

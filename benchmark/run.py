"""Runs one cell of the benchmark of `lssvc_tpu_torch` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `benchmark/` and
the program.  The cell names its configuration (`benchmark/configs/
<config>.json`) and its traffic mix (`benchmark/traffic/<traffic>.json`,
whose `entry` picks the path: `encode`); the per-layer metrics are the
readers `benchmark/metrics/<metric>.py`.  The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics`, `device`
(and with `--trace 1` `breakdown`), then `compared`, each number of the
comparison with its limit, which also ends standard error.

Set-up (timed as `setup_s`, from the process's start): the weights and
the frames from the seed, on the card; the program's models and CDF
tables; one warm-up of each frame type and path.  The window codes GOPs
from the held frames until `--seconds` have passed, and ends at a GOP's
end.  With `--trace 1` the same window runs, then one whole GOP under
`torch.profiler`, then a count of each frame type's operations.  Once the
window has closed and the memory peak is read, the program's state is
freed and the plain reference (`benchmark/reference/`) judges the frames
drawn from the seed; the DPB each hands on is held to what the next frame
got, and in a decode cell each decoded frame to the encoder's at the
same position of the stream.

Exits with a code other than 0, and prints no result, where there is no
CUDA device or fewer than the cell asks for, where the program is not
there, where a run fails, and where JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# run as a script, the benchmark's folder heads sys.path; the checkout's
# root takes its place, so that `benchmark` and the program import as
# packages and nothing in the folder shadows a library's module
if sys.path and Path(sys.path[0] or ".").resolve() == BENCH_DIR:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# modules no process of the benchmark may hold, compared by the whole
# top-level name (the program's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "lssvc_tpu")
# fixed cache directories inside the checkout, so that only a checkout's
# first run builds
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".bench_cache/triton"}
WARP_KERNELS = ("flow_warp_kernel", "flow_warp_packed_kernel",
                "grouped_warp_kernel")
# frames of the profiler's own start-up, coded before the traced GOP
PROFILER_WARM_FRAMES = 3


class Refused(RuntimeError):
    """A run that prints no result."""


def forbidden_modules(names=None) -> list[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


# --- discovery by name -----------------------------------------------------

def load_benchmark(root=ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise Refused(f"{path} not found")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str, root=ROOT) -> dict:
    """The cell `name` with its configuration and traffic mix loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((Path(root) / configs[cell["config"]]["file"])
                        .read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return {"cell": cell, "config": config, "mix": mix}


def reports(metric: dict, cell_name: str, end_to_end: list) -> bool:
    """Whether a metric is read in this cell: listed there, or (with no
    `workloads`) the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moved = {m["name"]: m for m in end_to_end}.get(metric.get("moves"))
    return moved is not None and ("workloads" not in moved
                                  or cell_name in moved["workloads"])


def cell_metrics(bench: dict, cell_name: str):
    """(end-to-end metrics, per-layer metrics) that this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    layer = [m for m in bench["per_layer"]
             if reports(m, cell_name, bench["end_to_end"])]
    return e2e, layer


def load_reader(metric_name: str):
    """The reader of a per-layer metric: `read(run) -> float | None` in
    `benchmark/metrics/<metric>.py`."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="inclusive")[94]


# --- the run ----------------------------------------------------------------

def make_inputs(config, mix, seed, device):
    """Weights and frames from the seed (the benchmark's inputs, handed to
    the program and, made again, to the reference)."""
    from benchmark.lib import traffic, weights

    pad = traffic.interlayer_padding(config["height"], config["width"],
                                     config["ratio"])
    video = weights.Draws.realize(weights.init_lssvc(weights.Draws()),
                                  seed, device)
    intra = weights.Draws.realize(
        weights.init_intra_ss(weights.Draws(), config["channel_bl_intra"]),
        seed + 1, device)
    frames_bl, frames_el = traffic.make_frames(mix, config, seed, device)
    return pad, video, intra, frames_bl, frames_el


def sampled_frames(seed, gop, horizon) -> list[int]:
    """The frames of the window drawn for the comparison, among its first
    `horizon` frames: one I-frame, one P-frame from the first half of a
    GOP and one from the second, each followed by a P-frame of its GOP
    (whose DPB the hand-off check reads).  The random-init codec's
    features grow along a GOP's chain, and with them the BL analysis
    latents' bf16 error (PERF.md, section 6), so every draw holds a late
    frame."""
    rng = random.Random(seed)
    half = gop // 2
    starts = list(range(0, horizon, gop))
    return sorted([rng.choice(starts),
                   rng.choice(starts) + rng.randrange(1, half),
                   rng.choice(starts) + rng.randrange(half, gop - 1)])


class EncodeRun:
    """The `encode` entry: `harness.serving.encode_gop`, one GOP at a
    time, over the held frames (cycled), each frame's two .bin files
    written under a temporary directory."""

    # the numbers of the comparison that a run of this entry gives
    NUMBERS = ("y_err", "mv_err", "ctx_err", "warp_err", "feat_err",
               "idx_gap", "bin_errors", "handoff_errors")

    def __init__(self, ctx, device, workdir):
        from benchmark.lib.system import FrameLog, build_models

        self.ctx, self.device, self.workdir = ctx, device, Path(workdir)
        config, mix, seed = ctx["config"], ctx["mix"], ctx["seed"]
        self.pad, video_p, intra_p, self.frames_bl, self.frames_el = \
            make_inputs(config, mix, seed, device)
        self.video, self.intra = build_models(video_p, intra_p, config,
                                              self.pad, device)
        self.gop = int(mix["gop"])
        self.log = FrameLog()
        self.slot = 0

    def _paths(self, n):
        bl, el = [], []
        for _ in range(n):
            # a ring of two GOPs of file names: a file is read back, if it
            # is drawn, before its name comes round again
            s = self.slot % (2 * self.gop)
            bl.append(self.workdir / f"{s}_bl.bin")
            el.append(self.workdir / f"{s}_el.bin")
            self.slot += 1
        return bl, el

    def code(self, t0, n):
        """Frames t0 .. t0+n-1 of the sequence as one GOP (t0 starts it)."""
        from benchmark.lib import traffic
        from lssvc_tpu_torch.harness.serving import encode_gop

        idx = traffic.gop_frames(self.ctx["mix"], t0, n)
        fb = [self.frames_bl[i].to(self.device, non_blocking=True)
              for i in idx]
        fe = [self.frames_el[i].to(self.device, non_blocking=True)
              for i in idx]
        encode_gop(self.intra, self.video, fb, fe, self.gop,
                   *self._paths(n), self.pad["bl"], self.pad["el"])

    def warm_up(self, sampled):
        # an I-frame, the first P-frame (no BL feature yet), a later one
        with self.log.installed():
            self.code(0, 3)

    def window(self, seconds, sampled):
        """GOPs until `seconds` have passed: (frames, seconds)."""
        self.log.reset(sampled)
        with self.log.installed():
            t0 = time.perf_counter()
            t = 0
            while True:
                self.code(t, self.gop)
                t += self.gop
                if time.perf_counter() - t0 >= seconds:
                    break
            elapsed = time.perf_counter() - t0
        return t, elapsed

    def e2e(self, frames, elapsed) -> dict:
        return {"encode_fps": frames / elapsed}

    def stretch(self, n):
        """The first `n` frames of a GOP, coded as in the window."""
        self.code(0, n)

    def frame_types(self):
        kinds = self.log.kind.values()
        return {"I": sum(k == "I" for k in kinds),
                "P": sum(k == "P" for k in kinds)}

    # the calls that code one frame of each type, where count_ops counts
    ENTRY_POINTS = (("lssvc_tpu_torch.harness.serving", "compress_stream",
                     "I"),
                    ("lssvc_tpu_torch.models.pipeline", "submit_p_frame", "P"))

    def three_frames(self):
        """An I-frame, the first P-frame, a later one."""
        self.code(0, 3)

    def count_ops(self):
        """Operations of one I-frame and one later P-frame, by dtype:
        {"I": counts, "P": counts}."""
        import importlib

        from benchmark.lib.flops import DtypeFlops

        out, seen, saved = {}, {"P": 0}, []

        def counted(kind, real):
            def call(*args, **kwargs):
                if kind == "P":
                    seen["P"] += 1
                if kind in out or (kind == "P" and seen["P"] < 2):
                    return real(*args, **kwargs)
                flops = DtypeFlops()
                with flops:
                    res = real(*args, **kwargs)
                out[kind] = dict(flops.counts)
                return res
            return call

        for module, name, kind in self.ENTRY_POINTS:
            mod = importlib.import_module(module)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, counted(kind, getattr(mod, name)))
        try:
            self.three_frames()
        finally:
            for mod, name, real in saved:
                setattr(mod, name, real)
        return out

    def free(self):
        del self.video, self.intra, self.frames_bl, self.frames_el


class DecodeRun(EncodeRun):
    """The `decode` entry.  Set-up encodes one GOP of the held frames to
    .bin files with the `encode` entry's encoder (its frames drawn for the
    comparison are judged as an encode run's).  The window decodes that
    GOP again and again, as `decode.py` does a file: the I-frame by
    `intra_ss_stream.decompress_stream`, each P-frame by
    `lssvc_stream.decode_frame_overlapped` (the frame decoder of
    `pipeline.decode_sequence`) with the runner's clamp between frames;
    each frame's BL and EL pictures then copied to host memory, the
    hand-off to a display or a file.  A frame's latency runs from its file
    reads to its pictures on the host."""

    NUMBERS = EncodeRun.NUMBERS + ("sym_errors", "dpb_gap")

    def __init__(self, ctx, device, workdir):
        super().__init__(ctx, device, workdir)
        self.bins = None
        self.encoded_samples = {}

    def warm_up(self, sampled):
        import torch

        super().warm_up(sampled)
        # the stream this cell decodes: one GOP, its frames at the
        # positions of the window's drawn frames kept, judged as an encode
        # run's and held against the decoder's
        gop = self.gop
        self.log.reset({n % gop for n in sampled})
        self.slot = 0
        with self.log.installed():
            self.code(0, gop)
        self.encoded_samples = dict(self.log.samples)
        self.bins = [(self.workdir / f"{t}_bl.bin",
                      self.workdir / f"{t}_el.bin") for t in range(gop)]
        self.data = [(pb.read_bytes(), pe.read_bytes())
                     for pb, pe in self.bins]
        self.host = [torch.empty(x.shape, pin_memory=self.device.type
                                 == "cuda") for x in (self.frames_bl[0],
                                                      self.frames_el[0])]
        self.decode_pass(3, set())

    def decode_pass(self, n, sampled, t_base=0):
        """Frames 0 .. n-1 of the stream; those in `sampled` (numbered
        from `t_base`) are kept for the comparison."""
        import torch

        from benchmark.lib.system import (RANS_DECODE, clone_tree,
                                          decode_capture, decoded_planes,
                                          i_frame_dpb)
        from lssvc_tpu_torch.models import intra_ss_stream, lssvc_stream
        from lssvc_tpu_torch.utils.host import clamp_dpb
        from lssvc_tpu_torch.utils.stream import decode_p

        hb, wb = self.pad["bl"]
        he, we = self.pad["el"]
        log = self.log
        dpb = None
        with ThreadPoolExecutor(max_workers=1) as pool, \
                log.rans_timed(RANS_DECODE):
            for t in range(n):
                k = log._next("I" if t == 0 else "P")
                keep = (t_base + t) in sampled
                if t and (t_base + t) in log.handoff:
                    log.handed[t_base + t] = clone_tree(dpb)
                cap = {}
                pb, pe = self.bins[t]
                with (decode_capture(cap) if keep
                      else log._span("bench.iframe" if t == 0
                                     else "bench.pframe")):
                    if t == 0:
                        res = intra_ss_stream.decompress_stream(
                            self.intra, pb, pe)
                        out = clamp_dpb({
                            "ref_frame_bl": res["x_hat_bl"],
                            "ref_frame_el": res["x_hat_el"],
                            "ref_feature_bl": None,
                            "ref_feature_el": res["feature_el"]})
                    else:
                        dec = lssvc_stream.decode_frame_overlapped(
                            self.video, decode_p(pb), decode_p(pe), hb, wb,
                            he, we, dpb, pool)
                        out = clamp_dpb(dec["dpb"])
                for host, key in zip(self.host, ("ref_frame_bl",
                                                 "ref_frame_el")):
                    host.copy_(out[key], non_blocking=True)
                if self.device.type == "cuda":
                    torch.cuda.current_stream().synchronize()
                log.end[k] = time.perf_counter()
                if keep:
                    if t == 0:
                        log.samples[t_base + t] = {
                            "kind": "I", "decoded": True, "cap": cap,
                            "x_hat_bl": res["x_hat_bl"].clone(),
                            "feature_el": res["feature_el"].clone(),
                            "dpb_out": i_frame_dpb(res),
                            "bins": self.data[t]}
                    else:
                        log.samples[t_base + t] = {
                            "kind": "P", "decoded": True, "cap": cap,
                            "planes": decoded_planes(cap),
                            "dpb_in": clone_tree(dpb),
                            "dpb_out": clone_tree(dec["dpb"]),
                            "bins": self.data[t]}
                dpb = out

    def code(self, t0, n):
        if self.bins is None:
            return super().code(t0, n)
        self.decode_pass(n, self.log.sampled, t0)

    def window(self, seconds, sampled):
        """Passes over the stream until `seconds` have passed."""
        self.log.reset(sampled)
        t0 = time.perf_counter()
        t = 0
        while True:
            self.decode_pass(self.gop, sampled, t)
            t += self.gop
            if time.perf_counter() - t0 >= seconds:
                break
        return t, time.perf_counter() - t0

    def e2e(self, frames, elapsed) -> dict:
        return {"decode_fps": frames / elapsed,
                "frame_p95_ms": 1e3 * p95(self.log.latencies_s())}

    def stretch(self, n):
        self.decode_pass(n, set())

    ENTRY_POINTS = (("lssvc_tpu_torch.models.intra_ss_stream",
                     "decompress_stream", "I"),
                    ("lssvc_tpu_torch.models.lssvc_stream",
                     "decode_frame_overlapped", "P"))

    def three_frames(self):
        self.decode_pass(3, set())


ENTRIES = {"encode": EncodeRun, "decode": DecodeRun}


def traced(runner, trace_dir):
    """One whole GOP under the profiler, coded as the window codes each of
    its GOPs, with every warp launch recorded: (Trace, warp launches)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from benchmark.lib.launches import recording
    from benchmark.lib.trace import STRETCH, Trace
    from lssvc_tpu_torch.ops import warp_kernels as wk

    path = Path(trace_dir) / "trace.json"
    runner.log.tracing = True
    try:
        with runner.log.installed(), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA],
                        schedule=schedule(wait=0, warmup=1, active=1,
                                          repeat=1),
                        on_trace_ready=lambda p: p.export_chrome_trace(
                            str(path))) as prof:
            # the profiler's own start-up falls in a few frames that are
            # not kept; the GOP after them is
            runner.stretch(PROFILER_WARM_FRAMES)
            torch.cuda.synchronize()
            prof.step()
            runner.log.reset(())
            with recording(wk) as rec:
                with record_function(STRETCH):
                    runner.stretch(runner.gop)
                    torch.cuda.synchronize()
            prof.step()
    finally:
        runner.log.tracing = False
    tr = Trace(path)
    path.unlink()
    return tr, list(rec.calls)


def judge(ctx, samples, device, lower=None):
    """The reference's numbers over the sampled frames; with `lower`, of
    the control: the reference at that precision put in the program's
    place on the same frames and DPBs."""
    import torch

    from benchmark.lib import weights
    from benchmark.reference import judge as jd

    config, seed = ctx["config"], ctx["seed"]
    video = weights.Draws.realize(weights.init_lssvc(weights.Draws()),
                                  seed, device)
    intra = weights.Draws.realize(
        weights.init_intra_ss(weights.Draws(), config["channel_bl_intra"]),
        seed + 1, device)
    from benchmark.lib.traffic import interlayer_padding

    pad = interlayer_padding(config["height"], config["width"],
                             config["ratio"])
    ref = jd.Reference(video, intra, config, pad, device)
    readings = []
    for n in samples:
        frame = samples[n]
        extra = {}
        if lower and frame.get("decoded"):
            frame = jd.decode_lower(ref, frame, lower)
            # the control's DPB against the encoder's at the same position
            encoded = samples.get(f"stream.{n % ctx['mix']['gop']}")
            if encoded is not None:
                extra["dpb_gap"] = jd.dpb_gap(frame["dpb_out"],
                                              encoded["dpb_out"])
        elif lower:
            frame = (ref.encode_p if frame["kind"] == "P"
                     else ref.encode_i)(frame, lower)
        judge_frame = jd.judge_p if frame["kind"] == "P" else jd.judge_i
        readings.append(dict(judge_frame(ref, frame), **extra))
        tag = f" control {lower}" if lower else ""
        print(f"frame {n} {frame['kind']}{tag} {json.dumps(readings[-1])}",
              file=sys.stderr)
        torch.cuda.empty_cache() if device.type == "cuda" else None
    return jd.merge(readings)


def _phase(name, t_start):
    print(f"phase {name} done at {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)


def chain_numbers(runner, samples, handed, kinds) -> dict:
    """`handoff_errors` over the drawn frames of the window and the frame
    after each; in a decode cell also `sym_errors` and `dpb_gap`, each
    drawn frame against the set-up encode's at its position of the
    stream."""
    from benchmark.reference import judge as jd

    drawn = [n for n in samples if isinstance(n, int)]
    after = [n + 1 for n in drawn if n + 1 in handed
             and kinds.get(n + 1) == "P"]
    out = {"handoff_errors": jd.handoff_errors(
        {n: samples[n - 1]["dpb_out"] for n in after},
        {n: handed[n] for n in after})}
    encoded = getattr(runner, "encoded_samples", None)
    if encoded is not None:
        out.update(jd.merge([jd.sync_numbers(samples[n],
                                             encoded[n % runner.gop])
                             for n in drawn]))
    return out


def run_cell(ctx, device, seconds, trace, workdir, controls=()):
    """One run of a cell on `device` (the card, or the CPU in the tests):
    the result dict but `device`.  `controls`: lower precisions whose
    control is judged too, on the same frames (`benchmark/control.py`;
    the benchmark's runs judge none)."""
    import torch

    from benchmark.lib.system import HostClock
    from benchmark.reference import judge as jd

    entry = ENTRIES[ctx["mix"]["entry"]]
    runner = entry(ctx, device, workdir)
    sampled = sampled_frames(ctx["seed"], runner.gop, 2 * runner.gop)
    runner.warm_up(sampled)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx["t_start"]
    _phase("set-up", ctx["t_start"])
    host = HostClock()
    frames, elapsed = runner.window(seconds, sampled)
    host.stop(runner.log.rans_s)
    _phase("window", ctx["t_start"])
    samples = dict(runner.log.samples)
    missing = [n for n in sampled
               if n not in samples or "bins" not in samples[n]
               or n + 1 not in runner.log.handed]
    chain = chain_numbers(runner, {n: s for n, s in samples.items()
                                   if n not in missing},
                          dict(runner.log.handed), dict(runner.log.kind))
    # a decode cell's stream, made in set-up, judged as an encode run's
    samples.update({f"stream.{n}": s for n, s in getattr(
        runner, "encoded_samples", {}).items()})
    missing += [n for n in samples if isinstance(n, str)
                and "bins" not in samples[n]]
    types = runner.frame_types()
    metrics = runner.e2e(frames, elapsed)
    metrics["setup_s"] = setup_s
    layer_run = None
    if trace:
        rans_s = runner.log.rans_s
        tr, warp_calls = traced(runner, workdir)
        layer_run = {"trace": tr, "warp_calls": warp_calls,
                     "ops": runner.count_ops(), "frames": frames,
                     "elapsed": elapsed, "types": types, "rans_s": rans_s,
                     "warp_kernels": WARP_KERNELS}
        _phase("traced GOP and operation count", ctx["t_start"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    runner.free()
    numbers_of = runner.NUMBERS
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    judged = {n: s for n, s in samples.items() if n not in missing}
    numbers = dict(judge(ctx, judged, device), **chain)
    control = {lower: judge(ctx, judged, device, lower) for lower in controls}
    _phase("comparison", ctx["t_start"])
    ok, rows = jd.verdict(numbers, ctx["config"]["limits"], numbers_of)
    ok = ok and not missing
    return {"correct": ok, "attempted": frames, "failed": len(missing),
            "metrics": metrics, "layer_run": layer_run,
            "compared": rows, "peak": peak, "numbers": numbers,
            "control": control, "host": host.reading()}


def result_line(res, e2e, layer, trace, device_info, readers=None):
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"]}
    if not trace:
        out["metrics"] = {m["name"]: {"value": res["metrics"][m["name"]],
                                      "unit": m["unit"]} for m in e2e}
    else:
        run = res["layer_run"]
        metrics = {}
        for m in layer:
            value = (readers or {})[m["name"]](run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        device_info = dict(device_info, busy_s=run["trace"].busy_s,
                           window_s=run["trace"].window_s)
        out["breakdown"] = {"device_ops": run["trace"].top_ops(),
                            "idle_gaps": run["trace"].idle_gaps()}
    out["device"] = device_info
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in res["compared"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    try:
        bench = load_benchmark()
        ctx = find_cell(bench, args.workload)
        import torch

        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(ctx["cell"]["chips"]):
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {ctx['cell']['chips']}")
        if importlib.util.find_spec("lssvc_tpu_torch") is None:
            raise Refused("the program (lssvc_tpu_torch) is not in the "
                          "checkout")
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    e2e, layer = cell_metrics(bench, args.workload)
    readers = {m["name"]: load_reader(m["name"]) for m in layer} \
        if args.trace else None
    # one process with few threads: the host's CPU ops (the planes' host
    # copies) take one thread beside the main thread and the coder's worker
    torch.set_num_threads(1)
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    ctx.update(seed=args.seed, t_start=T_START)
    with tempfile.TemporaryDirectory(prefix="lssvc_bench_") as workdir:
        res = run_cell(ctx, device, args.seconds, bool(args.trace), workdir)
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(ctx["cell"]["chips"]),
                "memory_peak_bytes": int(res["peak"])}
        line = result_line(res, e2e, layer, bool(args.trace), info, readers)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad}", file=sys.stderr)
        return 3
    print("host " + json.dumps(res["host"]), file=sys.stderr)
    print("readings " + json.dumps(res["numbers"]), file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

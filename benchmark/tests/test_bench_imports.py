"""Nothing the benchmark loads imports JAX or the JAX package; the check
compares whole top-level names."""

import subprocess
import sys

from benchmark import run as R


def test_top_level_names_compared_whole():
    assert R.forbidden_modules(["lssvc_tpu_torch", "lssvc_tpu_torch.ops",
                                "jaxtyping", "flaxen"]) == []
    assert R.forbidden_modules(["lssvc_tpu.models", "jax.numpy",
                                "lssvc_tpu_torch"]) == ["jax", "lssvc_tpu"]
    assert R.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax",
                                                             "jaxlib"]


def test_harness_and_reference_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.run as R, benchmark.control\n"
        "import benchmark.reference.judge, benchmark.lib.system\n"
        "import benchmark.lib.readers, benchmark.lib.flops\n"
        "for m in ('idle_share.encode', 'mfu.encode'): R.load_reader(m)\n"
        "import lssvc_tpu_torch.harness.serving\n"
        "print(R.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.judge\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'lssvc_tpu_torch', 'lssvc_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_without_the_program_the_run_prints_nothing(tmp_path):
    """A checkout of only BENCHMARK.json and benchmark/ exits non-zero
    and prints no result line."""
    import shutil

    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(R.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "x2.encode.bf16",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

"""Cells, configurations, mixes and per-layer metrics are found by name."""

import json

import pytest

from benchmark import run as R


@pytest.fixture(scope="module")
def bench():
    return R.load_benchmark()


def test_every_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        ctx = R.find_cell(bench, cell["name"])
        assert ctx["config"]["name"] == cell["config"]
        assert ctx["mix"]["entry"] in R.ENTRIES
        assert set(ctx["config"]["limits"]) <= set(
            __import__("benchmark.reference.judge",
                       fromlist=["NUMBERS"]).NUMBERS)


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(R.load_reader(m["name"]))


def test_each_cell_reports_setup_another_e2e_and_a_layer_metric(bench):
    for cell in bench["workloads"]:
        e2e, layer = R.cell_metrics(bench, cell["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer
        # each per-layer metric moves an end-to-end metric the cell reports
        assert all(m["moves"] in names for m in layer)


def test_a_new_cell_needs_only_new_entries(bench, tmp_path):
    """A mix added as a file and a cell added as an entry are found with
    no edit of the harness."""
    added = json.loads(json.dumps(bench))
    added["workloads"].append(dict(
        bench["workloads"][0], name="x2.encode.bf16.trial",
        traffic="encode.gop32"))
    for m in added["end_to_end"] + added["per_layer"]:
        if "x2.encode.bf16" in m.get("workloads", ()):
            m["workloads"].append("x2.encode.bf16.trial")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    for c in bench["configs"]:
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text((R.ROOT / c["file"]).read_text())
    b2 = R.load_benchmark(tmp_path)
    ctx = R.find_cell(b2, "x2.encode.bf16.trial", root=tmp_path)
    assert ctx["mix"]["gop"] == 32
    e2e, layer = R.cell_metrics(b2, "x2.encode.bf16.trial")
    assert {m["name"] for m in e2e} == {"encode_fps", "setup_s"}
    assert {m["name"] for m in layer} == {
        m["name"] for m in bench["per_layer"]
        if "x2.encode.bf16" in m["workloads"]}


def test_unknown_cell_is_refused(bench):
    with pytest.raises(R.Refused):
        R.find_cell(bench, "no.such.cell")


def test_sampled_frames_come_from_the_seed():
    a = R.sampled_frames(2 ** 33 + 5, 32, 64)
    assert a == R.sampled_frames(2 ** 33 + 5, 32, 64)
    assert sum(t % 32 == 0 for t in a) == 1 and len(set(a)) == 3
    assert sum(t % 32 >= 16 for t in a) == 1
    # each is followed by a P-frame of its GOP, for the hand-off check
    assert all(t % 32 < 31 for t in a)
    assert all(0 <= t < 64 for t in a)


def test_p95_is_the_linear_percentile():
    assert R.p95(range(1, 101)) == pytest.approx(95.05)
    assert R.p95([7.0]) == 7.0

"""Every cell of BENCHMARK.json resolves to its configuration, traffic mix
and per-layer metric files, and the file keeps to the benchmark's
contract where a test can see it."""

import json
import re

import pytest

from slambench import cell as cells

BENCH = cells.load_json(cells.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    c = cells.resolve(workload, BENCH)
    assert c.chips == 1
    assert c.camera.width > 0 and c.traffic.ts.shape[0] > 0
    assert {m for m, _ in c.end_to_end} == {"setup_s", "frames_per_s",
                                            "frame_ms_p90"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(m.reader.read)


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("slambench/")
        assert cells.load_json(cells.ROOT / c["file"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_declared_metric_has_its_reader():
    # readers of metrics no cell reports yet may wait for the cell that
    # will (a later PR then adds entries, not code)
    files = {p.stem for p in (cells.BENCH_DIR / "metrics").glob("*.py")
             if p.stem != "__init__"}
    assert {m["name"] for m in BENCH["per_layer"]} <= files
    for name in files:
        reader = cells.load_reader(name)
        assert reader.MOVES in {m["name"] for m in BENCH["end_to_end"]}
        assert UNIT.match(reader.UNIT) and reader.LAYER


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (cells.BENCH_DIR / "traffic").glob("*.json")))
def test_every_traffic_mix_generates(mix):
    t = cells.traffic_of(cells.load_json(cells.BENCH_DIR / "traffic"
                                         / f"{mix}.json"))
    assert t.ts.shape == (t.yaws.shape[0], 3)
    assert t.profile_start + t.profile_frames < t.ts.shape[0]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cells.resolve("no.such.cell", BENCH)

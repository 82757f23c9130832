"""BENCHMARK.json and the files it names: names, units, the pieces found
by name, and the result line's keys."""

import json
import re
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_piece_is_found_by_name():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["kind"] in ("dagger", "train")
    for w in BENCH["workloads"]:
        wl = json.loads((ROOT / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["traffic"]["name"] == w["traffic"]
    for m in BENCH["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
        assert {m["moves"]} <= {e["name"] for e in BENCH["end_to_end"]}


def test_result_line_keys_and_checks_last():
    line = run.result_line(
        True, {"attempted": 5, "failed": 0}, {"pgd_it_s": {"value": 2.0, "unit": "it/s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 1}, [("loss_gap", 1e-6, 1e-3)],
        {"device_ops": [["k", 1.0]], "idle_gaps": [["aten::index", 0.5]]})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["checks"] == {"loss_gap": {"value": 1e-6, "limit": 1e-3}}
    never = json.loads(run.result_line(False, {"attempted": 0, "failed": 0}, {}, {},
                                       [("loss_gap", float("inf"), 1e-3)]))
    assert never["checks"]["loss_gap"]["value"] > 1e300


def test_cpu_device_is_refused_before_any_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "dagger-frcnn-4v", "--seed", str(2 ** 33), "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""

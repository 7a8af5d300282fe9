"""``tools/profile_sw_dse.py`` on the CPU at a reduced size: both engines
timed, the spans of every round, and a host profile that names the
engines' own functions."""
import importlib.util
import json
from pathlib import Path

import torch

from repro_torch.bench import bench_sw_dse

TOOL = Path(__file__).resolve().parents[1] / "tools" / "profile_sw_dse.py"


def test_profile_tool_reads_both_engines(monkeypatch, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("profile_sw_dse", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    # bench_sw_dse's 16 searches, a few short rounds
    monkeypatch.setattr(bench_sw_dse, "POOL", 4)
    monkeypatch.setattr(bench_sw_dse, "ROUNDS", 3)
    monkeypatch.setattr(bench_sw_dse, "K", 2)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = tool.main(["--device", "cpu", "--out", str(tmp_path / "p.json")])
    finally:
        torch.set_num_threads(n)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    assert json.loads((tmp_path / "p.json").read_text()) == res
    assert res["sizes"] == [16, 4, 3, 2]
    for engine in ("batched", "reference"):
        times = res["times"][engine]
        assert len(times) == tool.REPEATS
        assert all(t["s"] > 0 and len(t["gc"]) == 3 for t in times)
    assert [len(ms) for ms in res["spans"].values()] == [3, 3]
    batched, ref = res["host"]["batched"]["items"], res["host"]["reference"]["items"]
    assert batched["sw_dse._run_batched_body"]["calls"] == 1
    assert ref["sw_dse.optimize"]["calls"] == 16
    # refills: 2 a round, each search's initial pool of 3 random schedules
    assert batched["sw_space.random_schedule"]["calls"] == 16 * (3 + 3 * 2)
    assert "device_side" not in res and "replay" not in res

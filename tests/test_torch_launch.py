"""The port's command-line entry points on the CPU: `launch.serve` (batched
naive pipeline, a traced SLO stream whose export passes
`tools/trace_check.py`, chaos replicas under a deadline, a tiered index
under a device budget), `launch.scrub_index` against the reference's
`tools/scrub_index.py` (the same `--json` verdicts and exit codes on
clean and corrupted stores, generations written by either package, and
`--quarantine` on a plain spill directory) and a trimmed
`launch.soak_store` sweep (one crash point a stage, one kill -9
subprocess, the quick fuzz trials)."""
import importlib.util
import json
import os
import pathlib
import re
import shutil

import numpy as np
import pytest

from repro.core.tiered import TieredEcoVector as JTiered
from repro_torch.core import store_faults
from repro_torch.core.tiered import TieredEcoVector
from repro_torch.launch import scrub_index, serve, soak_store

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_scrub = _tool("scrub_index")
trace_check = _tool("trace_check")
SMALL = ["--device", "cpu", "--docs", "40", "--questions", "3",
         "--max-new", "3", "--slots", "2"]


@pytest.mark.parametrize("flags", [
    ["--pipeline", "naive"],
    ["--stream", "--slo-s", "0.5", "--trace-export"],
    ["--replicas", "2", "--chaos", "--deadline-s", "30"],
    ["--device-budget", "0.5", "--page-size", "16"],
], ids=["naive", "stream", "replicas", "budget"])
def test_serve_runs_on_cpu(flags, tmp_path, capsys):
    if flags[-1] == "--trace-export":
        flags = flags + [str(tmp_path / "t.jsonl")]
    assert serve.main(SMALL + flags) == 0
    out = capsys.readouterr().out
    assert "[serve] pipeline=" in out
    if "--stream" in flags:
        # SLO admission sheds by measured time: every request ends done
        # or shed, none failed
        assert "[serve --stream] 3 requests" in out
        ends = {k: int(v) for k, v in re.findall(
            r"\b(done|shed|failed|slo_shed)=(\d+)", out)}
        assert ends["failed"] == 0
        assert ends["done"] + ends["shed"] + ends["slo_shed"] == 3, out
        recs = trace_check.load_jsonl(tmp_path / "t.jsonl")
        assert recs and not trace_check.check_records(recs, complete=True)
    elif "--replicas" in flags:
        assert "[serve --replicas 2] 3 completions" in out
        assert "goodput=3/3" in out
    else:
        assert "model TTFT=" in out and "model energy=" in out
        assert "[serve] 3 answers" in out
    if "--device-budget" in flags:
        assert "[serve --device-budget] hot=" in out


def _tiered_root(tmp_path, writer):
    """A committed tiered generation at half the all-resident budget
    with one WAL'd insert, written by the port or by the reference."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 16)).astype(np.float32)
    kw = dict(n_clusters=6, M=8, ef_construction=32,
              storage_dir=str(tmp_path / "spill"))
    if writer == "port":
        idx = TieredEcoVector(16, device="cpu", **kw).build(X)
        idx.set_device_budget(int(0.5 * idx.all_resident_bytes()))
        idx.search_device_batched(X[:4], k=5, n_probe=4)
    else:
        idx = JTiered(16, **kw).build(X)
        idx.set_device_budget(int(0.5 * idx.all_resident_bytes()))
        idx.search_device_batched(X[:4], k=5, n_probe=4, use_pallas=False)
    root = str(tmp_path / "j")
    idx.save(root)
    idx.insert(10 ** 6, X[0])
    idx._journal.close()
    return root


def _scrub(main, argv, capsys):
    rc = main(argv + ["--json"])
    rep = json.loads(capsys.readouterr().out)
    return rc, rep


def _verdicts(rep, base):
    return [(os.path.relpath(r["item"], base), r["ok"])
            for r in rep["reports"]]


@pytest.mark.parametrize("state", ["clean", "corrupt"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_scrub_index_matches_reference(tmp_path, capsys, writer, state):
    root = _tiered_root(tmp_path, writer)
    if state == "corrupt":
        gen = os.path.join(root, sorted(n for n in os.listdir(root)
                                        if n.startswith("gen_"))[-1])
        victim = sorted(n for n in os.listdir(gen) if n.endswith(".seg"))[0]
        store_faults.flip_byte(os.path.join(gen, victim), 100)
    rc, rep = _scrub(scrub_index.main, [root], capsys)
    jrc, jrep = _scrub(ref_scrub.main, [root], capsys)
    assert rc == jrc == (0 if state == "clean" else 1)
    assert _verdicts(rep, root) == _verdicts(jrep, root)
    assert (rep["checked"], rep["corrupt"]) == \
        (jrep["checked"], jrep["corrupt"])
    assert rep["checked"] > 5 and (rep["corrupt"] > 0) == (state != "clean")
    assert any("tier" in r["item"] or "cold" in r["item"]
               for r in rep["reports"])


def test_scrub_index_quarantines_like_reference(tmp_path, capsys):
    """A truncated live spill file: both tools report it, --quarantine
    moves it aside, and --shallow skips the record walk."""
    root = _tiered_root(tmp_path, "port")
    spill = str(tmp_path / "spill")
    victim = sorted(n for n in os.listdir(spill) if n.endswith(".bin"))[0]
    store_faults.truncate_file(os.path.join(spill, victim), 20)
    copies = {}
    for who in ("port", "ref"):
        copies[who] = str(tmp_path / f"spill_{who}")
        shutil.copytree(spill, copies[who])
    rc, rep = _scrub(scrub_index.main, [copies["port"], "--quarantine"],
                     capsys)
    jrc, jrep = _scrub(ref_scrub.main, [copies["ref"], "--quarantine"],
                       capsys)
    assert rc == jrc == 1
    assert _verdicts(rep, copies["port"]) == _verdicts(jrep, copies["ref"])
    assert os.path.exists(os.path.join(copies["port"],
                                       victim + ".quarantined"))
    assert sorted(os.listdir(copies["port"])) == \
        sorted(os.listdir(copies["ref"]))
    rc, rep = _scrub(scrub_index.main, [root, "--shallow"], capsys)
    jrc, jrep = _scrub(ref_scrub.main, [root, "--shallow"], capsys)
    assert rc == jrc == 0 and _verdicts(rep, root) == _verdicts(jrep, root)
    assert scrub_index.main([root]) == 0
    assert "scrub:" in capsys.readouterr().out


def test_soak_crash_point_a_stage():
    points = soak_store.stage_points("cpu")
    assert len(points) == 3 and points == sorted(set(points))
    assert soak_store.crash_sweep(1, "cpu", points=points) == 3


def test_soak_kill9_subprocess():
    assert soak_store.kill9_sweep((52,), "cpu") == 1


def test_soak_fuzz_trials():
    assert soak_store.fuzz_sweep(6, "cpu") == 6

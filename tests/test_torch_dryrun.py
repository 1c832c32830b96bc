"""The port's dry run end to end on the CPU: one train cell and one
decode cell (a rank's tensor-parallel part) traced at full width on the
16 x 16 mesh (no plain version of a kernel in either trace), `roofline.report` over them and
`tools/roofline_diff.py` over two summaries; the decode caches each
family's prefill lays out; the retrieval dry run's sizing at 80 GB; the
MoE expert counts that replaced `bincount`."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, retrieval_dryrun
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.roofline import graph, report
from repro_torch.train import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIFF = os.path.join(ROOT, "tools", "roofline_diff.py")


@pytest.fixture(scope="module")
def cells_dir(tmp_path_factory):
    """gte-small train_4k and qwen2.5-0.5B decode_32k on pod1, with every
    plain kernel of `ref` made to raise: a dry-run trace must not reach
    one. The train cell runs as one microbatch, not the dry run's 4: the
    trace's time grows with their count (~3.5 s each on an idle host),
    and one still runs the FSDP gathers, the all-reduce and the remat."""
    out = tmp_path_factory.mktemp("dryrun")
    saved = {n: getattr(ref, n) for n in ops.KERNELS if hasattr(ref, n)}

    def refuse(*a, **k):
        raise AssertionError("a plain kernel version in a dry-run trace")
    try:
        chosen = trainer.microbatches_for(get_config("gte_small"), 256, 4096,
                                          dryrun.production_mesh(False))
        for n in saved:
            setattr(ref, n, refuse)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trainer, "microbatches_for", lambda *a, **k: 1)
            res = [dryrun.run_cell(a, s, False, out)
                   for a, s in (("gte_small", "train_4k"),
                                ("qwen25_0_5b", "decode_32k"))]
    finally:
        for n, f in saved.items():
            setattr(ref, n, f)
        dryrun.release()
    return out, res, chosen


def test_train_cell(cells_dir):
    _, (train, _), chosen = cells_dir
    assert train["status"] == "ok", train.get("traceback")
    assert chosen == 4
    assert train["chips"] == 256 and train["microbatches"] == 1
    # ZeRO-3: the masters gathered, the gradients summed over "data"
    assert train["collectives"]["n_all-gather"] > 0
    assert train["collectives"]["n_all-reduce"] > 0
    assert train["t_collective_s"] > 0
    cfg = get_config("gte_small")
    assert train["model_flops"] == 6 * cfg.active_param_count() * 256 * 4096
    # the remat's second forward and the "model" ranks' repeats: the
    # traced FLOPs pass 8 N T of each rank's rows
    n_rows = 256 // 16
    assert train["flops_per_device"] > 8 * cfg.param_count() * n_rows * 4096
    assert train["kernel_nodes"] == {}
    assert train["fits_hbm_80g"] is True


def test_decode_cell(cells_dir):
    """qwen2.5-0.5B's rank of pod1 holds its tensor-parallel part of tp
    16: its 14 heads do not split (attention whole), its FFN and
    vocabulary do; so one all-reduce a layer (the FFN's), one after the
    embedding and the logits' all-gather, and no other collective."""
    _, (_, decode), _ = cells_dir
    assert decode["status"] == "ok", decode.get("traceback")
    assert decode["rows_per_device"] == 8
    assert decode["kernel_nodes"] == {"decode_attention": 24}
    assert decode["dominant"] == "memory"
    assert decode["tp"] == {"tp": 16, "attn": False, "heads": 14,
                            "kv_heads": 2, "ffn": True, "vocab": True}
    coll = decode["collectives"]
    assert coll["n_all-reduce"] == 24 + 1 and coll["n_all-gather"] == 1
    assert coll["ops"] == 26 and decode["t_collective_s"] > 0
    # each layer reads its 8 rows' whole 32,768-slot cache once
    cfg = get_config("qwen25_0_5b")
    cache = 2 * 24 * 8 * 32768 * cfg.num_kv_heads * 64 * 2
    assert decode["hbm_bytes_per_device"] > cache
    assert decode["peak_bytes_per_device"] > cache


def test_report_and_roofline_diff(cells_dir, tmp_path, capsys):
    out, _, _ = cells_dir
    summary = dryrun.write_summary(out)
    s = json.loads(summary.read_text())
    assert s["n_ok"] == 2 and s["n_error"] == 0
    cell = s["cells"]["qwen25_0_5b.decode_32k.pod1"]
    assert set(cell) == set(dryrun.SUMMARY_KEYS) and cell["fits_hbm_80g"]
    report.main(["--dir", str(out), "--csv", str(tmp_path / "t.csv")])
    text = capsys.readouterr().out
    assert "| gte_small | train_4k | pod1 |" in text
    assert "| qwen25_0_5b | decode_32k | pod1 |" in text
    assert "hillclimb[paper_representative]" in text
    assert (tmp_path / "t.csv").read_text().startswith(
        ",".join(report.HDRS))
    # the same run twice: no regression; a slower memory term: one
    same = subprocess.run([sys.executable, DIFF, str(summary), str(summary)],
                          capture_output=True, text=True, timeout=60)
    assert same.returncode == 0 and "no regressions" in same.stdout
    worse = json.loads(summary.read_text())
    worse["cells"]["qwen25_0_5b.decode_32k.pod1"]["t_memory_s"] *= 1.5
    slower = tmp_path / "slower.json"
    slower.write_text(json.dumps(worse))
    diff = subprocess.run([sys.executable, DIFF, str(slower), str(summary)],
                          capture_output=True, text=True, timeout=60)
    assert diff.returncode == 1 and "SLOWER" in diff.stdout


@pytest.fixture
def one_thread():
    """One intra-op thread: the small models' many small ops run tens of
    times slower on a pool whose threads share the cores with other
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "granite_moe_1b_a400m",
                                  "whisper_small", "recurrentgemma_9b",
                                  "mamba2_780m", "qwen2_vl_2b"])
def test_decode_cache_is_the_prefills(arch, one_thread):
    """`decode_cache` lays out each family's cache as its prefill does
    (the reduced config, S past the window), and its decode step runs on
    it."""
    kw = dict(num_layers=5) if arch == "recurrentgemma_9b" else {}
    cfg = get_config(arch).reduced(dtype="float32", **kw)
    lm = build_model(cfg, device="cpu", seed=0)
    b, S = 2, 300
    if cfg.family == "encdec":
        frames = torch.zeros(b, cfg.encdec.cross_kv_len, cfg.d_model)
        _, want = lm.prefill(frames, torch.zeros(b, S, dtype=torch.long))
    elif cfg.modality == "vision":
        _, want = lm.prefill(torch.zeros(b, S, dtype=torch.long),
                             torch.zeros(b, 256, cfg.d_model))
    else:
        _, want = lm.prefill(torch.zeros(b, S, dtype=torch.long))
    got = dryrun.decode_cache(cfg, b, S)
    assert {n: (tuple(t.shape), t.dtype) for n, t in got.items()} == \
        {n: (tuple(t.shape), t.dtype) for n, t in want.items()}
    logits = lm.decode_step(got, torch.zeros(b, 1, dtype=torch.long), S - 1)
    assert logits.shape == (b, cfg.vocab_padded)


def test_retrieval_dryrun_sizes_one_h100(tmp_path, capsys):
    """0.6 of 80 GB at 528,388 bytes a cluster: 90,842 clusters a device,
    23,255,552 on the 16 x 16 mesh; the replicated centroids and the
    route's distances do not fit a card, and global ids pass int32."""
    assert retrieval_dryrun.cluster_bytes(1024, 128) == 528_388
    assert retrieval_dryrun.clusters_per_device() == 90_842
    try:
        res = retrieval_dryrun.run(False, out=str(tmp_path))
    finally:
        dryrun.release()
    assert "90,842 clusters a device" in capsys.readouterr().out
    assert res["n_clusters"] == 23_255_552 and res["chips"] == 256
    assert res["centroid_bytes_per_device"] == 23_255_552 * 128 * 4
    assert res["fits_hbm_80g"] is False and res["global_ids_past_int32"]
    # the scan from shapes: every probe distinct, every list full
    assert res["ecoscan"]["bytes"] >= 1024 * 16 * 1024 * 128 * 4
    assert res["t_collective_s"] > 0 and res["qps_bound"] > 0
    assert (tmp_path / "ecovector_retrieval.pod1.json").exists()


def test_moe_counts_equal_bincount():
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 7, (100,), generator=g)
    assert torch.equal(moe.counts(ids, 9), torch.bincount(ids, minlength=9))
    mode = graph.fake_mode()
    with mode:
        fake = torch.zeros(64, dtype=torch.long)
        assert moe.counts(fake, 8).shape == (8,)

"""The port stands alone: `repro_torch`, `chip_smoke.py` and the probes
in `tools/` import neither `jax` nor anything of the JAX package
`repro`."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)",
                             re.MULTILINE)


def test_import_with_jax_and_repro_blocked():
    code = f"""
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
# the wave path and the second configuration; the legacy SCR path and
# the baselines; the host index, its graphs and the paper's model; the
# MoE family, the family registry and the MoE configuration; the
# threefry draws of sampled decoding; serving under fire (the fault
# harness, the replica schedulers and their health tracker); tiering and
# durability (the tiered index, the store's crash and corruption faults)
for name in ("repro_torch.core.tiered", "repro_torch.core.store_faults",
             "repro_torch.serving.faults", "repro_torch.serving.scheduler",
             "repro_torch.dist.fault",
             "repro_torch.serving.sampling", "repro_torch.configs.h2o_danube_1_8b",
             "repro_torch.serving.engine", "repro_torch.models.dense",
             "repro_torch.core.scr", "repro_torch.core.pq",
             "repro_torch.core.baselines", "repro_torch.core.store",
             "repro_torch.data.synthetic", "repro_torch.core.hnsw",
             "repro_torch.core.ecovector", "repro_torch.core.analytical",
             "repro_torch.models.moe", "repro_torch.models.model",
             "repro_torch.configs.granite_moe_1b_a400m"):
    assert name in names, name
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampling import fold_in, prng_key, sample_rows
from repro_torch.kernels.ops import (decode_attention, flash_prefill,
                                     pq_adc, scr_score, decode_attention_q8,
                                     decode_attention_paged_q8)
from repro_torch.models.model import build_model, supports_paged
from repro_torch.models.moe import MoELM
from repro_torch.models.layers import quantize_kv, dequantize_kv
from repro_torch.core.scr import apply_scr
from repro_torch.core.baselines import ALL_BASELINES, make_index
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.tiered import ColdPack, TieredEcoVector, TierManager
from repro_torch.core.store import Journal, WriteAheadLog, loads
from repro_torch.core.store_faults import CrashPlan, count_fs_ops
from repro_torch.core.hnsw import HNSW
from repro_torch.core.analytical import search_latency_ms
from repro_torch.kernels.ops import KernelError, is_kernel_fault
from repro_torch.serving.trace import SLOController, load_jsonl
from repro_torch.serving.scheduler import Scheduler, SlotScheduler
from repro_torch.serving.faults import ChaosEngine, ChaosPipeline, FaultPlan
from repro_torch.dist.fault import HealthTracker
import chip_smoke
sys.path.insert(0, {str(ROOT / "tools")!r})
import attention_probe, kmeans_probe, launch_probe, retrieval_probe
import pq_probe, hnsw_probe
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 41


def test_no_jax_or_repro_import_lines():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "attention_probe.py",
        ROOT / "tools" / "kmeans_probe.py", ROOT / "tools" / "launch_probe.py",
        ROOT / "tools" / "pq_probe.py", ROOT / "tools" / "retrieval_probe.py",
        ROOT / "tools" / "hnsw_probe.py"]
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _BLOCKED_IMPORT.finditer(f.read_text())]
    assert len(files) > 20 and not bad, bad

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
# durability (the tiered index, the store's crash and corruption faults);
# the Table-5 pipelines, the paper's embedding model and the launchers;
# the rest of the model zoo (the mamba2, rglru and encdec families and
# the eight configurations they and the vision branch brought); training
# (the optimizer, the gradients' int8 round trip, the step, the LM data
# pipeline); checkpoints, the train launcher and sharding (the mesh, its
# collectives, the sharded retrieval); the dry run on the H100 cost model
# (the roofline package, the kernels' cost functions, the two launchers)
for name in ("repro_torch.roofline.hardware", "repro_torch.roofline.graph",
             "repro_torch.roofline.breakdown", "repro_torch.roofline.report",
             "repro_torch.kernels.cost", "repro_torch.launch.dryrun",
             "repro_torch.launch.retrieval_dryrun",
             "repro_torch.dist.checkpoint", "repro_torch.dist.sharding",
             "repro_torch.dist.collectives", "repro_torch.core.distributed",
             "repro_torch.launch.train", "repro_torch.launch.mesh",
             "repro_torch.train.optimizer", "repro_torch.train.grad_compress",
             "repro_torch.train.trainer", "repro_torch.data.pipeline",
             "repro_torch.models.mamba2", "repro_torch.models.rglru",
             "repro_torch.models.encdec", "repro_torch.configs.whisper_small",
             "repro_torch.configs.recurrentgemma_9b",
             "repro_torch.configs.mamba2_780m",
             "repro_torch.configs.qwen2_vl_2b", "repro_torch.configs.qwen2_72b",
             "repro_torch.configs.mistral_large_123b",
             "repro_torch.configs.nemotron_4_15b",
             "repro_torch.configs.arctic_480b",
             "repro_torch.serving.rag", "repro_torch.serving.embedder",
             "repro_torch.serving.slm", "repro_torch.configs.gte_small",
             "repro_torch.launch.serve", "repro_torch.launch.scrub_index",
             "repro_torch.launch.soak_store",
             "repro_torch.core.tiered", "repro_torch.core.store_faults",
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
from repro_torch.serving.rag import (PIPELINES, NaiveRAG, AdvancedRAG,
                                     EdgeRAG, MobileRAG, accuracy)
from repro_torch.serving.embedder import ModelEmbedder
from repro_torch.serving.slm import SLMGeneration
from repro_torch.configs import ARCH_IDS, get_config
assert get_config("gte_small").causal is False
from repro_torch.models.model import FAMILIES
from repro_torch.models.mamba2 import Mamba2LM, ssd_chunked
from repro_torch.models.rglru import RGLRULM, rglru_scan
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.layers import (apply_mrope, causal_conv1d,
                                       sinusoidal_positions)
from repro_torch.serving.engine import grow_cache
from repro_torch.convert import flat_names
for arch in ARCH_IDS:
    cfg = get_config(arch).reduced()
    FAMILIES[cfg.family](cfg, device="cpu")
assert len(ARCH_IDS) == 12
from repro_torch.launch import serve, scrub_index, soak_store
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.models.model import (IGNORE_LABEL, cast_params,
                                      count_params, loss_fn,
                                      make_sample_batch, masters, to_device)
from repro_torch.models.layers import attention
from repro_torch.models.moe import capacity_slots, train_ffn
from repro_torch.train.optimizer import (adamw_update, init_opt_state,
                                         lr_schedule, quantize_rows)
from repro_torch.train.grad_compress import (compress_decompress,
                                             compress_with_feedback)
from repro_torch.train.trainer import make_states, make_train_step
from repro_torch.data.pipeline import LMBatcher, Prefetcher, ShardSpec
from repro_torch.data.synthetic import lm_token_stream
from repro_torch.dist import checkpoint, fault, sharding
from repro_torch.dist.fault import (RestartManager, StepWatchdog,
                                    reshard_restore)
from repro_torch.core.distributed import (make_sharded_retrieval,
                                          reference_retrieval)
from repro_torch.models.moe import Q8AllGather, ep_ffn
from repro_torch.train.trainer import mesh_step, state_shardings
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.roofline.graph import trace_cost, fake_mode
from repro_torch.roofline.hardware import BF16_FLOPS_S, link_bytes_s
from repro_torch.roofline.report import interesting, markdown
from repro_torch.roofline.breakdown import breakdown
from repro_torch.kernels.cost import Cost, node, tracing
from repro_torch.launch.dryrun import run_cell, trace_cell, write_summary
from repro_torch.launch.retrieval_dryrun import clusters_per_device
from repro_torch.configs import cells, skipped_cells
from repro_torch.config import SHAPES
assert clusters_per_device() == 90842
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
    assert int(out.stdout.split()[-1]) >= 57


def test_no_jax_or_repro_import_lines():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "attention_probe.py",
        ROOT / "tools" / "kmeans_probe.py", ROOT / "tools" / "launch_probe.py",
        ROOT / "tools" / "pq_probe.py", ROOT / "tools" / "retrieval_probe.py",
        ROOT / "tools" / "hnsw_probe.py"]
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _BLOCKED_IMPORT.finditer(f.read_text())]
    assert len(files) > 20 and not bad, bad

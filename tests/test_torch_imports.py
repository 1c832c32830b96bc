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
# the IVF/PQ baselines
for name in ("repro_torch.configs.h2o_danube_1_8b",
             "repro_torch.serving.engine", "repro_torch.models.dense",
             "repro_torch.core.scr", "repro_torch.core.pq",
             "repro_torch.core.baselines", "repro_torch.core.store",
             "repro_torch.data.synthetic"):
    assert name in names, name
from repro_torch.serving.engine import Engine
from repro_torch.kernels.ops import (decode_attention, flash_prefill,
                                     pq_adc, scr_score)
from repro_torch.core.scr import apply_scr
from repro_torch.core.baselines import make_index
import chip_smoke
sys.path.insert(0, {str(ROOT / "tools")!r})
import attention_probe, kmeans_probe, launch_probe, retrieval_probe
import pq_probe
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 31


def test_no_jax_or_repro_import_lines():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "attention_probe.py",
        ROOT / "tools" / "kmeans_probe.py", ROOT / "tools" / "launch_probe.py",
        ROOT / "tools" / "pq_probe.py", ROOT / "tools" / "retrieval_probe.py"]
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _BLOCKED_IMPORT.finditer(f.read_text())]
    assert len(files) > 20 and not bad, bad

"""The training loss and its gradients of the encoder-decoder (whisper),
mamba2 and RG-LRU (recurrentgemma) families against the reference's
`jax.value_and_grad(repro.models.model.loss_fn)`, f32, every gradient at
`torch_parity.RTOL` by the port's flat names."""
import pytest

from repro_torch.models import model as tm
from repro_torch.models.encdec import DEC_RATIO
from torch_parity import (assert_loss_and_grads, loss_and_grads_pair,
                          one_thread, pair)

pytestmark = pytest.mark.usefixtures(one_thread.__name__)


@pytest.mark.parametrize("arch,S,over", [
    # 64 frames with 8 decoder tokens: the encoder not causal, the
    # decoder causal, cross-attention over the frames
    ("whisper_small", 64, {}),
    # 48 positions: a whole 32-position SSD chunk and a padded one
    ("mamba2_780m", 48, {}),
    # 5 layers: the pattern's blocks (r, r, a) once, then the tail
    # layers tail0, tail1 (both r); 96 positions past the 64 window
    ("recurrentgemma_9b", 96, {"num_layers": 5})])
def test_loss_and_grads_match_reference(arch, S, over):
    jcfg, jparams, cfg, lm = pair(arch, **over)
    batch = tm.make_sample_batch(cfg, 2, S, seed=7)
    ref_, port = loss_and_grads_pair(jcfg, jparams, lm, batch, z_coef=1e-4)
    assert_loss_and_grads(ref_, port, arch)
    if cfg.family == "encdec":
        assert batch["dec_tokens"].shape == (2, S // DEC_RATIO)
    if cfg.family == "rglru":
        assert any(n.startswith("tail1_") for n in port[2])
        assert cfg.rglru.local_window < S

"""The port's float32 train step against the JAX package's on the other
families, reduced, from bridged weights and the same numpy batches:
mamba2-130m (ssm) and zamba2-2.7b (hybrid), whose scans take their
gradient through ``SSDFn`` (on the CPU its plain backward,
``ref.ssd_bwd``), qwen3-moe-30b-a3b (its aux loss above 0) and
whisper-large-v3 (enc-dec, on zero frames, as the driver feeds it).
Three steps each with remat: every step's loss, ce, aux and grad_norm
within 1e-4 relative, and step 1's gradient leaves within
``1e-4 * max|g_leaf|`` (summation order).  One microbatch: the MoE aux
loss is a product of two batch means, so a microbatched step's gradient
is not the full batch's (in either package); reduced glm4-9b holds the
microbatched steps (``test_torch_train_parity.py``)."""
import pytest

from test_torch_train_parity import (  # noqa: F401 (_one_thread: an autouse fixture)
    _one_thread, assert_leaf_grads, assert_metrics, parity_steps)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b", "qwen3-moe-30b-a3b",
                                  "whisper-large-v3"])
def test_train_steps_match_jax(arch):
    steps, jgrads, tgrads = parity_steps(arch, 3, microbatches=1, remat=True)
    for jm, tm in steps:
        assert_metrics(tm, jm)
    assert_leaf_grads(tgrads, jgrads)
    if arch.startswith("qwen3"):
        assert float(steps[0][1]["aux"]) > 0

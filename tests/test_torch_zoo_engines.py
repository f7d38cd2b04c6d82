"""The rest of the dense family through the port's dense-cache engines
(static ``generate`` and ``serve_continuous``) against the JAX engines on
the same weights: the setup of ``tests/test_torch_zoo_serve.py`` (reduced
gemma2-27b, chameleon-34b, granite-20b and deepseek-67b, perturbed norm
weights, prompts past gemma2's window of 8).  Greedy tokens, and the
continuous engine's schedule, must be exactly equal.
"""
import numpy as np
import pytest

from repro.serve import engine as jeng
from repro_torch.serve import engine as teng
from test_torch_zoo_serve import _engines, _prompts, _requests, weights  # noqa: F401

def test_generate_tokens_equal_jax(weights):
    cfg = weights[0]
    jengine, tengine = _engines(weights)
    prompts = _prompts(cfg, seed=9)[:3]
    want = jengine.generate(prompts, max_new_tokens=5)
    got = tengine.generate(prompts, max_new_tokens=5)
    assert got.tokens.shape == (3, 5)
    np.testing.assert_array_equal(got.tokens, want.tokens)


class VirtualClock:
    """A clock that advances one unit per read: deterministic timings."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_serve_continuous_equals_jax(weights):
    cfg = weights[0]
    jengine, tengine = _engines(weights)
    prompts = _prompts(cfg, seed=10)
    want = jengine.serve_continuous(_requests(jeng, prompts), num_slots=2, clock=VirtualClock())
    got = tengine.serve_continuous(_requests(teng, prompts), num_slots=2, clock=VirtualClock())
    assert [(r.request_id, r.slot, r.admit_step, r.finish_step, r.tokens.tolist())
            for r in got.results] == \
        [(r.request_id, r.slot, r.admit_step, r.finish_step, r.tokens.tolist())
         for r in want.results]
    assert got.steps == want.steps

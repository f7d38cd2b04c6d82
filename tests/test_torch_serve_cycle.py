"""What a finished static serve keeps alive, with the cycle collector off.

``serve_static`` hands ``RequestScheduler`` a closure over its engine.
Each request and its ``CompletionFuture`` point at each other, and a
future used to keep its scheduler, so the futures held the engine, its
model and its weights until the collector ran.  A done future now drops
its scheduler: when the caller drops the engine, reference counting alone
frees its weights.  Both tests run with ``gc`` disabled and call no
``gc.collect()`` between the run and the check."""
import gc
import weakref

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models import DecoderLM
from repro_torch.serve import engine as teng
from repro_torch.serve import scheduler as tsch


@pytest.fixture
def no_collector():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _engine(cfg):
    model = DecoderLM(cfg, device="cpu")
    return teng.ServingEngine(model, model.init(seed=0), max_batch=2, max_seq=32, device="cpu")


def test_serve_static_frees_the_engine_when_the_caller_drops_it(no_collector):
    cfg = get_config("glm4-9b", reduced=True)
    engine = _engine(cfg)
    weight = weakref.ref(engine.params["embed"])
    model = weakref.ref(engine.model)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in (4, 9, 6)]
    run = tlaunch.serve_static(engine, prompts, [0.0, 0.0, 0.02], 2, batch_timeout_ms=1.0,
                               log=lambda _: None)
    assert len(run.tokens) == 3 and run.sched_stats["completed"] == 3.0
    del engine
    assert model() is None and weight() is None


@pytest.mark.parametrize("threaded", [True, False])
def test_scheduler_frees_execute_once_the_caller_drops_it(no_collector, threaded):
    class Execute:
        def __call__(self, batch):
            return [r.payload * 10 for r in batch]

    execute = Execute()
    alive = weakref.ref(execute)
    sched = tsch.RequestScheduler(execute, tsch.SchedulerConfig(max_batch=2,
                                                                batch_timeout_ms=1.0))
    if threaded:
        sched.start()
    futs = [sched.submit(payload=i) for i in range(5)]
    assert [f.result(timeout=30) for f in futs] == [0, 10, 20, 30, 40]
    sched.stop()
    del sched, execute
    assert alive() is None
    # the futures outlive their scheduler and still answer
    assert all(f.done() for f in futs) and [f.result() for f in futs] == [0, 10, 20, 30, 40]
    assert [f.request.status for f in futs] == ["completed"] * 5

"""Paged serving of full-width glm4-9b from one checkout of the port, at
``chip_smoke.py``'s serve shapes (16 requests, prompts 64-1024, 32 new
tokens, 8 slots, page 16, prefill budget 2048, random bf16 weights from
seed 0): one warm-up, then three runs of the same requests.  Prints one
line, ``AB <label>: ...``, with the median prefill tok/s, TTFT p50 and
decode step, and each run's.

Compare two commits on one card by running it for each in turn, in one
chip call, in the order parent, change, change, parent::

    git archive <parent> | tar -x -C build/parent
    for t in parent change change parent; do
      python tools/paged_ab.py $([ $t = parent ] && echo build/parent || echo .) $t
    done

Each checkout builds its own kernels into its own ``build/``.
"""
import sys
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root / "src"))

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import engine_metrics, make_requests  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

if not Path(repro_torch.__file__).resolve().is_relative_to(root):
    raise SystemExit(f"imported {repro_torch.__file__}, not the checkout {root}")
dev = torch.device("cuda")
cfg = get_config("glm4-9b")
model = DecoderLM(cfg, device=dev, dtype=torch.bfloat16)
params = model.init(seed=0)
engine = ServingEngine(model, params, max_batch=8, max_seq=2048, page_size=16, device=dev)
serve = lambda reqs: engine.serve_paged(reqs, num_slots=8, page_size=16, prefill_budget=2048)
serve(make_requests(2, 16, 32, 4, cfg.vocab_size, 1))
reqs = make_requests(16, 64, 1024, 32, cfg.vocab_size, 0)
runs = []
for _ in range(3):
    m = engine_metrics(serve(reqs))
    runs.append((m["prefill_tok_per_s"], m["ttft_p50_ms"], m["decode_step_ms"]))
med = [sorted(r[j] for r in runs)[1] for j in range(3)]
print(f"AB {sys.argv[2]}: prefill_tok_per_s {med[0]:.1f} ttft_p50_ms {med[1]:.1f} "
      f"decode_step_ms {med[2]:.3f}; runs {[tuple(round(x, 1) for x in r) for r in runs]}",
      flush=True)

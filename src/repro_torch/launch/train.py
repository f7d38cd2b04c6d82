"""End-to-end training driver (the port's ``repro.launch.train``).

Runs real optimization steps on one device, the card unless ``--device
cpu``: synthetic token data with cursor resume, atomic checkpoints,
checkpoint-restart, loss logging into the platform's evaluation database.
The masters and the AdamW moments are float32; the model computes in
``--dtype`` (bf16 on the card, float32 on the CPU).  The default
``--arch`` is mamba2-130m, as in the reference.  Each parameter takes ~18
bytes to train (masters, gradients, moments, the bf16 copy): at published
width glm4-9b's 9.4 B parameters fit no one card, so there train it
``--reduced``, or reduce the depth in a config of your own; the driver
refuses what does not fit before it allocates anything.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
        --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --ckpt-every 20
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..configs import get_config, list_archs
from ..core.evaldb import EvalDB, EvaluationRecord
from ..device import DTYPES, resolve_device, resolve_dtype
from ..models.lm import build_model
from ..train.checkpoint import CheckpointManager
from ..train.data import SyntheticTokenDataset, make_loader
from ..train.optimizer import OptimizerConfig, init_opt_state, tree_leaves
from ..train.step import make_train_step

# bytes a parameter takes to train: float32 master, gradient, m and v
TRAIN_BYTES_PER_PARAM = 16


def train_fits(cfg, compute_dtype: torch.dtype, capacity: int) -> Optional[str]:
    """None if ``cfg``'s masters, gradients, moments and compute copy fit
    ``capacity`` bytes, else why not."""
    copy = 0 if compute_dtype == torch.float32 else torch.empty(
        (), dtype=compute_dtype).element_size()
    need = cfg.param_count() * (TRAIN_BYTES_PER_PARAM + copy)
    if need <= capacity:
        return None
    return (f"{cfg.name} needs {need / 2**30:.1f} GiB to train (float32 masters, gradients and "
            f"AdamW moments, and the {compute_dtype} copy), more than the device's "
            f"{capacity / 2**30:.1f} GiB: train it --reduced")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain path)")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="compute dtype (default: bfloat16 on cuda, float32 on cpu); the "
                         "masters and moments are float32")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--evaldb", default="")
    ap.add_argument("--log-every", type=int, default=5)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    model = build_model(cfg, device, resolve_dtype(args.dtype, device))
    opt_cfg = OptimizerConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps
    )
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches, remat=True)
    if device.type == "cuda":
        why = train_fits(cfg, model.dtype, torch.cuda.get_device_properties(device).total_memory)
        if why:
            raise MemoryError(why)
    params = model.init(0, dtype=torch.float32)
    opt_state = init_opt_state(model.param_defs(), opt_cfg, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params:,} params")

    start_step, cursor = 0, 0
    mgr: Optional[CheckpointManager] = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        if args.resume and mgr.latest_step() is not None:
            params, opt_state, meta = mgr.restore(
                params_template=params, opt_template=opt_state
            )
            start_step = int(meta["step"])
            cursor = int(meta.get("data_cursor", 0))
            print(f"[train] resumed from step {start_step} (cursor {cursor})")

    data = SyntheticTokenDataset(cfg.vocab_size, args.seq, seed=0)
    loader = make_loader(data, args.batch, skip=cursor)
    db = EvalDB(args.evaldb) if args.evaldb else None

    losses = []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        cursor, batch = next(loader)
        tbatch = {"tokens": torch.as_tensor(batch["tokens"], device=device)}
        if cfg.family == "encdec":
            tbatch["frames"] = torch.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model), dtype=torch.float32, device=device
            )
        params, opt_state, metrics = step_fn(params, opt_state, tbatch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if (step + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            tps = args.batch * args.seq * args.log_every / dt
            print(
                f"[train] step {step+1:5d} loss={loss:.4f} "
                f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.2f} "
                f"tok/s={tps:,.0f}"
            )
            t0 = time.perf_counter()
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            path = mgr.save(step + 1, params, opt_state, extra={"data_cursor": cursor})
            print(f"[train] checkpoint -> {path}")
    if db is not None:
        db.insert(
            EvaluationRecord(
                model=cfg.name, model_version="1.0.0", backend="torch",
                backend_version="1.0.0", system="local", scenario="train",
                batch_size=args.batch, trace_level="NONE", agent_id="train-driver",
                metrics={"final_loss": losses[-1], "first_loss": losses[0]},
            )
        )
        db.close()
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())

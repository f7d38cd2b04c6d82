"""Training example on the PyTorch port: train reduced mamba2-130m for a
few dozen steps with checkpoint/restart (kill it mid-run and re-run it: it
continues from the last atomic checkpoint and the exact data cursor).  The
torch twin of ``examples/train_lm.py``, with the same flags.  Extra flags
pass through to the driver: ``--device cpu`` runs the plain PyTorch path
(without it, the card).

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import sys

from repro_torch.launch.train import main

raise SystemExit(
    main([
        "--arch", "mamba2-130m",
        "--reduced",
        "--steps", "60",
        "--batch", "8",
        "--seq", "64",
        "--ckpt-dir", "build/train-lm-ckpt",
        "--ckpt-every", "20",
        "--resume",
        *sys.argv[1:],
    ])
)

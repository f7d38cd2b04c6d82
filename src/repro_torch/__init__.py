"""PyTorch/CUDA port of the ``repro`` serving stack for one NVIDIA H100.

The package imports ``torch`` and never ``jax``, and nothing of ``repro``:
what it needs from there it keeps as its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper runs its plain PyTorch version.
"""

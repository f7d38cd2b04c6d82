"""Serving kernels: plain PyTorch versions (:mod:`.ref`), hand-written CUDA
kernels for sm_90a (``csrc/``, built by :mod:`._build`) and their wrappers,
dispatched by device in :mod:`.ops`."""

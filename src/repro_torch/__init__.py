"""PyTorch/CUDA port of the Parallel-FIMI miner.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``data/``, ``launch/``) and imports nothing of it.  Entry points run on CUDA
unless the caller passes ``device="cpu"``; see :mod:`repro_torch.device`.
"""

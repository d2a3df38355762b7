"""PyTorch/CUDA counterpart of :mod:`repro` (the Datalog° main path).

The package mirrors ``src/repro/`` module for module
(``repro/X/y.py`` → ``repro_torch/X/y.py``) and imports ``torch``,
``numpy`` and the standard library only — never ``jax`` and nothing of
``repro``.  Entry points run on the GPU unless the caller asks for the
CPU (:func:`repro_torch.device.resolve`); the five Pallas kernels of
the reference are hand-written CUDA C++ under ``csrc/``
(:mod:`repro_torch.kernels`), each with a plain PyTorch version that
the CPU path and the parity tests use.
"""

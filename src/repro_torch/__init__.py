"""repro_torch: the PyTorch/CUDA port of ``repro`` (Don't Persist All).

A package of its own beside the JAX reference.  It mirrors ``repro``
module for module, keeps its class, function, stage and region names, and
writes byte-identical persistent images.  Volatile state lives on a CUDA
device unless the caller passes ``device="cpu"``; the hot paths run
hand-written Hopper kernels (``kernels/``, sources in ``csrc/``).
"""

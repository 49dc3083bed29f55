"""pt_three_ways_tpu_torch — the PyTorch/CUDA port of pt_three_ways_tpu.

A path tracer with the capability set of mattgodbolt/pt-three-ways, running
on an NVIDIA H100 through hand-written CUDA kernels (``csrc/``) with a plain
PyTorch version beside each one. It imports ``torch`` and ``numpy`` only;
the JAX package beside it is the reference its tests compare against.

Layout mirrors the JAX package: ``utils/`` (params, framebuffer, PNG, OBJ),
``ops/`` (RNG, vector math, camera, intersection, the kernels),
``models/`` (materials, scene, catalog, integrator, render, replay),
``parallel/`` (the training step) and ``cli.py``.
"""

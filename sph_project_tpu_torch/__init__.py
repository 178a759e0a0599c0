"""PyTorch + CUDA port of sph_project_tpu for an NVIDIA H100.

The JAX package beside it is the reference; this package imports nothing of
it and nothing of JAX. Entry points: ``scene.load_scene`` and
``sim.Simulation`` (``.step()``, ``.run(n)``). The hand-written CUDA kernels
live in ``csrc/`` and are built with ``nvcc`` on first use.
"""

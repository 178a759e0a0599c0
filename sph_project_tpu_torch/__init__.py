"""PyTorch + CUDA port of sph_project_tpu for an NVIDIA H100.

The JAX package beside it is the reference; this package imports nothing of
it and nothing of JAX. Entry points: ``scene.load_scene`` and
``sim.Simulation`` (``.step()``, ``.run(n)``), and the CLI driver
``cli.main`` (``run_simulation_torch.py``, ``python -m
sph_project_tpu_torch``) with checkpoints, exports, telemetry and a live
viewer in ``io/`` and ``utils/telemetry.py``. The hand-written CUDA kernels
live in ``csrc/`` and are built with ``nvcc`` on first use. ``native.py``
binds the repository's C++ host helpers (``native/``), which the scene
loader's inside test and the offline scripts at the repository's root
(``surface_reconstruction_torch.py``, ``render_torch.py``) use.
"""

"""Run a scene JSON with the PyTorch + CUDA port: the flags and output layout
of ``run_simulation.py``, on the GPU unless ``--device cpu`` is given
(``sph_project_tpu_torch/cli.py``).

    python run_simulation_torch.py --scene_file data/scenes/large_scale_dfsph.json
"""
from sph_project_tpu_torch.cli import main

if __name__ == "__main__":
    main()

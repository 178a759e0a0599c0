"""``python -m sph_project_tpu_torch --scene_file ...``: the CLI driver
(:mod:`sph_project_tpu_torch.cli`)."""
from .cli import main

main()

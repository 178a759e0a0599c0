"""Scene JSON config, schema-compatible with the reference.

Mirrors ``SPH/utils/config_builder.py:5-44`` (jason-huang03/SPH_Project): the
same top-level sections (``Configuration``, ``FluidBlocks``, ``FluidBodies``,
``RigidBodies``, ``RigidBlocks``) and the same ``None``-for-absent-key
behavior, so every scene file under the reference's ``data/scenes/`` loads
unchanged.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List


class SimConfig:
    def __init__(self, scene_file_path: str | None = None,
                 config: Dict[str, Any] | None = None) -> None:
        if config is not None:
            self.config = config
        else:
            with open(scene_file_path, "r") as f:
                self.config = json.load(f)

    def get_cfg(self, name: str, enforce_exist: bool = False):
        conf = self.config.get("Configuration", {})
        if name not in conf:
            if enforce_exist:
                raise KeyError(name)
            return None
        return conf[name]

    def get_rigid_bodies(self) -> List[Dict[str, Any]]:
        return self.config.get("RigidBodies", [])

    def get_rigid_blocks(self) -> List[Dict[str, Any]]:
        return self.config.get("RigidBlocks", [])

    def get_fluid_bodies(self) -> List[Dict[str, Any]]:
        return self.config.get("FluidBodies", [])

    def get_fluid_blocks(self) -> List[Dict[str, Any]]:
        return self.config.get("FluidBlocks", [])

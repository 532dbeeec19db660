"""Config files and the reference's checkpoint merge-on-load rule
(posfeat_tpu/core/config.py; reference trainer.py:53-63,
extractor.py:62-68).

``yaml`` is imported only where a file is read: ``dump_config`` writes
JSON, which is valid YAML, so the JAX package's ``load_config`` reads it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def dump_config(config: Dict[str, Any], path: str) -> None:
    """Write ``config`` as JSON through a temporary file moved into place,
    so that processes that write one run's file (extraction shards) never
    leave it torn."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(config, f, indent=2)
    os.replace(tmp, path)


def merge_from_checkpoint(config: Dict[str, Any]) -> Dict[str, Any]:
    """If config has load_path, merge the checkpoint run's model section.

    load_path points at an epoch dir (e.g. ckpts/descriptor/010); the
    run-level config.yaml lives one directory up.
    """
    load_path = config.get("load_path")
    if not load_path:
        return config
    cfg_path = os.path.join(os.path.dirname(str(load_path).rstrip("/")), "config.yaml")
    if not os.path.exists(cfg_path):
        return config
    pre = load_config(cfg_path)
    merged = dict(config)
    model_cfg = dict(merged.get("model_config") or {})
    model_cfg.update(pre.get("model_config") or {})
    merged["model_config"] = model_cfg
    if "model" in pre:
        merged["model"] = pre["model"]
    return merged

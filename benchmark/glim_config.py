"""The deployment's GLIM configuration tree, as the configuration file freezes
it, written out for one run; and the preprocessing parameters the reference
reads from that same tree."""

from __future__ import annotations

import json
import os


def config_dir(config: dict, root: str) -> str:
    """Write the configuration file's ``glim`` tree (config.json and every file
    it selects) under ``root``, with ``${TMPDIR}`` read as ``root``."""
    path = os.path.join(root, "config")
    os.makedirs(path, exist_ok=True)
    for fname, data in config["glim"].items():
        text = json.dumps(data, indent=2).replace("${TMPDIR}", root)
        with open(os.path.join(path, fname), "w") as f:
            f.write(text)
    return path


def preprocess_params(config: dict) -> dict:
    """The ``preprocess`` section of the file config.json selects, and the
    upload's quantization step."""
    fname = config["glim"]["config.json"]["global"]["config_preprocess"]
    return dict(config["glim"][fname]["preprocess"],
                quantize_resolution=config["quantize_resolution"])

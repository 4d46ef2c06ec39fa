"""Checkpoint / resume (≙ irgs_tpu/utils/checkpoint.py).

A checkpoint is a nested dict of tensors and numbers written with
`torch.save` and read back with `torch.load(weights_only=True)`, so loading
one runs no pickled code; beside it, `<path>.json` holds the same manifest
as the JAX package's (`iteration`, plus `extra`). The JAX package's
flax-serialized checkpoints are not read: the PLY and its envmap sidecars
are the artifact that crosses between the two packages.
"""

from __future__ import annotations

import json
import os
import sys

import torch


def save_checkpoint(path: str, tensors: dict, iteration: int,
                    extra: dict | None = None) -> None:
    """Write `tensors` to `path` and the manifest to `path`.json."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(tensors, path)
    manifest = {"iteration": int(iteration), **(extra or {})}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def load_checkpoint(path: str, device) -> tuple[dict, dict]:
    """-> (the tensors on `device`, the manifest; {} without one)."""
    tensors = torch.load(path, map_location=device, weights_only=True)
    manifest = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            manifest = json.load(f)
    return tensors, manifest


def save_cmd_provenance(model_path: str) -> None:
    """≙ cmd.txt command provenance (train.py:305-309)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cmd.txt"), "a") as f:
        f.write(" ".join(sys.argv) + "\n")

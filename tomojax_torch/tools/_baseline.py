"""Helpers shared by the BASELINE config scripts (``config1``-``config5``)."""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch

from tomojax_torch.core.operators import resolve_device


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def device_record(device) -> dict:
    """The device a run used: its type and, on a card, its name and
    ``nvidia-smi``'s name and power limit."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"type": dev.type, "name": "cpu"}
    return {"type": dev.type, "name": torch.cuda.get_device_name(dev),
            "smi": smi_line()}


def rel_l2(x, ref) -> float:
    """‖x − ref‖ / ‖ref‖ in float64 on the host."""
    x, ref = (np.asarray(torch.as_tensor(a).detach().cpu(), np.float64)
              .ravel() for a in (x, ref))
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def write(rec: dict, path):
    """Write ``rec`` as JSON to ``path`` (if given)."""
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print("wrote", path)

"""Helpers shared by the BASELINE config drivers (``config1``-``config3``)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from tomojax_torch.core.operators import resolve_device


def device_record(device) -> dict:
    """The device a run used: its type and, on a card, its name."""
    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"type": dev.type, "name": name}


def timed(fn, device):
    """``(fn(), wall seconds)``, synchronizing the card before reading the
    clock."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def rel_l2(x, ref) -> float:
    """‖x − ref‖ / ‖ref‖ in float64 on the host."""
    x = np.asarray(torch.as_tensor(x).detach().cpu(), np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def write(rec: dict, path):
    """Write ``rec`` as JSON to ``path`` (if given)."""
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print("wrote", path)

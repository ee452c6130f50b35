"""Checkpoints in the reference's own format (reference: train.py:208-217):
one ``epoch-NNN.pt`` per epoch, written with ``torch.save`` as

    {"model": state_dict, "ema": state_dict (when ema > 0),
     "optimizer": {...}, "epoch": int}

which the port's ``predict`` reads as ``path.pt:model`` / ``path.pt:ema``
(utils/weights.py::load_checkpoint).  Saving is synchronous.  The JAX
package's orbax checkpoints and resume are not ported (ROADMAP).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

__all__ = ["save_checkpoint", "training_checkpoint"]


def _to_cpu(obj: Any) -> Any:
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def training_checkpoint(state, epoch: int) -> Dict[str, Any]:
    """The dict an epoch checkpoint holds, on the CPU."""
    obj = {"model": state.model.state_dict(),
           "optimizer": {**state.optimizer.state_dict(), "step": state.step},
           "epoch": epoch}
    if state.ema_model is not None:
        obj["ema"] = state.ema_model.state_dict()
    return _to_cpu(obj)


def save_checkpoint(path: str, obj: Any) -> str:
    """``torch.save`` to ``path`` through a temporary file, so a reader never
    sees a half-written checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path

"""ImageNet classification training — the training entry point of the port.

Same command line as the JAX package's ``train.py`` (reference
train.py:389-396), plus ``--device`` (default ``cuda``):

    python -m vision_transformers_tpu_torch.train --conf configs/vit-s-16.conf \\
        precision=f32 [--device cuda] [key=value ...]

``--n_gpu`` is accepted as an alias of ``--n_device``; only one device is
ported.  Asked for CUDA where there is none, it raises; it never moves to
the CPU.  ``--device cpu`` runs the kernels' plain versions (tests).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..config.schema import load_config
from ..predict import resolve_device
from .trainer import train_classification

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--conf", required=True)
    parser.add_argument("--n_device", "--n_gpu", type=int, default=0, dest="n_device")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value conf overrides")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    # f32 training stays full precision: no TF32 in the conv or the matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = load_config(args.conf, args.overrides)
    if args.n_device:
        conf.n_device = args.n_device
    return train_classification(conf, device)

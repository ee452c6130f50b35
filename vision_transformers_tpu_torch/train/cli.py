"""ImageNet classification training — the training entry point of the port.

Same command line as the JAX package's ``train.py`` (reference
train.py:389-396), plus ``--device`` (default ``cuda``):

    python -m vision_transformers_tpu_torch.train --conf configs/vit-s-16.conf \\
        [--device cuda] [key=value ...]

The conf's ``precision`` (bf16 by default, as in the JAX schema) sets the
compute dtype; ViT computes in bf16, the other models need ``precision=f32``.

``--n_gpu`` is accepted as an alias of ``--n_device``; only one device is
ported.  Asked for CUDA where there is none, it raises; it never moves to
the CPU.  ``--device cpu`` runs the kernels' plain versions (tests).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..config.schema import load_config
from ..predict import resolve_device
from .trainer import full_precision_products, train_classification

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--conf", required=True)
    parser.add_argument("--n_device", "--n_gpu", type=int, default=0, dest="n_device")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value conf overrides")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    full_precision_products()
    conf = load_config(args.conf, args.overrides)
    if args.n_device:
        conf.n_device = args.n_device
    return train_classification(conf, device)

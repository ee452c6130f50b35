"""Classify images from files — the serving-style entry point of the port.

Same flags and output as the JAX package's ``predict.py``, plus
``--device`` (default ``cuda``) and ``--precision`` (default ``f32``;
``conf`` computes in the conf's precision, as the trainer does, for the
arch types ported at bf16):

    python -m vision_transformers_tpu_torch.predict --conf configs/vit-s-16.conf \\
        --checkpoint ckpt.pt:ema cat.jpg dog.jpg [--topk 5] [--labels names.txt]

Prints one JSON line per image: {"file": ..., "topk": [{"class": i,
"prob": p, "label": name?}, ...]}.  Asked for CUDA where there is none, it
raises; it never moves to the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import ops
from .config.schema import load_config
from .data.ops import normalize
from .data.pipeline import decode_valid
from .train.trainer import BF16_ARCHS, compute_dtype
from .utils.weights import load_checkpoint

__all__ = ["predict_batch", "main"]


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available here "
                           f"(pass --device cpu to run on the CPU)")
    return dev


@torch.no_grad()
def predict_batch(model: torch.nn.Module, images: np.ndarray, topk: int,
                  device: torch.device | str
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One forward of uint8 NHWC ``images`` on ``device`` under
    :func:`ops.forward_only` → (logits [B, n_class] f32, top-k classes
    [B, k], their softmax probabilities [B, k])."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    with ops.forward_only():
        logits = model(normalize(x).permute(0, 3, 1, 2))
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = torch.topk(probs, min(topk, probs.shape[-1]), dim=-1)
    return logits.float().cpu().numpy(), top_i.cpu().numpy(), top_p.cpu().numpy()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--conf", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="reference .pt[:key] (model / ema)")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--labels", default=None,
                        help="text file with one class name per line")
    parser.add_argument("--size", type=int, default=0,
                        help="eval resolution (default: conf training.valid_size)")
    parser.add_argument("--no-ema", action="store_true",
                        help="accepted for parity; a .pt picks its state_dict by :key")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--precision", default="f32", choices=("f32", "conf"),
                        help="f32, or conf: the conf's compute dtype (bf16 by default)")
    parser.add_argument("images", nargs="+",
                        help="image files to classify; key=value conf overrides "
                             "may be mixed in")
    args, extras = parser.parse_known_args(argv)
    # argparse folds trailing key=value overrides into the positional list
    overrides = [a for a in args.images if "=" in a] + \
                [o for o in extras if "=" in o]
    images = [a for a in args.images if "=" not in a]
    if not images:
        parser.error("no image files given")
    device = resolve_device(args.device)
    # inference stays full precision: no TF32 in the conv or the matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    conf = load_config(args.conf, overrides)
    size = args.size or conf.training.valid_size
    dtype = compute_dtype(conf) if args.precision == "conf" else torch.float32
    if dtype != torch.float32 and conf.arch.type not in BF16_ARCHS:
        raise NotImplementedError(f"--precision conf: arch type {conf.arch.type!r} has no "
                                  f"bf16 form yet (ROADMAP.md §A2's bf16 queue)")
    model = conf.arch.make(dtype=dtype) if dtype != torch.float32 else conf.arch.make()
    model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
    model.to(device).eval()

    labels = None
    if args.labels:
        with open(args.labels) as f:
            labels = [line.strip() for line in f]

    batch = []
    for path in images:
        with open(path, "rb") as f:
            batch.append(decode_valid(f.read(), size))
    _, top, prob = predict_batch(model, np.stack(batch), args.topk, device)
    for path, idx, p in zip(images, top, prob):
        entry = {"file": path, "topk": [
            {"class": int(i), "prob": round(float(q), 5),
             **({"label": labels[i]} if labels and i < len(labels) else {})}
            for i, q in zip(idx, p)
        ]}
        print(json.dumps(entry))


if __name__ == "__main__":
    main()

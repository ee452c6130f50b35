#!/usr/bin/env python
"""Write tests/data/vit_s16_port_train_golden.npz: one f32 train-step
gradient of the JAX package for ViT-S/16 at 224 (configs/vit-s-16.conf,
depth 12, drop_path 0) on its CPU einsum path, for two seeded images and
labels and seeded weights.  With ``--dropout``, write
tests/data/vit_s16_port_dropout_train_golden.npz instead: the same step at
``dropout = drop_ff = 0.1`` on the packed-qkv attention kernel
(``fused_attention_qkv``, forced, in Pallas interpret mode), every
``nn.Dropout`` mask replaced, in call order, by the seeded masks of
``utils/weights.seeded_dropout_masks`` (through
``flax.linen.intercept_methods``; nothing of the JAX package changes), so
the port regenerates the same masks from the seed.

Stored, besides the seed: the mix loss (label smoothing 0.1), the global
gradient norm, and for every state_dict key the gradient's L2 norm and its
projection on a seeded normal tensor (``utils/weights.grad_projections``).
Weights, images, labels and the projection tensors are regenerated from the
seed with numpy (vision_transformers_tpu_torch/utils/weights.py) by this
script, by tests/test_torch_port_train_golden.py and by chip_smoke.py.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_train_golden.py [--seed 0] [--dropout]
"""

import argparse
import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "vit_s16_port_train_golden.npz")
DROPOUT_GOLDEN = os.path.join(ROOT, "tests", "data", "vit_s16_port_dropout_train_golden.npz")
CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")
N_IMAGES = 2
DROPOUT = 0.1  # the dropout golden's dropout and drop_ff


def dropout_arch(arch):
    """The dropout golden's model: the conf's, drop_path 0, dropout =
    drop_ff = DROPOUT."""
    import dataclasses

    rates = dict(drop_path=0.0, dropout=DROPOUT, drop_ff=DROPOUT)
    if dataclasses.is_dataclass(arch):  # the port's config
        return dataclasses.replace(arch, **rates)
    return arch.model_copy(update=rates)  # the JAX package's


@contextlib.contextmanager
def jax_dropout_masks(masks):
    """Every active flax ``nn.Dropout`` call in the block takes the next of
    ``masks`` (numpy booleans of its element count, in call order):
    ``where(mask, x / keep, 0)``, as nn.Dropout computes it.  Yields the
    list of the (shape, rate) of each call that took one."""
    import jax.numpy as jnp
    from flax import linen as nn

    feed, calls = iter(masks), []

    def interceptor(next_fun, args, kwargs, context):
        module = context.module
        if not isinstance(module, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
        det = module.deterministic if det is None else det
        if det or module.rate == 0.0:
            return x
        keep = 1.0 - module.rate
        calls.append((tuple(x.shape), module.rate))
        mask = jnp.asarray(next(feed).reshape(x.shape))
        return jnp.where(mask, x / keep, jnp.zeros_like(x))

    with nn.intercept_methods(interceptor):
        yield calls


def image_size(conf) -> int:
    """The model's image size, or the conf's training size for a model that
    has none (Twins-SVT)."""
    size = getattr(conf.arch, "image_size", None) or conf.training.train_size
    return size if isinstance(size, int) else size[0]


def jax_train_grads(seed: int, conf: str = CONF, dropout: bool = False) -> dict:
    """{"loss", "grad_norm", "keys", "norms", "projections"} from the JAX
    package for the seeded weights and batch of the model in ``conf``; with
    ``dropout``, the dropout golden's step (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import optax

    from vision_transformers_tpu import ops as jax_ops
    from vision_transformers_tpu.config.schema import load_config
    from vision_transformers_tpu.train import loss as L
    from vision_transformers_tpu.utils.torch_convert import convert_variables
    from vision_transformers_tpu_torch.config.schema import \
        load_config as port_load_config
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             seeded_dropout_masks,
                                                             seeded_state_dict,
                                                             seeded_train_batch,
                                                             state_dict_from_flax,
                                                             vit_dropout_calls)

    full = load_config(conf)
    arch = full.arch
    size = image_size(full)
    params = convert_variables(arch, seeded_state_dict(port_load_config(conf).arch, seed),
                               size)["params"]
    batch = seeded_train_batch(seed, N_IMAGES, size, arch.n_class)
    if dropout:
        arch = dropout_arch(arch)
        masks = seeded_dropout_masks(seed, *zip(*vit_dropout_calls(arch, N_IMAGES)))
    model = arch.make(drop_path=0.0)  # f32

    def loss_and_grads(p, b):
        def f(p):
            logits = model.apply({"params": p}, b["image"], deterministic=False,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
            return L.mix_loss(logits, b["label1"], b["label2"], b["ratio"], eps=0.1)
        return jax.value_and_grad(f)(p)

    b = jax.tree.map(jnp.asarray, batch)
    if dropout:
        jax_ops.set_attention_impl("fused", interpret=True)
        try:
            with jax_dropout_masks(masks) as calls:
                loss, grads = loss_and_grads(params, b)
        finally:
            jax_ops.set_attention_impl(None)
        if len(calls) != len(masks):
            raise RuntimeError(f"{len(calls)} dropout calls for {len(masks)} masks")
    else:
        loss, grads = jax.jit(loss_and_grads)(params, b)
    grad_norm = float(optax.global_norm(grads))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, grads))
    keys = sorted(sd)
    proj = grad_projections(sd, seed)
    return {"loss": float(loss), "grad_norm": grad_norm, "keys": keys,
            "norms": np.array([np.linalg.norm(sd[k].astype(np.float64)) for k in keys]),
            "projections": np.array([proj[k] for k in keys])}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dropout", action="store_true",
                        help="write the dropout golden (see above)")
    args = parser.parse_args()
    g = jax_train_grads(args.seed, dropout=args.dropout)
    path = DROPOUT_GOLDEN if args.dropout else GOLDEN
    np.savez(path, seed=np.int64(args.seed), loss=np.float64(g["loss"]),
             grad_norm=np.float64(g["grad_norm"]), keys=np.array(g["keys"]),
             norms=g["norms"], projections=g["projections"])
    print(f"wrote {path}: loss {g['loss']:.6f}, grad_norm {g['grad_norm']:.6f}, "
          f"{len(g['keys'])} tensors")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()

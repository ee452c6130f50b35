"""The port's ViT train step (vision_transformers_tpu_torch/train/) against
the JAX package's, from one numpy-seeded reference-layout state_dict: the
JAX side builds its params through ``torch_convert.convert_state_dict``, the
port loads the same dict with ``load_state_dict(strict=True)``; JAX trees
come back to state_dict names through ``utils/weights.state_dict_from_flax``.

Each attention path is compared at the same impl: the JAX package's Pallas
kernels in interpret mode ('layer') against the port's autograd Function
on its plain forward and backward, and the einsum path on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.config.schema import Training as JaxTraining
from vision_transformers_tpu.models.vit import TransformerLayer as JaxLayer
from vision_transformers_tpu.models.vit import ViTConfig as JaxViTConfig
from vision_transformers_tpu.train import engine as jax_engine
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.train.optim import make_optimizer as jax_make_optimizer
from vision_transformers_tpu.train.optim import wd_mask as jax_wd_mask
from vision_transformers_tpu.train.schedule import make_schedule as jax_make_schedule
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.config.registry import from_dict
from vision_transformers_tpu_torch.config.schema import Training
from vision_transformers_tpu_torch.models.vit import ViTConfig
from vision_transformers_tpu_torch.train import engine, optim, schedule
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         state_dict_from_flax,
                                                         to_torch)

ARCH = dict(image_size=32, window_size=8, depth=2, dim=64, n_head=2,
            dim_ff=128, n_class=10)
LR, WD, CLIP, EMA = 1e-3, 0.05, 0.05, 0.999


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(ViTConfig(**ARCH), seed=0)


def seeded_batch(seed, n=4):
    rng = np.random.default_rng([seed, 9])
    return {"image": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            "label1": rng.integers(0, ARCH["n_class"], n).astype(np.int32),
            "label2": rng.integers(0, ARCH["n_class"], n).astype(np.int32),
            "ratio": rng.uniform(0.2, 0.8, n).astype(np.float32)}


def port_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["image"] = out["image"].permute(0, 3, 1, 2)
    out["label1"], out["label2"] = out["label1"].long(), out["label2"].long()
    return out


def jax_params(sd):
    return jax.tree.map(jnp.asarray, convert_state_dict(JaxViTConfig(**ARCH), sd)["params"])


class impl:
    """The same attention impl forced on both sides."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        jax_ops.set_attention_impl(self.name, interpret=self.name != "einsum")
        ops.set_attention_impl(self.name)

    def __exit__(self, *exc):
        jax_ops.set_attention_impl(None)
        ops.set_attention_impl(None)


def train_confs(accum=1, clip=CLIP, ema=EMA):
    kw = dict(optimizer={"type": "adamw", "lr": LR},
              scheduler={"type": "constant", "lr": LR}, base_lr=LR,
              weight_decay=WD, wd_skip="vit", epoch=1, clip_grad_norm=clip,
              ema=ema, grad_accumulation=accum)
    return JaxTraining(**kw), from_dict(Training, kw)


class Runs:
    """The same steps through both packages from the same weights."""

    def __init__(self, sd, accum=1, clip=CLIP, ema=EMA):
        jconf, pconf = train_confs(accum, clip, ema)
        self.accum, self.clip, self.ema = accum, clip, ema
        # JAX
        self.jmodel = JaxViTConfig(**ARCH).make()
        params = jax_params(sd)
        self.tx = jax_make_optimizer(jconf, params, lambda c: LR)
        self.jstate = jax_engine.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            opt_state=self.tx.init(params),
            ema_params=jax.tree.map(jnp.copy, params) if ema > 0 else None)
        self.jstep = jax.jit(jax_engine.make_train_step(
            self.jmodel, self.tx, grad_accumulation=accum, label_smoothing=0.1,
            ema=ema))
        # port
        model = ViTConfig(**ARCH).make()
        model.load_state_dict(to_torch(sd), strict=True)
        opt = optim.make_optimizer(pconf, model, lambda c: LR)
        self.pstate = engine.create_train_state(model, opt, ema=ema)

    def jax_grads(self, batch):
        """Mean microbatch gradients, as the JAX step forms them."""
        def loss_fn(p, mb):
            logits = self.jmodel.apply({"params": p}, mb["image"], deterministic=False)
            return jax_loss.mix_loss(logits, mb["label1"], mb["label2"], mb["ratio"],
                                     eps=0.1)
        g = None
        for mb in np.array_split(np.arange(batch["image"].shape[0]), self.accum):
            gi = jax.grad(loss_fn)(self.jstate.params,
                                   {k: jnp.asarray(v[mb]) for k, v in batch.items()})
            g = gi if g is None else jax.tree.map(jnp.add, g, gi)
        return jax.tree.map(lambda x: x / self.accum, g)

    def step(self, batch):
        self.jstate, jm = self.jstep(self.jstate, jax.tree.map(jnp.asarray, batch),
                                     jax.random.PRNGKey(0))
        pm = engine.train_step(self.pstate, port_batch(batch), None,
                               grad_accumulation=self.accum, ema=self.ema,
                               clip_grad_norm=self.clip)
        return ({k: float(v) for k, v in jm.items()},
                {k: float(v) for k, v in pm.items()})


def close_leaves(a_sd, b_sd, rtol, atol, what):
    assert sorted(a_sd) == sorted(b_sd), what
    for k in a_sd:
        a = np.asarray(a_sd[k], np.float64)
        b = np.asarray(b_sd[k], np.float64)
        assert a.shape == b.shape, (what, k)
        scale = max(np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(a / scale, b / scale, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def sd_numpy(tensors):
    return {k: v.detach().numpy() for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# one layer: forward and every parameter gradient, with DropPath scales
# ---------------------------------------------------------------------------


def test_layer_with_row_scales_matches_jax(weights):
    rng = np.random.default_rng(5)
    B, N, C = 4, 17, ARCH["dim"]
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    rs1 = np.array([0.0, 1.25, 1.25, 0.0], np.float32)
    rs2 = np.array([1.25, 0.0, 1.25, 1.25], np.float32)
    lp = jax_params(weights)["layers_0"]
    layer = JaxLayer(ARCH["n_head"], ARCH["dim_ff"])

    def jax_loss_fn(p, xx):
        out = layer.apply({"params": p}, xx, deterministic=False,
                          rs_override=(jnp.asarray(rs1), jnp.asarray(rs2)))
        return jnp.sum(out ** 2), out

    with impl("layer"):
        (_, jout), (jg, jgx) = jax.value_and_grad(jax_loss_fn, argnums=(0, 1),
                                                   has_aux=True)(lp, jnp.asarray(x))
        model = ViTConfig(**ARCH).make()
        model.load_state_dict(to_torch(weights), strict=True)
        tl = model.layers[0]
        xt = torch.from_numpy(x).requires_grad_()
        out = tl(xt, (torch.from_numpy(rs1), torch.from_numpy(rs2)))
        (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=5e-5, atol=5e-5)
    # JAX layer grads → the port's names (a one-layer params tree)
    theirs = {k[len("layers.0."):]: v for k, v in state_dict_from_flax(
        {"patch_embedding": {"linear": {"kernel": np.zeros((1, 1, 1, 1)),
                                        "bias": np.zeros(1)}},
         "cls_token": 0, "pos_embed": 0, "norm": {"scale": 0, "bias": 0},
         "layers_0": jax.tree.map(np.asarray, jg)}).items()
        if k.startswith("layers.0.")}
    ours = {k: p.grad.numpy() for k, p in tl.named_parameters()}
    theirs["x"], ours["x"] = np.asarray(jgx), xt.grad.numpy()
    close_leaves(ours, theirs, 1e-4, 1e-4, "layer grad")


# ---------------------------------------------------------------------------
# one optimizer step: loss, grad_norm, grads, params, EMA, Adam moments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl_name", ["layer", "einsum"])
def test_one_step_matches_jax(weights, impl_name):
    batch = seeded_batch(0)
    runs = Runs(weights)
    with impl(impl_name):
        jgrads = state_dict_from_flax(jax.tree.map(np.asarray, runs.jax_grads(batch)))
        jm, pm = runs.step(batch)
    assert pm["grad_norm"] > CLIP  # the clip is active
    # same f32 math in another summation order
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose([pm["prec1"], pm["prec5"]], [jm["prec1"], jm["prec5"]])
    model = runs.pstate.model
    close_leaves({k: p.grad.numpy() for k, p in model.named_parameters()}, jgrads,
                 1e-4, 1e-4, "grad")
    js = runs.jstate
    adam = js.opt_state[1][0]
    close_leaves(sd_numpy(runs.pstate.optimizer.state_dict()["mu"]),
                 state_dict_from_flax(jax.tree.map(np.asarray, adam.mu)),
                 1e-4, 1e-4, "adam mu")
    close_leaves(sd_numpy(runs.pstate.optimizer.state_dict()["nu"]),
                 state_dict_from_flax(jax.tree.map(np.asarray, adam.nu)),
                 2e-4, 2e-4, "adam nu")
    # After one step p1 = p0 − lr·(g/(|g|+eps) + wd·p0): Adam's first step
    # divides g by |g| + eps, so where |g| is near eps a 1e-6 relative
    # difference in g moves the update by up to lr.  As
    # tests/test_optimizer_step_parity.py:138-146 does, hold 99.9% of the
    # elements to a tight tolerance and every one to 1% of the lr.
    for what, ours, theirs in (
            ("param", sd_numpy(model.state_dict()),
             state_dict_from_flax(jax.tree.map(np.asarray, js.params))),
            ("ema", sd_numpy(runs.pstate.ema_model.state_dict()),
             state_dict_from_flax(jax.tree.map(np.asarray, js.ema_params)))):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            a, b = ours[k], theirs[k]
            assert np.isclose(a, b, rtol=2e-3, atol=5e-5).mean() >= 0.999, (what, k)
            assert np.abs(a - b).max() <= LR * 0.01, (what, k, np.abs(a - b).max())
            if what == "param":
                assert not np.array_equal(a, weights[k]), f"{k} did not move"


# ---------------------------------------------------------------------------
# ten steps: the loss trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl_name,accum", [("layer", 1), ("einsum", 1), ("layer", 2)])
def test_ten_steps_match_jax(weights, impl_name, accum):
    runs = Runs(weights, accum=accum)
    batch = seeded_batch(100, n=8)
    jl, pl = [], []
    with impl(impl_name):
        for _ in range(10):
            jm, pm = runs.step(batch)
            jl.append(jm["loss"])
            pl.append(pm["loss"])
    assert pl[-1] < pl[0]  # the model learns
    # Adam normalizes each step's update, so the parameter differences of
    # the first step (see test_one_step_matches_jax) carry on; ten steps at
    # lr 1e-3 keep the losses within 1e-4 of each other
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-5)
    ours = sd_numpy(runs.pstate.ema_model.state_dict())
    theirs = state_dict_from_flax(jax.tree.map(np.asarray, runs.jstate.ema_params))
    for k in ours:
        assert np.abs(ours[k] - theirs[k]).max() <= 10 * LR * 0.01, k


# ---------------------------------------------------------------------------
# schedule, weight-decay mask, DropPath draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", [
    {"type": "cycle", "lr": 1e-3, "warmup": 1, "initial_multiplier": 1e-2,
     "final_multiplier": 1e-5},
    {"type": "cycle", "lr": 1e-3, "warmup": 1, "plateau": 2, "decay": ["linear", "cos"]},
    {"type": "cycle", "lr": 1e-3},
    {"type": "constant", "lr": 1e-3},
])
def test_schedule_matches_jax(sched):
    epoch_len = 7
    kw = dict(optimizer={"type": "adamw", "lr": 1e-3}, scheduler=sched,
              base_lr=2.5e-4, weight_decay=0.05, wd_skip="vit", epoch=3,
              dataloader={"batch_size": 512})
    ours = schedule.make_schedule(from_dict(Training, kw), epoch_len)
    theirs = jax_make_schedule(JaxTraining(**kw), epoch_len)
    counts = range(3 * epoch_len + 3)  # past the end: the lr freezes
    # the JAX schedule evaluates in float32, the port's in float64
    np.testing.assert_allclose([ours(c) for c in counts],
                               [float(theirs(c)) for c in counts], rtol=1e-5)


def test_wd_mask_matches_jax(weights):
    params = jax_params(weights)
    # one bool per leaf, broadcast to the leaf's shape for the layout mapping
    theirs = state_dict_from_flax(jax.tree.map(
        lambda m, p: np.full(p.shape, m), jax_wd_mask(params, "vit"), params))
    model = ViTConfig(**ARCH).make()
    ours = optim.wd_mask(dict(model.named_parameters()), "vit")
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert np.all(theirs[k] == ours[k]), k
    assert not ours["cls_token"] and ours["pos_embed"] and not ours["norm.weight"]


def test_drop_path_draws_keep_rate():
    """Per-sample scales are 0 or 1/keep with the keep rate of each layer's
    ramp rate; layer 0 (rate 0) draws nothing (vit.py:174-187, 418)."""
    model = ViTConfig(**{**ARCH, "depth": 3, "drop_path": 0.5}).make()
    gen = torch.Generator().manual_seed(0)
    scales = model.draw_drop_path(20000, gen)
    assert scales[0] == (None, None)
    for i, (r_attn, r_ff) in enumerate(scales[1:], start=1):
        rate = 0.5 * i / 2
        keep = 1 - rate
        for r in (r_attn, r_ff):
            vals = set(np.unique(r.numpy()).tolist())
            assert vals == {0.0, np.float32(1 / keep)}
            frac = float((r > 0).float().mean())
            assert abs(frac - keep) < 4 * np.sqrt(keep * (1 - keep) / 20000)
    assert not torch.equal(scales[1][0], scales[1][1])  # independent draws


def test_drop_path_layer_path_drops_whole_samples(weights):
    """Under the 'layer' path a sample whose two scales are 0 passes x
    through unchanged; the others differ from the deterministic output."""
    model = ViTConfig(**ARCH).make()
    model.load_state_dict(to_torch(weights), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 17, 64)).astype(np.float32))
    rs = torch.tensor([0.0, 2.0, 0.0, 2.0])
    ops.set_attention_impl("layer")
    try:
        out = model.layers[1](x, (rs, rs))
        det = model.layers[1](x)
    finally:
        ops.set_attention_impl(None)
    assert torch.equal(out[0], x[0]) and torch.equal(out[2], x[2])
    assert not torch.allclose(out[1], det[1]) and not torch.allclose(out[3], x[3])


def test_training_forward_draws_from_the_generator(weights):
    """Same generator seed → same draws, DropPath's and dropout's."""
    model = ViTConfig(**{**ARCH, "drop_path": 0.3}).make()
    model.load_state_dict(to_torch(weights), strict=True)
    x = torch.from_numpy(seeded_batch(1, n=8)["image"]).permute(0, 3, 1, 2)
    a = model.train()(x, torch.Generator().manual_seed(3))
    b = model(x, torch.Generator().manual_seed(3))
    c = model(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model = ViTConfig(**{**ARCH, "dropout": 0.1, "drop_ff": 0.1}).make().train()
    model.load_state_dict(to_torch(weights), strict=True)
    a = model(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, model(x, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, model(x, torch.Generator().manual_seed(5)))


def test_reset_parameters_follows_jax_initializers():
    model = ViTConfig(**{**ARCH, "dim": 128, "dim_ff": 512}).make()
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("bias"):
            assert not v.any(), k
        elif "norm" in k:
            assert torch.equal(v, torch.ones_like(v)), k
        else:  # normal(0.02)
            tol = 6 * 0.02 / np.sqrt(2 * v.numel())  # 6 sigma of the sample std
            assert abs(float(v.std()) - 0.02) < tol and abs(float(v.mean())) < 0.003, k


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_losses_match_jax(eps):
    rng = np.random.default_rng(7)
    logits = (3 * rng.normal(size=(6, 10))).astype(np.float32)
    t1, t2 = rng.integers(0, 10, 6), rng.integers(0, 10, 6)
    ratio = rng.uniform(0, 1, 6).astype(np.float32)
    lt, j = torch.from_numpy(logits), jnp.asarray(logits)
    pairs = [
        (L.mix_loss(lt, torch.from_numpy(t1), torch.from_numpy(t2), torch.from_numpy(ratio),
                    eps=eps, reduction="none"),
         jax_loss.mix_loss(j, jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(ratio),
                           eps=eps, reduction="none")),
        (L.label_smoothing_loss(lt, torch.from_numpy(t1), eps=eps),
         jax_loss.label_smoothing_loss(j, jnp.asarray(t1), eps=eps)),
        (L.cross_entropy_loss(lt, torch.from_numpy(t1), reduction="sum"),
         jax_loss.cross_entropy_loss(j, jnp.asarray(t1), reduction="sum")),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)

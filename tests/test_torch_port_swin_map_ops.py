"""The map-resident Swin layer B9 (``ops.fused_swin_layer``) in the port
against the JAX package.

- The port's op on its plain version (a CPU tensor) against the JAX
  ``fused_swin_layer`` with the Pallas kernel in interpret mode, at a tiny
  size (2 images, an 8x8 map, windows of 2 packed in pairs: 8 pairs of 8
  tokens, C 16, 2 heads of 8, F 32): shifted and unshifted, with the
  grouped [G, H, m, m] and the broadcast [1, H, m, m] bias, with and without
  each per-sample row scale.  The output and every gradient the JAX rule
  returns (x, both LayerNorms, the four weights and their biases, extra in
  its form, each row scale [B]) within 1e-4 of the tensor's largest value:
  the same f32 arithmetic summed in another order.
- ``swin_token_perm`` equals the JAX function for windows 2, 4 and 7 at pack
  1 and 2.
- The kernels' map addressing, ``map_rows``: row g·m + t of a sample is the
  pixel that the plain version's roll and window-pair partition put there,
  and the formula of the CUDA source's comment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops import fused_swin as jax_swin
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.ops import fused_swin
from torch_port_threads import one_torch_thread  # noqa: F401

B, H, W, C, NH, D, F, WIN, PACK = 2, 8, 8, 16, 2, 8, 32, 2, 2
HD, M = NH * D, PACK * WIN * WIN
G = (H // WIN) * (W // (PACK * WIN))
TOL = 1e-4


def inputs(seed, groups, rs):
    """Seeded layer inputs at the tiny size, weights [in, out] as the JAX op
    takes them (std 0.2: scores of order 1, no saturated softmax), the bias
    [groups, H, m, m], and the row scales named in ``rs`` (each image kept at
    1.25 or dropped)."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.standard_normal(shape)).astype(np.float32)

    args = [n(B, H, W, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(C, 3 * HD, s=0.2),
            n(3 * HD, s=0.1), n(HD, C, s=0.2), n(C, s=0.1), n(C, s=0.1, mean=1.0),
            n(C, s=0.1), n(C, F, s=0.2), n(F, s=0.1), n(F, C, s=0.2), n(C, s=0.1)]
    extra = n(groups, NH, M, M, s=0.3)
    scales = [np.array([1.25, 0.0], np.float32) if "attn" in rs else None,
              np.array([0.0, 1.25], np.float32) if "ff" in rs else None]
    return args, extra, scales, n(B, H, W, C)


CASES = [(True, G, ("attn", "ff")), (True, G, ()), (False, 1, ("attn", "ff")),
         (False, 1, ()), (True, 1, ("attn",)), (False, G, ("ff",))]


@pytest.mark.parametrize("shift,groups,rs", CASES, ids=[
    f"{'shifted' if s else 'unshifted'}-{'grouped' if g > 1 else 'broadcast'}-"
    f"rs-{'+'.join(r) or 'none'}" for s, g, r in CASES])
def test_layer_matches_jax(shift, groups, rs):
    args, extra, (rs_attn, rs_ff), do = inputs(int(shift) * 10 + groups, groups, rs)
    kw = dict(window=WIN, shift=shift, pack=PACK)

    def jax_fn(*a):
        out = jax_swin.fused_swin_layer(*a[:13], NH, a[13], a[14], a[15], interpret=True,
                                        **kw)
        return jnp.sum(out * jnp.asarray(do)), out

    tensors = args + [extra, rs_attn, rs_ff]
    argnums = tuple(i for i, t in enumerate(tensors) if t is not None)
    (_, jout), jgrads = jax.value_and_grad(jax_fn, argnums=argnums, has_aux=True)(
        *(None if t is None else jnp.asarray(t) for t in tensors))

    ours = [None if t is None else torch.from_numpy(t).requires_grad_() for t in tensors]
    out = ops.fused_swin_layer(*ours[:13], NH, ours[13], ours[14], ours[15], **kw)
    (out * torch.from_numpy(do)).sum().backward()

    jout = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=TOL * np.abs(jout).max(),
                               rtol=0)
    for i, jg in zip(argnums, jgrads):
        jg = np.asarray(jg)
        name = fused_swin.GRAD_NAMES[i]
        assert ours[i].grad.shape == jg.shape, name
        np.testing.assert_allclose(ours[i].grad.numpy(), jg,
                                   atol=TOL * max(float(np.abs(jg).max()), 1e-12), rtol=0,
                                   err_msg=name)
    if rs_attn is not None:  # the dropped image's scale still has a gradient
        assert ours[14].grad[1] != 0


@pytest.mark.parametrize("window", [2, 4, 7])
@pytest.mark.parametrize("pack", [1, 2])
def test_token_perm_matches_jax(window, pack):
    np.testing.assert_array_equal(ops.swin_token_perm(window, pack),
                                  jax_swin.swin_token_perm(window, pack))


@pytest.mark.parametrize("h,w,window,pack,shift", [
    (8, 8, 2, 2, True), (8, 8, 2, 2, False), (14, 14, 7, 1, True), (6, 12, 3, 2, True)])
def test_map_rows_is_the_partition(h, w, window, pack, shift):
    pix = fused_swin.map_rows(h, w, window, pack, shift)
    assert pix.dtype == torch.int32 and pix.shape == (h * w,)
    x = torch.randn(2, h, w, 3)
    m = pack * window * window
    groups = (h // window) * (w // (pack * window))
    geo = fused_swin._geometry(x, torch.zeros(1, 1, m, m), window, pack, shift)
    rows = fused_swin._to_rows(x, geo)
    assert torch.equal(rows.reshape(2, h * w, 3), x.reshape(2, h * w, 3)[:, pix.long()])
    assert torch.equal(fused_swin._from_rows(rows, geo), x)
    s, pw = (window // 2 if shift else 0), pack * window
    for g in range(groups):
        wy, p = divmod(g, w // pw)
        for t in range(m):
            r, c = divmod(t, pw)
            assert pix[g * m + t] == ((wy * window + r + s) % h) * w + (p * pw + c + s) % w

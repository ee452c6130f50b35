"""Package boundary of the PyTorch port: no jax / flax / pydantic on import,
no file or module of the JAX package read or imported, its own HOCON parser
agreeing with the JAX package's, its config validation, its build refusing
to run without nvcc, and its GPU entry point refusing to fall back to the
CPU.  The CUDA kernel checks need a card (marker ``cuda``) and skip
elsewhere."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import predict
from vision_transformers_tpu_torch.config import registry
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.models.vit import ViTConfig
from vision_transformers_tpu_torch.ops import _build, fused_layer, fused_layer1

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import vision_transformers_tpu_torch\n"
        "import vision_transformers_tpu_torch.models.halo\n"
        "import vision_transformers_tpu_torch.models.pvt\n"
        "import vision_transformers_tpu_torch.models.swin\n"
        "import vision_transformers_tpu_torch.models.twins\n"
        "import vision_transformers_tpu_torch.models.vit\n"
        "import vision_transformers_tpu_torch.ops\n"
        "import vision_transformers_tpu_torch.ops.fused_attention\n"
        "import vision_transformers_tpu_torch.ops._build\n"
        "import vision_transformers_tpu_torch.predict\n"
        "import vision_transformers_tpu_torch.utils.weights\n"
        "print(sorted(m for m in ('jax', 'flax', 'pydantic', 'vision_transformers_tpu')"
        " if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


_AUDIT = r"""
import importlib, json, os, pkgutil, sys
root = sys.argv[1]
jax_pkg = os.path.join(root, "vision_transformers_tpu") + os.sep
seen = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        path = os.path.abspath(os.fsdecode(args[0]))
        if path.startswith(jax_pkg):
            seen.append(["open", path])
    elif event == "import":
        name = args[0]
        if name == "vision_transformers_tpu" or name.startswith("vision_transformers_tpu."):
            seen.append(["import", name])

sys.addaudithook(hook)
import vision_transformers_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vision_transformers_tpu_torch.__path__,
                                               "vision_transformers_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (main() is not run)
print(json.dumps({"modules": names, "seen": seen}))
"""


def test_port_reads_nothing_of_the_jax_package():
    """An audit hook on ``open`` and ``import`` events while every module of
    the port and ``chip_smoke`` are imported: no file under
    ``vision_transformers_tpu/`` is opened, no module of it imported."""
    out = subprocess.run([sys.executable, "-c", _AUDIT, ROOT], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vision_transformers_tpu_torch.config.hocon" in result["modules"]
    assert "vision_transformers_tpu_torch.train.trainer" in result["modules"]
    assert "vision_transformers_tpu_torch.models.swin" in result["modules"]
    assert "vision_transformers_tpu_torch.models.twins" in result["modules"]
    assert "vision_transformers_tpu_torch.ops.fused_attention" in result["modules"]
    assert result["seen"] == [], result["seen"]


@pytest.mark.parametrize("conf_name", sorted(os.listdir(os.path.join(ROOT, "configs"))))
def test_hocon_copy_parses_every_conf_alike(conf_name):
    from vision_transformers_tpu.config import hocon as jax_hocon
    from vision_transformers_tpu_torch.config import hocon

    path = os.path.join(ROOT, "configs", conf_name)
    assert hocon.load(path) == jax_hocon.load(path)


def test_hocon_copy_applies_overrides_alike():
    """Dotted ``key=value`` items with every value form ``parse_value``
    takes: ints, floats, exponents, booleans, null, bare and quoted strings
    with escapes, lists and objects."""
    from vision_transformers_tpu.config import hocon as jax_hocon
    from vision_transformers_tpu_torch.config import hocon

    items = ["a.int=3", "a.neg=-7", "a.float=2.5", "a.exp=1e-3", "a.t=true",
             "a.y=yes", "a.on=ON", "a.f=false", "a.no=no", "a.off=off",
             "a.null=null", "a.none=None", "a.bare=hello world",
             'a.dq="x: \\"q\\"\\n"', "a.sq='single, quoted'",
             "a.list=[1, 2.5, x, [3, 4]]", "b.c.d={type: local, path: /tmp/x}",
             "b.empty=[]", "training.scheduler.warmup=0"]
    base = hocon.load(CONF)
    ours = hocon.apply_overrides(json.loads(json.dumps(base)), items)
    theirs = jax_hocon.apply_overrides(json.loads(json.dumps(base)), items)
    assert ours == theirs
    assert ours["a"]["exp"] == 1e-3 and ours["a"]["none"] is None
    assert ours["b"]["c"]["d"] == {"type": "local", "path": "/tmp/x"}
    for bad in ("no_equals",):
        with pytest.raises(ValueError):
            hocon.apply_overrides({}, [bad])


def test_vit_s16_conf_loads():
    conf = load_config(CONF)
    arch = conf.arch
    assert isinstance(arch, ViTConfig) and arch.type == "vit"
    assert (arch.image_size, arch.window_size, arch.depth, arch.dim,
            arch.n_head, arch.dim_ff, arch.n_class) == (224, 16, 12, 384, 6, 1536, 1000)
    assert isinstance(arch.drop_path, float) and arch.drop_path == 0.1
    assert conf.training.valid_size == 224
    assert conf.training.dataloader.batch_size == 1024
    assert conf.training.optimizer.type == "adamw"  # typed through the registry
    assert conf.training.scheduler.type == "cycle"
    assert conf.checker.storage == [{"type": "local", "path": "checkpoint/vit-s-16"}]


def test_overrides_apply():
    conf = load_config(CONF, ["arch.depth=2", "training.valid_size=32"])
    assert conf.arch.depth == 2 and conf.training.valid_size == 32


@pytest.mark.parametrize("override,error", [
    ("arch.dpeth=2", ValueError),               # typo'd field
    ("training.valid_sise=32", ValueError),     # typo'd nested field
    ("arch.type=not_a_model", KeyError),        # unknown arch type
    ("arch.depth=deep", TypeError),             # wrong value type
])
def test_bad_conf_raises(override, error):
    with pytest.raises(error):
        load_config(CONF, [override])


def test_unknown_type_lists_registered():
    with pytest.raises(KeyError, match="registered: halo_transformer, pvt, swin_transformer, "
                                       "twins_svt, vit"):
        registry.build("model", {"type": "nfnet"})


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_predict_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--conf", CONF, "--checkpoint", str(tmp_path / "x.pt"),
                      "--device", "cuda", "img.jpg"])


def _layer_args(B, N, C, H, D, F, device, seed=0):
    rng = np.random.default_rng(seed)
    HD = H * D

    def n(*shape, s=1.0, mean=0.0):
        return torch.from_numpy((mean + s * rng.normal(size=shape)).astype(np.float32)).to(device)

    return [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(C, 3 * HD, s=0.05), n(3 * HD, s=0.1), n(HD, C, s=0.05), n(C, s=0.1),
            n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(C, F, s=0.05), n(F, s=0.1), n(F, C, s=0.05), n(C, s=0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 48, 2, 24, 96), (4, 197, 384, 6, 64, 1536)])
def test_cuda_kernels_match_plain(shape):
    """Both kernels against their plain versions on the card, f32; the
    weights go in as transposed views, as the model passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, C, H, D, F = shape
    a = _layer_args(B, N, C, H, D, F, "cuda")
    for i in (3, 5, 9, 11):
        a[i] = a[i].t().contiguous().t()
    attn = (a[0], *a[1:7], H)
    before = fused_layer.LAUNCHES
    out = fused_layer.fused_attention_layer(*attn)
    assert fused_layer.LAUNCHES == before + 1
    ref = fused_layer.fused_attention_layer_reference(*attn)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    before = fused_layer1.LAUNCHES
    out = fused_layer1.fused_transformer_layer(*a, H)
    assert fused_layer1.LAUNCHES == before + 1
    ref = fused_layer1.fused_transformer_layer_reference(*a, H)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("use_rs", [False, True])
def test_cuda_backward_matches_plain(use_rs):
    """Forward with saves + backward kernel against the plain forward +
    plain backward on the card, f32, through the autograd Function; the
    backward is bit-identical from run to run.  Limit 1e-3·max(1, max|ref|)
    per tensor: f32 sums over all B·N rows in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = _layer_args(3, 37, 48, 2, 24, 96, "cuda")[:7]
    for i in (3, 5):
        a[i] = a[i].t().contiguous().t()
    rs = torch.tensor([0.0, 1.25, 1.25], device="cuda") if use_rs else None
    dz = torch.randn(3, 37, 48, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    before = fused_layer.LAUNCHES, fused_layer.BWD_LAUNCHES
    out, saved = fused_layer.fused_attention_layer_fwd(*a, 2, row_scale=rs)
    grads = fused_layer.fused_attention_layer_bwd(saved, dz)
    again = fused_layer.fused_attention_layer_bwd(saved, dz)
    assert (fused_layer.LAUNCHES, fused_layer.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    _, saved_p = fused_layer.fused_attention_layer_fwd_reference(*a, 2, row_scale=rs)
    plain = fused_layer.fused_attention_layer_bwd_reference(saved_p, dz)
    for k, k2, p in zip(grads, again, plain):
        if p is None:
            assert k is None
            continue
        assert torch.equal(k, k2)
        assert (k - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    a = _layer_args(2, 17, 32, 2, 16, 64, "cuda")
    wide = _layer_args(2, 17, 64, 1, 64, 128, "cuda")  # a bias takes heads up to 32 wide
    with pytest.raises(NotImplementedError):
        fused_layer.fused_attention_layer(*wide[:7], 1,
                                          extra=torch.zeros(1, 17, 17, device="cuda"))
    with pytest.raises(NotImplementedError):
        fused_layer1.fused_transformer_layer(*a, 2, activation="gelu")
    with pytest.raises(NotImplementedError):
        fused_layer.fused_attention_layer(*(t.double() for t in a[:7]), 2)

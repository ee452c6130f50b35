"""The port's trainer (``python -m vision_transformers_tpu_torch.train``)
against the JAX package's ``train_classification`` on one tiny synthetic
conf, both from the same seeded ``.pt`` (``finetune=…:model``: the JAX side
converts it through its own ``torch_convert``), f32, one epoch; and what
the port's trainer refuses.
"""

import json
import os

import numpy as np
import pytest
import torch

from vision_transformers_tpu.config.schema import load_config as jax_load_config
from vision_transformers_tpu.train.trainer import train_classification as jax_train
from vision_transformers_tpu_torch import predict, train
from vision_transformers_tpu_torch.models.vit import ViTConfig
from vision_transformers_tpu_torch.utils.weights import (seeded_images,
                                                         seeded_state_dict,
                                                         to_torch)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")
ARCH = dict(image_size=32, window_size=8, depth=2, dim=64, n_head=2,
            dim_ff=128, n_class=10)
TINY = ["precision=f32", "training.epoch=1", "training.dataloader.batch_size=8",
        "data_backend=synthetic", "arch.depth=2", "arch.dim=64", "arch.n_head=2",
        "arch.dim_ff=128", "arch.image_size=32", "arch.window_size=8",
        "arch.n_class=10", "arch.drop_path=0", "training.train_size=32",
        "training.valid_size=32", "training.base_lr=0.08",
        "training.scheduler.warmup=0", "training.ema=0.99", "n_device=1", "log_freq=4"]


@pytest.fixture(scope="module")
def init_pt(tmp_path_factory):
    path = tmp_path_factory.mktemp("init") / "init.pt"
    torch.save({"model": to_torch(seeded_state_dict(ViTConfig(**ARCH), 0))}, path)
    return str(path)


@pytest.fixture(scope="module")
def port_run(init_pt, tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    metrics = train.main(["--conf", CONF, "--device", "cpu", *TINY,
                          f"finetune={init_pt}:model",
                          f"checker.storage=[{{type: local, path: {out}}}]",
                          f"checker.reporter=[{{type: jsonl, path: {out}/m.jsonl}}]"])
    return metrics, out


def test_epoch_metrics_match_jax_trainer(init_pt, port_run, tmp_path):
    conf = jax_load_config(CONF, TINY + [
        f"finetune={init_pt}:model",
        f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    theirs = jax_train(conf)
    ours, out = port_run
    # 8 AdamW steps of the same f32 math in another summation order
    for k in ("loss", "valid_loss", "lr"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)
    for k in ("prec1", "prec5"):
        assert ours[k] == theirs[k], k
    with open(out / "m.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert len(logged) == 1 and logged[0]["valid_loss"] == ours["valid_loss"]


def test_epoch_checkpoint_loads_into_predict(port_run, tmp_path):
    from PIL import Image

    _, out = port_run
    ckpt = out / "epoch-001.pt"
    obj = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert sorted(obj) == ["ema", "epoch", "model", "optimizer"] and obj["epoch"] == 0
    files = []
    for i, img in enumerate(seeded_images(3, 2, 40)):
        files.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(img).save(files[-1])
    for key in ("model", "ema"):
        predict.main(["--conf", CONF, "--checkpoint", f"{ckpt}:{key}", "--device",
                      "cpu", "--topk", "3", *files, "arch.depth=2", "arch.dim=64",
                      "arch.n_head=2", "arch.dim_ff=128", "arch.image_size=32",
                      "arch.window_size=8", "arch.n_class=10",
                      "training.valid_size=32"])


@pytest.mark.parametrize("override", ["precision=bf16", "training.progressive.step=1",
                                      "resume=auto", "data_backend=records",
                                      "training.agc=0.01", "arch.remat=true"])
def test_unported_options_raise(override, tmp_path):
    with pytest.raises(NotImplementedError):
        train.main(["--conf", CONF, "--device", "cpu", *TINY, override,
                    f"checker.storage=[{{type: local, path: {tmp_path}}}]"])


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--conf", CONF, *TINY])

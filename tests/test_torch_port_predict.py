"""The port's serving entry point against the JAX package's: the validation
decode bit for bit, and ``predict.main`` end to end on a tiny ViT conf with a
seeded reference-layout ``.pt`` (same top-k classes, probabilities within
1e-4)."""

import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from vision_transformers_tpu.data.pipeline import decode_valid as jax_decode_valid
from vision_transformers_tpu_torch import predict
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.data.pipeline import decode_valid
from vision_transformers_tpu_torch.utils.weights import seeded_state_dict, to_torch
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")
OVERRIDES = ["arch.depth=2", "arch.dim=64", "arch.n_head=2", "arch.dim_ff=128",
             "arch.image_size=32", "arch.window_size=8", "arch.n_class=10",
             "training.valid_size=32"]


def _jpeg(rng, w, h):
    pixels = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("w,h", [(64, 48), (48, 64), (50, 50), (91, 37)])
def test_decode_valid_bit_identical(w, h):
    payload = _jpeg(np.random.default_rng(w * 1000 + h), w, h)
    ours, theirs = decode_valid(payload, 32), jax_decode_valid(payload, 32)
    assert ours.dtype == theirs.dtype == np.uint8
    assert ours.shape == theirs.shape == (32, 32, 3)
    np.testing.assert_array_equal(ours, theirs)


def _run_main(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["predict.py", *argv])
    main()
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_predict_main_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(4)
    files = []
    for i, (w, h) in enumerate([(64, 48), (40, 56), (36, 36)]):
        path = tmp_path / f"img{i}.jpg"
        path.write_bytes(_jpeg(rng, w, h))
        files.append(str(path))
    arch = load_config(CONF, OVERRIDES).arch
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"model": to_torch(seeded_state_dict(arch, 1)),
                "ema": to_torch(seeded_state_dict(arch, 2))}, ckpt)
    argv = ["--conf", CONF, "--checkpoint", f"{ckpt}:ema", "--topk", "3",
            *files, *OVERRIDES]

    spec = importlib.util.spec_from_file_location(
        "jax_predict", os.path.join(ROOT, "predict.py"))
    jax_predict = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_predict)
    theirs = _run_main(jax_predict.main, argv, monkeypatch, capsys)
    ours = _run_main(lambda: predict.main(None), argv + ["--device", "cpu"],
                     monkeypatch, capsys)

    assert [e["file"] for e in ours] == files
    assert len(ours) == len(theirs) == len(files)
    for a, b in zip(ours, theirs):
        assert a["file"] == b["file"]
        assert [t["class"] for t in a["topk"]] == [t["class"] for t in b["topk"]]
        for ta, tb in zip(a["topk"], b["topk"]):
            assert abs(ta["prob"] - tb["prob"]) <= 1e-4
            assert 0.0 < ta["prob"] <= 1.0


def test_predict_batch_topk_is_softmax_of_logits():
    arch = load_config(CONF, OVERRIDES).arch
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, 3)), strict=True)
    images = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    logits, top, prob = predict.predict_batch(model.eval(), images, 3, "cpu")
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    np.testing.assert_array_equal(top, np.argsort(-probs, axis=-1)[:, :3])
    np.testing.assert_allclose(prob, np.take_along_axis(probs, top, -1), rtol=1e-6)

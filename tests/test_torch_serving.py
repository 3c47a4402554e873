"""The port's serving engine and HTTP front on the CPU, against the JAX
model's forward with the same weights.

f32 throughout, so the engine's logits are held to the JAX forward at
rel <= 1e-4 (the same arithmetic in other summation orders). Rows of the
model are independent, so padding a chunk up to its bucket may change a
real row only by the summation order of a matrix product of another height:
rel <= 1e-6 against the unpadded forward.
"""

import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.models.channel_vit import ChannelVisionTransformer as JBackbone
from diverse_channel_vit_tpu.models.wrappers import ChannelAdaptiveClassifier as JClassifier
from diverse_channel_vit_torch.models.channel_vit import ChannelVisionTransformer
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.models.wrappers import ChannelAdaptiveClassifier
from diverse_channel_vit_torch.serving import ServingEngine
from diverse_channel_vit_torch.serving_http import ServingHTTPServer

C, IMG, PATCH, D, NC = 4, 32, 16, 64, 5


@pytest.fixture(scope="module")
def setup():
    jmodel = JClassifier(
        backbone=JBackbone(num_total_channels=C, img_size=IMG, patch_size=PATCH, embed_dim=D,
                           depth=2, num_heads=2, attention_impl="xla"),
        embed_dim=D, num_classes=NC, with_head=True,
    )
    x0 = jnp.zeros((2, C, IMG, IMG), jnp.float32)
    params = jmodel.init({"params": jax.random.key(0)}, x0, jnp.arange(C), train=False)["params"]
    model = ChannelAdaptiveClassifier(
        ChannelVisionTransformer(C, IMG, PATCH, D, depth=2, num_heads=2), D, NC, with_head=True
    )
    model.load_state_dict(params_from_jax(params), strict=True)
    engine = ServingEngine(model, buckets=(1, 4, 8), max_wait_ms=20.0, device="cpu")

    def jax_forward(imgs, cids):
        out, _ = jmodel.apply({"params": params}, jnp.asarray(imgs), jnp.asarray(cids),
                              train=False)
        return np.asarray(out)

    return engine, jax_forward


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_predict_matches_jax_forward(setup):
    engine, jax_forward = setup
    imgs = np.random.default_rng(1).normal(size=(3, C, IMG, IMG)).astype(np.float32)
    got = engine.predict(imgs, list(range(C)))
    assert got.shape == (3, NC) and got.dtype == np.float32
    assert _rel(got, jax_forward(imgs, np.arange(C))) <= 1e-4


def test_bucket_padding_changes_no_real_row(setup):
    engine, _ = setup
    imgs = np.random.default_rng(2).normal(size=(3, C, IMG, IMG)).astype(np.float32)
    padded = engine.predict(imgs, list(range(C)))  # 3 rows in the 4-bucket
    with torch.inference_mode():
        plain, _ = engine.model(torch.from_numpy(imgs), torch.arange(C))
    assert _rel(padded, plain.numpy()) <= 1e-6
    one = engine.predict(imgs[1:2], list(range(C)))  # the 1-bucket, no padding
    assert _rel(one, padded[1:2]) <= 1e-6


def test_predict_channel_subset_and_split(setup):
    """k=2 subset request; 10 images split across the 8-bucket + 4-bucket."""
    engine, jax_forward = setup
    imgs = np.random.default_rng(3).normal(size=(10, 2, IMG, IMG)).astype(np.float32)
    before = engine.n_forwards
    got = engine.predict(imgs, [1, 3])
    assert engine.n_forwards == before + 2
    assert _rel(got, jax_forward(imgs, np.array([1, 3]))) <= 1e-4


def test_warmup_runs_every_bucket(setup):
    engine, _ = setup
    before = engine.n_forwards
    engine.warmup(range(C), (IMG, IMG))
    assert engine.n_forwards == before + len(engine.buckets)


def test_channel_ids_out_of_range_are_refused(setup):
    engine, _ = setup
    with pytest.raises(ValueError, match="out of range"):
        engine.predict(np.zeros((1, 1, IMG, IMG), np.float32), [C])


def test_engine_needs_an_explicit_cpu_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(setup[0].model)


def test_dynamic_batcher_roundtrip(setup):
    """Each submitted image gets its own row back, across mixed channel
    subsets in one queue."""
    engine, jax_forward = setup
    rng = np.random.default_rng(4)
    imgs_full = rng.normal(size=(6, C, IMG, IMG)).astype(np.float32)
    imgs_sub = rng.normal(size=(2, 2, IMG, IMG)).astype(np.float32)
    engine.start()
    try:
        futs = [engine.submit(im, range(C)) for im in imgs_full]
        futs += [engine.submit(im, [0, 2]) for im in imgs_sub]
        rows = [f.result(timeout=60) for f in futs]
    finally:
        engine.stop()
    assert _rel(np.stack(rows[:6]), jax_forward(imgs_full, np.arange(C))) <= 1e-4
    assert _rel(np.stack(rows[6:]), jax_forward(imgs_sub, np.array([0, 2]))) <= 1e-4
    assert engine.stats.summary()["n_images"] >= 8


def _post(port, body, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=body,
                                 headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def test_http_roundtrip(setup):
    engine, jax_forward = setup
    rng = np.random.default_rng(5)
    one = rng.normal(size=(C, IMG, IMG)).astype(np.float32)
    batch = rng.normal(size=(3, 2, IMG, IMG)).astype(np.float32)
    with ServingHTTPServer(engine, port=0) as srv:
        body = json.dumps({"channels": list(range(C)), "images": one.tolist()}).encode()
        out = json.loads(_post(srv.port, body, {"Content-Type": "application/json"}))
        assert _rel(np.asarray(out["outputs"]), jax_forward(one[None], np.arange(C))[0]) <= 1e-4

        buf = io.BytesIO()
        np.save(buf, batch)
        raw = _post(srv.port, buf.getvalue(),
                    {"Content-Type": "application/x-npy", "X-Channels": "1,3"})
        got = np.load(io.BytesIO(raw), allow_pickle=False)
        assert _rel(got, jax_forward(batch, np.array([1, 3]))) <= 1e-4

        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz") as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/stats") as resp:
            assert "p99_ms" in json.loads(resp.read())
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(srv.port, json.dumps({"channels": [0], "images": [[1.0]]}).encode(),
                  {"Content-Type": "application/json"})
        assert bad.value.code == 400

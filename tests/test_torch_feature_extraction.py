"""The port's feature-extraction CLI (``diverse_channel_vit_torch/
evaluation/feature_extraction.py``) and embedding figures
(``evaluation/benchmark.py``) against the JAX package's, on the CPU.

- ``features.npy`` of CHAMMI's HPA dataset (4 channels) of
  scripts/make_chammi_fixture.py's tree at 42² (24 images a chunk, batch
  10: a padded last batch) with
  ``resnet18_jax``, ``dinov2_jax`` and ``convnext_jax`` from state dicts
  this test writes (a torchvision-layout ResNet with one block a stage and
  BatchNorm statistics, its layers read from the state dict by both
  packages; a small hub-layout DINOv2, D = 64 in 2 heads, ``--heads 2``; a
  timm-layout ConvNeXt, tests/test_torch_convnext.py's, the trunk cut to
  depths (1, 1, 1, 1) in both packages, its images resized to 64², where
  every stage's grid is even: JAX's downsampling convolutions pad an odd
  grid, timm's and the port's floor it), against JAX's
  ``get_save_features`` on the same files: within 1e-4 of max|feature| (f32
  in other summation orders; the port's ResNet folds each BatchNorm into its
  convolution). At 42² no DINOv2 padding is needed; at 32² the port pads as
  the reference's ``create_pad`` and JAX's host function ``run`` do, and
  its features equal that function's on the replicated batch. XLA's
  optimisation passes are off while the JAX side compiles.
- The CLI writes (N, C * 768) ``convnext_jax`` features; ``convnext`` raises ``NotImplementedError``
  naming ROADMAP A7; the CLI runs on the card unless ``--device cpu`` is
  given, so here it raises without it.
- The embedding figure: the port's numpy PCA (for a card without
  scikit-learn) against scikit-learn's ``PCA``, which the JAX package and the
  port use where it imports, within 1e-4 of max|coordinate|;
  ``run_benchmark(umap=True)`` writes each dataset's PCA figure, as JAX's
  does on the same (random) features, and the same scores.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.evaluation import benchmark as jbenchmark
from diverse_channel_vit_tpu.evaluation import feature_extraction as jfe
from diverse_channel_vit_torch.evaluation import benchmark
from diverse_channel_vit_torch.evaluation import feature_extraction as fe
from diverse_channel_vit_torch.models import convnext
from diverse_channel_vit_torch.models.resnet import RESNET18_LAYERS
from test_torch_convnext import CUT, _timm_state
from test_torch_dinov2 import hub_state

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True, scope="module")
def _fast_compiles_cut_trunk_two_threads():
    """XLA's optimisation passes off while the JAX references compile (they
    cost the compile, not the numbers, a few f32 ulps); the ConvNeXt trunk
    cut to depths (1, 1, 1, 1) in both packages (the port's
    ``convnext.TINY``, the default of JAX's ``jax_convnext_backbone``);
    torch on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(convnext, "TINY", CUT)
            mp.setitem(jfe.jax_convnext_backbone.__kwdefaults__, "depths", CUT["depths"])
            yield
    finally:
        jax.config.update("jax_disable_most_optimizations", opt)
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from scripts.make_chammi_fixture import main as make_fixture

    root = tmp_path_factory.mktemp("chammi_fe")
    make_fixture(str(root), n=24, img=42)
    return str(root)


def resnet_state(rng, layers=RESNET18_LAYERS) -> dict:
    """A torchvision-layout ResNet state dict drawn by numpy, with
    BatchNorm statistics and the ``fc`` head the extractor ignores."""
    sd = {}

    def conv_bn(conv, bn, cout, cin, k):
        sd[conv + ".weight"] = rng.normal(size=(cout, cin, k, k)) * np.sqrt(2.0 / (cin * k * k))
        sd[bn + ".weight"] = 1 + 0.1 * rng.normal(size=cout)
        sd[bn + ".bias"] = 0.1 * rng.normal(size=cout)
        sd[bn + ".running_mean"] = 0.1 * rng.normal(size=cout)
        sd[bn + ".running_var"] = 1 + 0.2 * rng.random(size=cout)
        sd[bn + ".num_batches_tracked"] = np.asarray(7)

    conv_bn("conv1", "bn1", 64, 3, 7)
    cin = 64
    for li, (n, cout) in enumerate(zip(layers, (64, 128, 256, 512))):
        for bi in range(n):
            t = f"layer{li + 1}.{bi}"
            stride = 2 if (li > 0 and bi == 0) else 1
            conv_bn(t + ".conv1", t + ".bn1", cout, cin, 3)
            conv_bn(t + ".conv2", t + ".bn2", cout, cout, 3)
            if stride != 1 or cin != cout:
                conv_bn(t + ".downsample.0", t + ".downsample.1", cout, cin, 1)
            cin = cout
    sd["fc.weight"], sd["fc.bias"] = rng.normal(size=(1000, 512)), rng.normal(size=1000)
    return {k: torch.from_numpy(np.asarray(v, np.int64 if k.endswith("tracked")
                                           else np.float32)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    paths = {"resnet18_jax": str(d / "resnet18.pth"), "dinov2_jax": str(d / "dinov2.pth"),
             "convnext_jax": str(d / "convnext.pth")}
    torch.save(resnet_state(np.random.default_rng(0), layers=(1, 1, 1, 1)),
               paths["resnet18_jax"])
    torch.save({k: torch.from_numpy(v) for k, v in hub_state(np.random.default_rng(1)).items()},
               paths["dinov2_jax"])
    torch.save(_timm_state(np.random.default_rng(3)), paths["convnext_jax"])
    return paths


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("model", ["resnet18_jax", "dinov2_jax", "convnext_jax"])
def test_features_npy_matches_jax(root, weights, tmp_path, model):
    kw = dict(model=model, weights=weights[model], img_size=64 if model == "convnext_jax" else 42,
              batch_size=10, heads=2)
    got = np.load(fe.get_save_features(root, "morphem70k_v2.csv", "HPA", str(tmp_path / "port"),
                                       device="cpu", **kw))
    want = np.load(jfe.get_save_features(root, "morphem70k_v2.csv", "HPA", str(tmp_path / "jax"),
                                         **kw))
    dim = {"resnet18_jax": 512, "dinov2_jax": 64, "convnext_jax": 768}[model]
    assert got.shape == want.shape == (24, 4 * dim) and got.dtype == np.float32
    assert _rel(got, want) <= 1e-4


def test_dinov2_pads_as_the_reference(root, weights):
    """At 32² the image is no multiple of 14: the port pads as ``create_pad``
    and JAX's host function ``run`` do."""
    fn, dim = fe.build_backbone("dinov2_jax", weights["dinov2_jax"], torch.device("cpu"),
                                heads=2)
    run, jdim = jfe.jax_dinov2_backbone(weights["dinov2_jax"], num_heads=2)
    x = np.random.default_rng(2).normal(size=(2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = fn(torch.from_numpy(x).reshape(6, 1, 32, 32)).numpy()
    want = run(fe.channel_replicate(x))
    assert dim == jdim == 64 and got.shape == want.shape == (6, 64)
    assert _rel(got, want) <= 1e-4
    np.testing.assert_array_equal(fe.channel_replicate(x), jfe.channel_replicate(x))


def test_convnext_backbones_and_the_device_default(root, weights, tmp_path):
    path = weights["convnext_jax"]
    out = fe.main(["--root_dir", root, "--dataset", "HPA", "--dest", str(tmp_path / "f"),
                   "--model", "convnext_jax", "--weights", path, "--img_size", "42",
                   "--batch_size", "16", "--device", "cpu"])
    feats = np.load(out)
    assert feats.shape == (24, 4 * 768) and np.isfinite(feats).all()
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        fe.build_backbone("convnext", path, torch.device("cpu"))
    with pytest.raises(ValueError, match="Unsupported backbone"):
        fe.build_backbone("checkpoint", path, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        fe.main(["--root_dir", root, "--dataset", "HPA", "--dest", str(tmp_path / "g"),
                 "--model", "convnext_jax", "--weights", path])


def test_numpy_pca_matches_scikit_learn():
    from sklearn.decomposition import PCA

    rng = np.random.default_rng(4)
    train = (rng.normal(size=(60, 12)) * np.linspace(3, 0.1, 12)).astype(np.float32)
    test = rng.normal(size=(20, 12)).astype(np.float32)
    want = PCA(n_components=2).fit(train).transform(test)
    got = benchmark.numpy_pca_2d(train)(test)
    assert _rel(got, want) <= 1e-4
    np.testing.assert_allclose(benchmark.pca_2d(train)(test), want, rtol=0, atol=0)


def test_run_benchmark_draws_the_figures_as_jax(root, tmp_path):
    feats = str(tmp_path / "feats")
    rng = np.random.default_rng(5)
    for dataset in ("Allen", "HPA", "CP"):
        os.makedirs(os.path.join(feats, dataset))
        np.save(os.path.join(feats, dataset, "features.npy"),
                rng.normal(size=(24, 16)).astype(np.float32))
    got = benchmark.run_benchmark(root, str(tmp_path / "port"), feats, "features.npy",
                                  umap=True, knn_metric="cosine", device="cpu")
    want = jbenchmark.run_benchmark(root, str(tmp_path / "jax"), feats, "features.npy",
                                    umap=True, knn_metric="cosine")
    for side in ("port", "jax"):
        written = os.listdir(tmp_path / side)
        assert {f"{d}_pca.png" for d in ("Allen", "HPA", "CP")} <= set(written), (side, written)
    np.testing.assert_allclose(got["f1_score_macro"], want["f1_score_macro"], rtol=0, atol=0)

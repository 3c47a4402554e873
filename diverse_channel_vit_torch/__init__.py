"""diverse_channel_vit_torch — the channel-adaptive ViT stack in PyTorch for
one NVIDIA H100.

A port of ``diverse_channel_vit_tpu`` (JAX/Flax/Pallas on a TPU), which stays
beside it as the numerical reference. This package imports neither JAX nor
anything of the JAX package; where it needs code of that package it keeps its
own copy. The layout mirrors the JAX package, so each module has a
counterpart of the same name there.

What runs so far is the DiChaViT serving forward: ``models.build_model`` ->
``serving.ServingEngine`` -> ``serving_http.ServingHTTPServer``. The two
TPU kernels on that path are hand-written CUDA kernels for ``sm_90a`` under
``csrc/``, built with nvcc at first use (``ops/kernels.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CPU tensor each kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

"""Every ``pooling_channel_type`` of the port's DepthwiseConvNeXt against
the JAX package's, on the CPU: the way tests/test_torch_convnext.py holds
the factories (the trunk cut to depths (1, 1, 1, 1), one JAX tree carried to
the port, the output within 1e-4 of max|out| and each gradient within 1e-4
of its max|g|), for the seven poolings its factory cases leave out
(``weighted_sum_random`` and ``avg`` are theirs), on CHAMMI's mapper (the
HPA chunk) or the single-chunk one. A file of its own so that
``--dist loadfile`` runs it beside the factories.
"""

import pytest

from test_torch_convnext import _check, _cut_trunk_two_threads, _run  # noqa: F401

POOLINGS = {
    "sum": "chammi", "weighted_sum_one": "single", "weighted_sum_random_no_softmax": "chammi",
    "weighted_sum_one_no_softmax": "single", "weighted_sum_random_pairwise": "chammi",
    "weighted_sum_random_pairwise_no_softmax": "single", "attention": "chammi",
}


@pytest.mark.parametrize("pooling", sorted(POOLINGS))
def test_depthwise_channel_pooling_matches_jax(pooling):
    kind = POOLINGS[pooling]
    r = _run("depthwiseconvnext", kind, "HPA" if kind == "chammi" else None,
             ("++model.patch_size=4", f"++model.pooling_channel_type={pooling}"), None)
    assert r["model"].feature_extractor.pooling_channel_type == pooling
    _check(r)

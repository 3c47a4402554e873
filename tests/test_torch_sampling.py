"""The port's channel sampling (DCS) and the recipe train step against the
JAX package's.

torch and JAX draw different random streams, so the tests take JAX's own
draws from a key and hand them to the port through the seam of
``ops.sampling.dcs_select`` (``anchor``, ``gumbel``), the shared-draw method
of tests/test_trajectory_parity.py. JAX's order: ``dcs_select`` splits its
key into the anchor's key (``randint``) and the noise's key (``gumbel``);
``uniform`` draws the noise from the key itself; the train step first splits
its key in three and samples with the first.

- ``dcs_select`` for the four ported methods, many keys and every k: the
  same indices in the same order (exact: the same f32 cosines and noise, a
  top-k with no ties).
- The recipe: three steps of the JUMP-CP DiChaViT recipe
  (``hcs_method="lowest_cosine_prob"``, temperature 1000) at k = 2, 5 and 8
  of 8 channels on the tiny DiChaViT of tests/test_torch_training.py (48^2,
  patch 16, D = 128, 2 heads, depth 3, B = 2, f32, CE + CDL + TDL), one
  step function per k over one train state in each package: the sampled
  channels equal; losses rtol 1e-5 at step 0 and 1e-4 after, the gradient
  norm rtol 1e-4, and the final parameters within atol lr / 10 (the bounds
  of the f32 train test there); every gradient of every step within 1e-4 of
  max|g| of the JAX step's (read inside its jitted step where it takes
  their norm; the proxy-loss test's f32 bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diverse_channel_vit_tpu.ops import sampling as jsampling
from diverse_channel_vit_tpu.training import create_train_state
from diverse_channel_vit_tpu.training import make_optimizer as j_make_optimizer
from diverse_channel_vit_tpu.training.steps import make_train_step as j_make_train_step
from diverse_channel_vit_torch.models import channel_vit as tcv
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.ops import sampling
from diverse_channel_vit_torch.training import TrainState, make_optimizer, make_train_step

from test_torch_training import C, IMG, LR, NC, OPT, _jax_lr, _jax_model, _port_lr, _port_model

B = 2
TEMP = 1000.0
METHODS = ["uniform", "lowest_cosine", "highest_cosine", "lowest_cosine_prob"]


def jax_draws(key, c: int, method: str) -> dict:
    """The draws JAX's ``dcs_select(key, ...)`` makes, as the port's seam
    takes them."""
    if method == "uniform":
        return {"gumbel": torch.from_numpy(np.array(jax.random.gumbel(key, (c,))))}
    k_anchor, k_sample = jax.random.split(key)
    return {"anchor": torch.tensor(int(jax.random.randint(k_anchor, (), 0, c))),
            "gumbel": torch.from_numpy(np.array(jax.random.gumbel(k_sample, (c,))))}


@pytest.mark.parametrize("method", METHODS)
def test_dcs_select_matches_jax_given_its_draws(method):
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(C, 32)).astype(np.float32)
    seen = set()
    for seed in range(6):
        key = jax.random.key(seed)
        for k in range(1, C + 1):  # eager: a jit would compile once per k
            want = np.asarray(jsampling.dcs_select(key, k, method, channel_embed=jnp.asarray(emb),
                                                   temp=0.5))
            got = sampling.dcs_select(k, method, channel_embed=torch.from_numpy(emb), temp=0.5,
                                      **jax_draws(key, C, method))
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"seed {seed} k {k}")
            seen.add(tuple(want))
    assert len(seen) > 2 * C  # the draws matter
    if method != "uniform":  # the anchor is always kept
        draws = jax_draws(jax.random.key(0), C, method)
        got = sampling.dcs_select(3, method, channel_embed=torch.from_numpy(emb), **draws)
        assert int(draws["anchor"]) in got.tolist()


def test_dcs_select_draws_from_a_generator():
    """Without given draws: k distinct channels, the anchor kept, the same
    channels from the same seed; the methods not ported raise."""
    emb = torch.from_numpy(np.random.default_rng(8).normal(size=(C, 16)).astype(np.float32))
    picks = [sampling.dcs_select(5, "lowest_cosine_prob", channel_embed=emb, temp=TEMP,
                                 generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(picks[0], picks[1]) and len(set(picks[0].tolist())) == 5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sampling.dcs_select(3, "lowest_cosine_prob_proj", channel_embed=emb)
    with pytest.raises(ValueError, match="hcs_sampling"):
        sampling.dcs_select(3, "bogus", channel_embed=emb)


@pytest.fixture(scope="module")
def recipe_start():
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(B, C, IMG, IMG)).astype(np.float32) for _ in range(3)]
    ys = [rng.integers(0, NC, size=B) for _ in range(3)]
    jmodel = _jax_model(jnp.float32)
    params = jax.jit(lambda x: jmodel.init({"params": jax.random.key(0)}, x, jnp.arange(C),
                                           train=False)["params"])(jnp.asarray(xs[0]))
    return xs, ys, params


def test_recipe_steps_match_jax(recipe_start, monkeypatch):
    xs, ys, params = recipe_start
    jax_grads = []  # the JAX step's gradients, read where it takes their norm
    real_norm = optax.global_norm

    def spy(tree):
        jax.debug.callback(lambda t: jax_grads.append(jax.device_get(t)), tree)
        return real_norm(tree)

    monkeypatch.setattr(optax, "global_norm", spy)
    ks = (2, 5, 8)
    jmodel = _jax_model(jnp.float32)
    jtx = j_make_optimizer("adamw", dict(OPT), lr_schedule=_jax_lr(), total_steps=3)
    jstate = create_train_state(jmodel, jtx, rng=jax.random.key(1), sample_input=None,
                                sample_channel_ids=None, params=params)
    jsteps = {k: j_make_train_step(jmodel, channel_ids=range(C), k=k,
                                   hcs_method="lowest_cosine_prob", hcs_temp=TEMP,
                                   loss_type="ce", extra_loss_lambda=1.0, donate=False)
              for k in ks}
    model = _port_model(torch.float32, params_from_jax(params))
    state = TrainState(model, make_optimizer("adamw", dict(OPT), lr_schedule=_port_lr(),
                                             total_steps=3))
    steps = {k: make_train_step(model, channel_ids=range(C), k=k,
                                hcs_method="lowest_cosine_prob", hcs_temp=TEMP,
                                loss_type="ce", extra_loss_lambda=1.0) for k in ks}
    tcv._bicubic_tables.cache_clear()
    names = ("loss", "main_loss", "extra_loss", "grad_norm")
    got, want = [], []
    for t, k in enumerate(ks):
        key = jax.random.key(10 + t)
        jstate, jm = jsteps[k](jstate, {"image": jnp.asarray(xs[t]), "label": jnp.asarray(ys[t])},
                               key)
        # the step samples with the first of its key's three parts
        draws = jax_draws(jax.random.split(key, 3)[0], C, "lowest_cosine_prob")
        state, m = steps[k](state, {"image": torch.from_numpy(xs[t]),
                                    "label": torch.from_numpy(ys[t])}, draws=draws)
        if k < C:
            np.testing.assert_array_equal(m["sampled_channels"].numpy(),
                                          np.asarray(jm["sampled_channels"]))
            assert len(set(m["sampled_channels"].tolist())) == k
            assert int(draws["anchor"]) in m["sampled_channels"].tolist()
        else:
            assert "sampled_channels" not in m and "sampled_channels" not in jm
        want.append([float(jm[n]) for n in names])
        got.append([float(m[n]) for n in names])
        jax.effects_barrier()
        ref = params_from_jax(jax_grads[-1])
        for name, prm in model.named_parameters():
            scale = np.abs(ref[name].numpy()).max()
            err = np.abs(prm.grad.numpy() - ref[name].numpy()).max()
            assert err <= 1e-4 * scale or err <= 1e-12, (t, name, err, scale)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = params_from_jax(jax.device_get(jstate.params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=0, atol=LR / 10,
                                   err_msg=name)
    # one resample table per image geometry, whatever the channel count
    assert tcv._bicubic_tables.cache_info().currsize <= 1

"""The port's SGD, Adam, AdamP and AdamW with a bf16 first moment against the
JAX package's ``make_optimizer`` chains, on the CPU.

- Three updates of the same f32 parameters on the same f32 gradients (made
  with numpy from a seed) through each package's ``make_optimizer``, with and
  without clipping by global norm: each parameter tensor within 1e-6
  relative, max|diff| / max|ref| (the measure tests/test_torch_training.py
  holds gradients to), and the global norm before clipping within rtol
  1e-6. Elementwise relative bounds would not hold for entries near 0: JAX
  computes Adam's bias correction 1 - b2^t in f32 from b2 rounded to f32,
  1.3e-5 off at t = 1 (0.999 is 0.99900001 in f32), where the port's is a
  double, so an Adam update of about lr differs by about 6e-6 of itself,
  and the packages round the same f32 arithmetic in another order. Both take
  the same f32 lr at each update, the port's cosine schedule rounded to f32
  (JAX's own f32 cosine strays up to 5e-6 from it; the schedules are held
  against each other in tests/test_torch_training.py).
- ``mu_dtype=bfloat16``: the stored first moment is bf16 in both and within
  one bf16 ulp of JAX's (optax rounds ``b1 * m`` in bf16, b1 included).
- AdamP: a tensor whose rows are each orthogonal to their gradient takes
  the channel view's projection, one orthogonal only as a whole takes the
  layer view's, a random one and a 1-D one take none; each branch is
  checked on the JAX side's own test of it.
- Param groups: a group at ``lr_mult`` 0.1 and a frozen tensor, against
  JAX's ``multi_transform`` of ``tx``, ``chain(tx, scale(0.1))`` and
  ``set_to_zero`` (the Trainer's MIRO and freezing partitions).
- Checkpoints: each optimizer's state saved after two updates and loaded
  into a fresh ``TrainState`` gives a third update equal bit for bit to the
  uninterrupted one.
- The global norm that clipping divides by is summed in f64.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diverse_channel_vit_tpu.training import make_optimizer as j_make_optimizer
from diverse_channel_vit_tpu.training import optim as joptim
from diverse_channel_vit_torch.training import TrainState, make_lr_schedule, make_optimizer
from diverse_channel_vit_torch.training.checkpoint import load_checkpoint, save_checkpoint

SHAPES = [(6, 40), (8, 30), (5, 24), (24,), (3, 2, 4)]
LR_P = dict(t_initial=5, warmup_t=1, warmup_lr_init=1e-4)
LR_KW = dict(num_epochs=5, steps_per_epoch=2)

CASES = {
    "sgd": ("sgd", dict(momentum=0.9, nesterov=True, weight_decay=5e-4,
                        weight_decay_end=0.4)),
    "adam": ("adam", dict(betas=[0.9, 0.999], eps=1e-8, weight_decay=1e-2)),
    "adamp": ("adamp", dict(betas=[0.9, 0.999], eps=1e-8, weight_decay=1e-2,
                            nesterov=True)),
    "adamw_mu_bf16": ("adamw", dict(betas=[0.9, 0.999], eps=1e-8, weight_decay=0.04,
                                    weight_decay_end=0.4, mu_dtype="bfloat16")),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The port's side on two threads: the suite runs files side by side, and
    torch's default of a thread a core oversubscribes the host (and is no
    faster at these sizes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _orthogonal_rows(rng, p):
    g = rng.normal(size=p.shape)
    g -= p * ((p * g).sum(axis=1, keepdims=True) / (p * p).sum(axis=1, keepdims=True))
    return g


def _orthogonal_whole(rng, p):
    g = rng.normal(size=p.shape)
    return g - p * ((p * g).sum() / (p * p).sum())


def _grads(rng, params):
    """This update's gradients: the first tensor's rows each orthogonal to
    their parameter row, the second's whole gradient orthogonal to it, the
    rest random; scaled so that clipping at 0.5 binds."""
    p = [a.astype(np.float64) for a in params]
    g = [_orthogonal_rows(rng, p[0]), _orthogonal_whole(rng, p[1])]
    g += [rng.normal(size=a.shape) for a in p[2:]]
    return [(0.2 * a).astype(np.float32) for a in g]


_LR = make_lr_schedule("cosine", 1e-2, dict(LR_P), **LR_KW)
LRS = np.asarray([_LR(s) for s in range(6)], np.float32)


def _jax_tx(name, opt, clip):
    table = jnp.asarray(LRS)
    return j_make_optimizer(name, dict(opt), total_steps=6, clip_grad_norm=clip,
                            lr_schedule=lambda s: table[s])


def _port_tx(name, opt, clip):
    return make_optimizer(name, dict(opt), total_steps=6, clip_grad_norm=clip,
                          lr_schedule=lambda s: float(LRS[s]))


def _close(mine, theirs, rel=1e-6):
    for i, (p, w) in enumerate(zip(mine, theirs)):
        w = np.asarray(w)
        err = np.abs(p.detach().numpy() - w).max() / np.abs(w).max()
        assert err <= rel, (i, err)


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny))) - 7)


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax_chain(case, clip):
    name, opt = CASES[case]
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    jtx = _jax_tx(name, opt, clip)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tx = _port_tx(name, opt, clip)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    o = tx.init(tp)
    branches = set()
    for step in range(3):
        g = _grads(rng, [np.asarray(a) for a in jp])
        jg = [jnp.asarray(a) for a in g]
        if name == "adamp":
            for i, (p, a) in enumerate(zip(jp[:3], jg[:3])):
                cond_c, _ = joptim._view_cosine_and_project(p, a, a, 1e-30,
                                                            lambda x: x.reshape(x.shape[0], -1))
                cond_l, _ = joptim._view_cosine_and_project(p, a, a, 1e-30,
                                                            lambda x: x.reshape(1, -1))
                branches.add((i, "channel" if cond_c else "layer" if cond_l else "none"))
        want_norm = float(optax.global_norm(jg))
        upd, jstate = jtx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        norm = tx.update(o, step)
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        _close(tp, jp)
    if name == "adamp":
        assert branches == {(0, "channel"), (1, "layer"), (2, "none")}
    if opt.get("mu_dtype"):
        (adam_state,) = [s for s in jax_leaves_states(jstate)
                         if isinstance(s, optax.ScaleByAdamState)]
        for p, m in zip(tp, adam_state.mu):
            mine = o.state[p]["exp_avg"]
            assert mine.dtype == torch.bfloat16 and m.dtype == jnp.bfloat16
            mine, theirs = mine.float().numpy(), np.asarray(m, np.float32)
            assert (np.abs(mine - theirs) <= _bf16_ulp(theirs)).all()


def jax_leaves_states(state):
    """Every optax state in a (possibly nested) chain state."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return [s for part in state for s in jax_leaves_states(part)]
    return [state]


def test_lr_mult_group_and_frozen_tensor_match_multi_transform():
    """AdamP (any optimizer takes the same groups): tensors 0-1 at the base
    lr, 2-3 at lr_mult 0.1 (MIRO's encoders), 4 frozen, each partition
    clipped by its own norm, against optax's ``multi_transform``."""
    name, opt = CASES["adamp"]
    rng = np.random.default_rng(1)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    labels = ["base", "base", "mult", "mult", "frozen"]
    jtx = optax.multi_transform(
        {"base": _jax_tx(name, opt, 0.5),
         "mult": optax.chain(_jax_tx(name, opt, 0.5), optax.scale(0.1)),
         "frozen": optax.set_to_zero()}, labels)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    tx = _port_tx(name, opt, 0.5)
    o = tx.init([{"params": tp[:2]}, {"params": tp[2:4], "lr_mult": 0.1}])
    for step in range(3):
        g = _grads(rng, [np.asarray(a) for a in jp])
        upd, jstate = jtx.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        tx.update(o, step)
    _close(tp, jp)
    np.testing.assert_array_equal(tp[4].detach().numpy(), params[4])


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        rng = np.random.default_rng(2)
        self.w = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(6,)).astype(np.float32)))


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_state_round_trips_bit_exact(case, tmp_path):
    name, opt = CASES[case]
    rng = np.random.default_rng(3)
    grads = [[torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((6, 40), (6,))]
             for _ in range(3)]

    def run(state, steps):
        for g in steps:
            state.zero_grad()
            for p, a in zip(state.params, g):
                p.grad = a.clone()
            state.apply_gradients()

    ref = TrainState(_Tiny(), _port_tx(name, opt, 0.5))
    run(ref, grads[:2])
    save_checkpoint(str(tmp_path), ref, epoch=1)
    run(ref, grads[2:])
    resumed = TrainState(_Tiny(), _port_tx(name, opt, 0.5))
    load_checkpoint(str(tmp_path), resumed)
    assert resumed.step == 2
    run(resumed, grads[2:])
    for a, b in zip(ref.params, resumed.params):
        assert torch.equal(a, b)
    for a, b in zip(ref.optimizer.state.values(), resumed.optimizer.state.values()):
        for key in a:
            va, vb = a[key], b[key]
            if torch.is_tensor(va):
                assert va.dtype == vb.dtype and torch.equal(va, vb), key
            else:
                assert va == vb, key


def test_global_norm_is_summed_in_f64():
    """Clipping's global norm over a block's worth of entries (about 1.3
    million): within f32 rounding (rtol 2e-7) of the exact norm, and of
    optax's on the same arrays within rtol 1e-6. torch's f32 reductions on
    the CPU drift by about 3e-6 here, which every clipped moment carries."""
    from diverse_channel_vit_torch.training.optim import global_norm

    rng = np.random.default_rng(4)
    arrays = [(0.02 * rng.standard_normal(s)).astype(np.float32)
              for s in [(1152, 384), (1152,), (1536, 384), (384, 1536)]]
    exact = np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in arrays))
    got = global_norm([torch.from_numpy(a) for a in arrays])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), exact, rtol=2e-7)
    np.testing.assert_allclose(float(got), float(optax.global_norm(
        [jnp.asarray(a) for a in arrays])), rtol=1e-6)

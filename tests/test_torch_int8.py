"""The port's int8 ``ln_mlp`` path (``model.quantization = "int8"``) against the
JAX package's.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels ``_ln_mlp_q_fwd_kernel`` / ``_ln_mlp_q_bwd_kernel`` in
interpret mode (``attention.INTERPRET`` is set for every test by
tests/conftest.py, ``fused_block.FORCE_ON_CPU`` here), jitted. The same
numpy inputs, made from a seed, go to both; weights go to the port in
``nn.Linear`` layout, the transpose of the JAX layout.

- The quantisers: ``quant_rows_f32`` and ``quantize_weight`` for the four
  weight copies against ``_quant_rows_f32`` and ``quantize_weight``, run
  eagerly: codes and scales equal. Jitted, XLA's CPU compiler turns the
  division by 127 into a multiplication by its reciprocal, so some scales
  land one f32 ulp from the eager ones and a code next to a .5 tie may differ
  by 1; the test bounds that too (scales within 2 ulps, codes within 1, at
  most 2% of the codes differing; measured: 3-10 of 512 scales, no code).
- The plain forward and backward through ``ln_mlp(..., quantized=True)``
  (``LnMlpFn``) against ``jax.grad`` through the JAX custom VJP: the value
  and all seven gradients, max|port - jax| <= tol * max|jax|. Both sides
  round at the same points; what differs is f32 noise in the LayerNorm and
  the GELU's tanh (other libraries), which can move a value across a .5 tie
  and flip one int8 code; a flipped code moves one product term by one
  quantisation step. Measured up to 3.4e-3 in f32 and 6.2e-3 in bf16 over
  several seeds: tol 1e-2 in f32, 2e-2 in bf16 (bf16 outputs also land a
  bf16 ulp, 2^-7, apart). The same at the base preset's widths (D = 768,
  hidden 3072) on 16 rows.
- The slice as a whole: the tiny DiChaViT of tests/test_torch_training.py
  (N = 64 tokens, D = 128, 2 heads, depth 3, B = 2, bf16) with
  ``quantization: int8`` against the JAX model under
  ``set_quantization("int8")`` (restored in a ``finally``): the logits, and
  three train steps (losses) plus the step-0 gradients. The same geometry at
  the base preset's widths (D = 768, 12 heads of 64, MLP 3072) at depth 2
  (block 0 fused, block 1 the CLS readout): the logits, the step-0 loss and
  the step-0 gradients, with the same bounds.
- ``ServingEngine(quantization=...)``: scoped to the engine's forwards
  (``predict`` and ``submit``), the model's own setting untouched, and
  ``ValueError`` on an unknown mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diverse_channel_vit_tpu.ops import fused_block as jfb
from diverse_channel_vit_tpu.training import make_optimizer as j_make_optimizer
from diverse_channel_vit_tpu.training.steps import _loss_and_metrics as j_loss_and_metrics
from diverse_channel_vit_torch.config import Config
from diverse_channel_vit_torch.models import build_model
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.ops import fused_block as fb
from diverse_channel_vit_torch.serving import ServingEngine
from diverse_channel_vit_torch.training import TrainState, make_optimizer, make_train_step

from test_torch_training import IDS, OPT, _jax_lr, _jax_model, _port_lr, _port_model

B, N, D = 2, 64, 128
HID = 4 * D
TOL = {"float32": 1e-2, "bfloat16": 2e-2}


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


@pytest.fixture
def fused_jax(monkeypatch):
    monkeypatch.setattr(jfb, "FORCE_ON_CPU", True)


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


# the port's copy (nn.Linear layout, reduced over `dim`) and the JAX call it mirrors
WEIGHT_COPIES = {
    "w1q": ("w1", 1, 0),  # per hidden unit: the forward fc1
    "w2q": ("w2", 1, 0),  # per output unit: the forward fc2
    "w1r": ("w1", 0, 1),  # per input unit: the dgrad of fc1
    "w2r": ("w2", 0, 1),  # per hidden unit: the dgrad of fc2
}


@pytest.mark.parametrize("what", ["rows", *WEIGHT_COPIES])
def test_quantizers_match_jax(what):
    rng = np.random.default_rng(3)
    if what == "rows":
        # rows at scales 1e-3..3, and one row of zeros (the 1e-8 floor)
        x = rng.normal(size=(96, HID)) * rng.uniform(1e-3, 3.0, size=(96, 1))
        x[5] = 0.0
        jx, tx = _pair(x, "float32")
        jfn, got = jfb._quant_rows_f32, fb.quant_rows_f32(tx)
        layout = lambda a: a  # noqa: E731
    else:
        name, dim, jaxis = WEIGHT_COPIES[what]
        shape = (D, HID) if name == "w1" else (HID, D)  # JAX layout
        w = 0.05 * rng.normal(size=shape)
        w[:, 3] = 0.0  # a unit of zeros (the 1e-12 floor) in either reduction
        w[7, :] = 0.0
        jx, tx = _pair(w, "bfloat16")  # the compute-dtype cast, as the model quantises it
        jfn = lambda a: jfb.quantize_weight(a, jaxis)  # noqa: E731
        got = fb.quantize_weight(tx.t(), dim)
        layout = lambda a: a.T  # noqa: E731  (nn.Linear layout)
    codes, scale = (t.numpy() for t in got)
    assert codes.dtype == np.int8 and scale.dtype == np.float32
    want_codes, want_scale = jfn(jx)
    np.testing.assert_array_equal(codes, layout(np.asarray(want_codes)))
    np.testing.assert_array_equal(scale, np.asarray(want_scale))
    # jitted, the scale may differ by an ulp (multiplication by 1/127)
    jit_codes, jit_scale = (np.asarray(a) for a in jax.jit(jfn)(jx))
    jit_codes, ulp = layout(jit_codes), np.spacing(np.abs(scale))
    assert np.all(np.abs(jit_scale - scale) <= 2 * ulp)
    assert np.all(np.abs(jit_codes.astype(np.int32) - codes) <= 1)
    assert np.mean(jit_codes != codes) <= 0.02


def test_quantize_mlp_weights_layouts():
    """Each int8 copy is k-major for the product that reads it and equals
    the JAX array (forward copies transposed: the JAX weights are (in, out))."""
    rng = np.random.default_rng(4)
    jw1, tw1 = _pair(0.05 * rng.normal(size=(D, HID)), "bfloat16")
    jw2, tw2 = _pair(0.05 * rng.normal(size=(HID, D)), "bfloat16")
    got = fb.quantize_mlp_weights(tw1.t().contiguous(), tw2.t().contiguous(), backward=True)
    want = (*jfb.quantize_weight(jw1, 0), *jfb.quantize_weight(jw2, 0),
            *jfb.quantize_weight(jw1, 1), *jfb.quantize_weight(jw2, 1))
    shapes = [(HID, D), (HID,), (D, HID), (D,), (D, HID), (D,), (HID, D), (HID,)]
    for i, (g, w, shape) in enumerate(zip(got, want, shapes)):
        assert tuple(g.shape) == shape and g.is_contiguous(), i
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.T if i in (0, 2) else w, err_msg=str(i))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_int8_value_and_grads_match_jax(fused_jax, dtype, residual, shape=(B, N, D)):
    rng = np.random.default_rng(5)
    names = ("x", "s", "bi", "w1", "b1", "w2", "b2")
    d = shape[-1]
    hid = 4 * d
    pairs = dict(
        x=_pair(rng.normal(size=shape), dtype),
        s=_pair(1.0 + 0.1 * rng.normal(size=(d,)), "float32"),
        bi=_pair(0.1 * rng.normal(size=(d,)), "float32"),
        w1=_pair(0.05 * rng.normal(size=(d, hid)), dtype),
        b1=_pair(0.05 * rng.normal(size=(hid,)), dtype),
        w2=_pair(0.05 * rng.normal(size=(hid, d)), dtype),
        b2=_pair(0.05 * rng.normal(size=(d,)), dtype),
    )
    jg, tg = _pair(rng.normal(size=shape), dtype)

    def jloss(*a):
        out = jfb.ln_mlp(*a, residual, True)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32)), out

    (_, jout), want = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(7)), has_aux=True))(
        *(pairs[k][0] for k in names))
    t = {k: pairs[k][1].clone().requires_grad_() for k in names}
    out = fb.ln_mlp(t["x"], t["s"], t["bi"], t["w1"].t(), t["b1"], t["w2"].t(), t["b2"],
                    residual=residual, quantized=True)
    assert out.dtype == t["x"].dtype
    assert _rel(out.detach(), jout) <= TOL[dtype]
    out.backward(tg)
    for k, w in zip(names, want):
        assert t[k].grad.dtype == t[k].dtype
        assert _rel(t[k].grad, w) <= TOL[dtype], k
    # the int8 path is not the bf16 one: quantisation moves the output
    dense = fb.ln_mlp(*(pairs[k][1] for k in ("x", "s", "bi")), pairs["w1"][1].t(),
                      pairs["b1"][1], pairs["w2"][1].t(), pairs["b2"][1], residual=residual)
    assert not torch.equal(dense, out.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_int8_value_and_grads_match_jax_d768(fused_jax, dtype, residual):
    """The same at the base preset's widths, D = 768 and hidden 3072, on 16
    rows (the JAX kernels run in interpret mode)."""
    test_ln_mlp_int8_value_and_grads_match_jax(fused_jax, dtype, residual, shape=(1, 16, 768))


# --- the slice as a whole -------------------------------------------------


def test_plain_check_outputs():
    """The plain versions' check outputs, which the card's kernels are held
    to: codes first, then h in bf16; the backward's recomputed h is the
    forward's bit for bit; the forward's codes are h's row quantisation."""
    rng = np.random.default_rng(3)
    d, hid = 384, 768
    x, do = (torch.from_numpy(rng.standard_normal((1, 40, d), dtype=np.float32)) for _ in "ab")
    s, b = torch.ones(d), torch.zeros(d)
    w1 = torch.from_numpy(rng.standard_normal((hid, d), dtype=np.float32)) * d ** -0.5
    w2 = torch.from_numpy(rng.standard_normal((d, hid), dtype=np.float32)) * hid ** -0.5
    b1, b2 = torch.zeros(hid), torch.zeros(d)
    w1q, s1c, w2q, s2c, w1r, s1r, w2r, s2r = fb.quantize_mlp_weights(w1, w2, backward=True)
    out, codes, h = fb.ln_mlp_q_fwd(x, s, b, w1q, s1c, b1, w2q, s2c, b2, True,
                                    with_codes=True, with_h=True)
    assert torch.equal(out, fb.ln_mlp_q_fwd(x, s, b, w1q, s1c, b1, w2q, s2c, b2, True))
    assert codes.shape == h.shape == (40, hid) and h.dtype == torch.bfloat16
    grads = fb.ln_mlp_q_bwd(x, s, b, w1q, s1c, b1, w1r, s1r, w2r, s2r, do, True,
                            with_codes=True, with_h=True)
    assert len(grads) == 9 and grads[7].dtype == torch.int8
    assert torch.equal(grads[8], h)
    assert torch.equal(fb.ln_mlp_q_bwd(x, s, b, w1q, s1c, b1, w1r, s1r, w2r, s2r, do, True,
                                       with_h=True)[7], h)
    # the codes of h: |h| / its row scale, within one code of the rounded h's
    assert (codes.float() - fb.quant_rows_f32(h.float())[0].float()).abs().max() <= 1


def test_gelu_table_checks_only_the_kernel():
    """The GELU table reads the kernel's own GELU: it has no plain version
    and refuses a CPU device rather than check another function."""
    with pytest.raises(ValueError, match="CUDA"):
        fb.gelu_tanh_rn_table(0, 16, "cpu")


def test_build_model_reads_quantization():
    cfg = dict(in_channel_names=["a", "b"], img_size=[32], patch_size=16,
               pretrained_model_name="test")
    kw = dict(mapper={"x": [0, 1]}, num_classes=3, device="cpu")
    plain = build_model("dichavit", Config(cfg), **kw)
    q = build_model("dichavit", Config({**cfg, "quantization": "int8"}), **kw)
    assert {b.quantization for b in plain.feature_extractor.blocks} == {"none"}
    assert {b.quantization for b in q.feature_extractor.blocks} == {"int8"}
    with pytest.raises(ValueError, match="quantization"):
        build_model("dichavit", Config({**cfg, "quantization": "fp4"}), **kw)


@pytest.fixture(scope="module")
def tiny():
    """Three batches and the tiny model's weights (``params_from_jax`` layout
    source), LayerNorm affines and biases moved off 1/0 so that they count;
    the init jitted (an eager flax init takes seconds)."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(B, len(IDS), 48, 48)).astype(np.float32) for _ in range(3)]
    ys = [rng.integers(0, 5, size=B) for _ in range(3)]
    jmodel = _jax_model(jnp.float32)
    params = jax.jit(lambda x: jmodel.init({"params": jax.random.key(0)}, x, jnp.asarray(IDS),
                                           train=False)["params"])(jnp.asarray(xs[0]))
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    moved = [np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)
             if any(getattr(k, "key", "") in ("bias", "scale", "proj_bias") for k in path)
             else np.asarray(a) for path, a in leaves]
    return xs, ys, jax.tree_util.tree_unflatten(tree, moved)


def test_int8_logits_and_train_steps_match_jax(tiny, fused_jax):
    """Logits of the eval forward, then three AdamW steps of CE + CDL + TDL
    from the same weights. The JAX side takes its steps as its train step
    does (``_loss_and_metrics`` under ``jax.grad``, then the optax update),
    compiled once for the three. Per step the loss within rel 3e-2 (the bf16
    train test's bound); at step 0 every gradient within 5e-2 of max|g| of
    the JAX one (the int8 dgrads add per-GEMM quantisation noise of ~1/127 on
    both sides, rounded at the same points, through three blocks). Later
    gradients are not compared: Adam moves every weight by about lr whatever
    the size of its gradient, so where a gradient is near zero the two
    packages may step a weight in opposite directions."""
    xs, ys, params = tiny
    calls = []
    real = jfb._ln_mlp_q_bwd_impl
    jfb.set_quantization("int8")
    try:
        jmodel = _jax_model(jnp.bfloat16)
        apply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, jnp.asarray(IDS),
                                                  train=False)[0])
        want_logits = np.asarray(apply(params, jnp.asarray(xs[0])), np.float32)
        jfb._ln_mlp_q_bwd_impl = lambda *a: calls.append(1) or real(*a)

        def jloss(p, x, y):
            return j_loss_and_metrics(jmodel, p, x, jnp.asarray(IDS), y, jax.random.key(0),
                                      loss_type="ce", extra_loss_lambda=1.0,
                                      learnable_temp=False, temperature=0.11111)

        grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        jtx = j_make_optimizer("adamw", dict(OPT), lr_schedule=_jax_lr(), total_steps=3)
        opt_state, p = jtx.init(params), params
        want = []
        for t in range(3):
            (loss, _), g = grad_fn(p, jnp.asarray(xs[t]), jnp.asarray(ys[t]))
            want.append((float(loss), params_from_jax(jax.device_get(g))))
            updates, opt_state = jtx.update(g, opt_state, p)
            p = optax.apply_updates(p, updates)
        assert len(calls) == 2  # the int8 backward kernel of blocks 0-1 (block 2 the readout)
    finally:
        jfb._ln_mlp_q_bwd_impl = real
        jfb.set_quantization("none")

    model = _port_model(torch.bfloat16, params_from_jax(params), quantization="int8")
    dense = _port_model(torch.bfloat16, params_from_jax(params))
    with torch.no_grad():
        logits, dense_logits = (m.eval()(torch.from_numpy(xs[0]), torch.tensor(IDS))[0]
                                .float().numpy() for m in (model, dense))
    assert _rel(logits, want_logits) <= 3e-2
    assert not np.array_equal(logits, dense_logits)  # the int8 GEMMs engaged

    before = dict(fb.LAUNCHES)
    state = TrainState(model, make_optimizer("adamw", dict(OPT), lr_schedule=_port_lr(),
                                             total_steps=3))
    step = make_train_step(model, channel_ids=IDS, loss_type="ce", extra_loss_lambda=1.0)
    for t, (want_loss, want_grads) in enumerate(want):
        state, m = step(state, {"image": torch.from_numpy(xs[t]),
                                "label": torch.from_numpy(ys[t])})
        assert abs(float(m["loss"]) - want_loss) <= 3e-2 * abs(want_loss), t
        if t:  # after an Adam step, near-zero gradients of either sign part the weights
            continue
        for name, prm in model.named_parameters():
            ref = want_grads[name].numpy()
            if not np.abs(ref).max():  # the class proxies: unused by the CE loss
                continue
            err = np.abs(prm.grad.float().numpy() - ref).max()
            assert err <= 5e-2 * np.abs(ref).max(), (t, name)
    assert dict(fb.LAUNCHES) == before  # the CPU runs the plain versions


# the base preset's widths (DiChaViT-B) at depth 2 on the tiny model's geometry
BASE_WIDTHS = dict(d=768, h=12, depth=2)


@pytest.fixture(scope="module")
def base_start():
    """A batch and base-width weights (LayerNorm affines and biases moved
    off 1/0), the init jitted."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, len(IDS), 48, 48)).astype(np.float32)
    y = rng.integers(0, 5, size=B)
    jmodel = _jax_model(jnp.float32, **BASE_WIDTHS)
    params = jax.jit(lambda a: jmodel.init({"params": jax.random.key(0)}, a, jnp.asarray(IDS),
                                           train=False)["params"])(jnp.asarray(x))
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    moved = [np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)
             if any(getattr(k, "key", "") in ("bias", "scale", "proj_bias") for k in path)
             else np.asarray(a) for path, a in leaves]
    return x, y, jax.tree_util.tree_unflatten(tree, moved)


def test_base_int8_logits_and_step0_grads_match_jax(base_start, fused_jax):
    """DiChaViT-B widths with ``quantization: int8`` at depth 2: the eval
    logits, then one train step of CE + CDL + TDL from the same weights, its
    loss and every step-0 gradient, against the JAX model under
    ``set_quantization("int8")`` with its int8 kernels in interpret mode.
    Bounds as in test_int8_logits_and_train_steps_match_jax: logits and loss
    within rel 3e-2, each gradient within 5e-2 of max|g| of the JAX one
    (nearest: the readout block's qkv bias at 4.0e-2 and the patch
    embedding's bias, which the JAX step sums in bf16; ROADMAP C)."""
    x, y, params = base_start
    calls = []
    real = jfb._ln_mlp_q_bwd_impl
    jfb.set_quantization("int8")
    try:
        jmodel = _jax_model(jnp.bfloat16, **BASE_WIDTHS)
        want_logits = np.asarray(jax.jit(lambda p, a: jmodel.apply(
            {"params": p}, a, jnp.asarray(IDS), train=False)[0])(params, jnp.asarray(x)),
            np.float32)
        jfb._ln_mlp_q_bwd_impl = lambda *a: calls.append(1) or real(*a)

        def jloss(p):
            return j_loss_and_metrics(jmodel, p, jnp.asarray(x), jnp.asarray(IDS),
                                      jnp.asarray(y), jax.random.key(0), loss_type="ce",
                                      extra_loss_lambda=1.0, learnable_temp=False,
                                      temperature=0.11111)

        (want_loss, _), g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
        want_grads = params_from_jax(jax.device_get(g))
        assert len(calls) == 1  # block 0's int8 backward kernel (block 1 the readout)
    finally:
        jfb._ln_mlp_q_bwd_impl = real
        jfb.set_quantization("none")

    model = _port_model(torch.bfloat16, params_from_jax(params), quantization="int8",
                        **BASE_WIDTHS)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x), torch.tensor(IDS))[0].float().numpy()
    assert _rel(logits, want_logits) <= 3e-2
    state = TrainState(model, make_optimizer("adamw", dict(OPT), lr_schedule=_port_lr(),
                                             total_steps=1))
    step = make_train_step(model, channel_ids=IDS, loss_type="ce", extra_loss_lambda=1.0)
    state, m = step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert abs(float(m["loss"]) - float(want_loss)) <= 3e-2 * abs(float(want_loss))
    for name, prm in model.named_parameters():
        ref = want_grads[name].numpy()
        if not np.abs(ref).max():  # the class proxies: unused by the CE loss
            continue
        err = np.abs(prm.grad.float().numpy() - ref).max()
        assert err <= 5e-2 * np.abs(ref).max(), name


def test_serving_engine_scopes_quantization(tiny):
    """Two engines over one bf16 model: the int8 engine's ``predict`` and
    ``submit`` (run on the collector thread) give the int8 logits, the other
    engine's the bf16 ones, and the model's own setting stays ``"none"``."""
    xs, _, params = tiny
    model = _port_model(torch.bfloat16, params_from_jax(params))
    imgs = xs[0]
    dense_engine = ServingEngine(model, buckets=(2,), device="cpu")
    q_engine = ServingEngine(model, buckets=(2,), device="cpu", quantization="int8")
    none_engine = ServingEngine(model, buckets=(2,), device="cpu", quantization="none")
    dense = dense_engine.predict(imgs, IDS)
    q = q_engine.predict(imgs, IDS)
    q_engine.start()
    try:
        q_sub = np.stack([f.result(timeout=120) for f in
                          [q_engine.submit(im, IDS) for im in imgs]])
    finally:
        q_engine.stop()
    assert {b.quantization for b in model.feature_extractor.blocks} == {"none"}
    assert fb.quantization_override() is None
    with torch.no_grad(), fb.quantization("int8"):
        want_q = model.eval()(torch.from_numpy(imgs), torch.tensor(IDS))[0].float().numpy()
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_allclose(q_sub, q, rtol=0, atol=1e-6 * np.abs(q).max())
    np.testing.assert_array_equal(none_engine.predict(imgs, IDS), dense)
    assert np.any(dense != q)
    assert _rel(q, dense) <= 5e-2  # forward-only per-GEMM quantisation error
    with pytest.raises(ValueError, match="quantization"):
        ServingEngine(model, device="cpu", quantization="fp4")

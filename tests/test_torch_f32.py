"""The port's f32 route (``train.dtype=float32``, the reference's own
precision) against the JAX package's, on the CPU.

On the card an f32 model takes the unfused route in every block, and
``flash_attention_packed`` launches B5 and B6 in f32 (csrc/flash_f32.cuh);
on the CPU the wrappers take their plain versions, so these tests hold what
surrounds the kernels: the shapes and strides they are given, the path's
arithmetic against JAX's, and the TF32 policy. The f32 paths that other
files already hold against JAX: the op against the Pallas kernels in
interpret mode (tests/test_torch_attention.py, ``test_flash_packed_matches_jax``
in f32), the f32 forward (tests/test_torch_model.py), three f32 train steps
and three EViT ones (tests/test_torch_training.py), the PPT ``block_v2``
step (tests/test_torch_ppt.py), the recipe at k = 2, 5 and 8
(tests/test_torch_sampling.py) and the f32 Trainer
(tests/test_torch_trainer.py). Here:

- ``_flash_check`` and ``_row_stride`` take f32 views of one packed qkv
  tensor with their real strides, at head widths 64 and 128, and pick the
  f32 kernels; they refuse float16 (ROADMAP B.5), head width 192 (B.3) and
  an f32 row stride that is no multiple of 16 bytes.
- ``Attention``, the EViT block and PPT's ``AttentionWithScores`` hand
  ``flash_attention_packed`` their q, k and v as views of the qkv GEMM's one
  output (no copy), which the kernels' checks take.
- The DCS recipe's f32 steps at k = 1 and 3 (the recipe's smallest grids)
  against JAX's with ``attention_impl="pallas"``, so that JAX runs the TPU
  kernels ``_packed_fwd_kernel`` / ``_packed_bwd_kernel`` in f32 (interpret
  mode, set by tests/conftest.py), as the TPU does for an f32 model: the
  sampled channels equal; losses rtol 1e-5 at step 0 and 1e-4 after (the
  f32 train test's bounds, tests/test_torch_training.py); every gradient
  within 1e-4 of max|g| of JAX's.
- TF32: ``main`` with ``++train.dtype=float32`` runs the Trainer with TF32
  off for matmuls and cuDNN and leaves both flags as it found them; a
  bf16 run leaves them alone; ``ServingEngine`` does the same around each
  forward of an f32 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diverse_channel_vit_tpu.training import create_train_state
from diverse_channel_vit_tpu.training import make_optimizer as j_make_optimizer
from diverse_channel_vit_tpu.training.steps import make_train_step as j_make_train_step
from diverse_channel_vit_torch import main as port_main
from diverse_channel_vit_torch import trainer as port_trainer
from diverse_channel_vit_torch.models import vit
from diverse_channel_vit_torch.models.channel_vit import ChannelVisionTransformer
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.models.wrappers import ChannelAdaptiveClassifier
from diverse_channel_vit_torch.ops import attention as at
from diverse_channel_vit_torch.serving import ServingEngine
from diverse_channel_vit_torch.training import TrainState, make_optimizer, make_train_step

from test_torch_sampling import TEMP, jax_draws
from test_torch_training import C, IMG, NC, OPT, _jax_lr, _jax_model, _port_lr, _port_model

RECIPE_KS = (1, 3)


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


# --- the kernels' checks on f32 views -------------------------------------


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_checks_take_f32_views_of_a_packed_qkv(dh):
    b, n, d = 2, 128, 384
    q, k, v = torch.zeros(b, n, 3 * d).split(d, dim=-1)
    assert q.stride() == (n * 3 * d, 3 * d, 1) and q.data_ptr() % 16 == 0
    assert at._flash_check(q, k, v, d // dh, 100) == (b, n, d, "_f32")
    for name, t in zip("qkv", (q, k, v)):
        assert at._row_stride(name, t, b, n, d, t.device) == 3 * d
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    assert at._flash_check(qb, kb, vb, d // dh, n)[3] == ""


def test_flash_checks_refuse_float16_head_width_192_and_odd_f32_strides():
    q, k, v = torch.zeros(1, 64, 3 * 384).split(384, dim=-1)
    with pytest.raises(NotImplementedError, match="B.5"):
        at._flash_check(q.half(), k.half(), v.half(), 6, 64)
    with pytest.raises(NotImplementedError, match="B.5"):  # q f32, k and v bf16
        at._flash_check(q, k.bfloat16(), v.bfloat16(), 6, 64)
    with pytest.raises(NotImplementedError, match="B.3"):
        at._flash_check(q, k, v, 2, 64)
    odd = torch.zeros(1, 64, 386)[..., :384]  # rows 1544 bytes apart
    with pytest.raises(NotImplementedError, match="16-byte"):
        at._row_stride("q", odd, 1, 64, 384, odd.device)
    assert at._row_stride("q", torch.zeros(1, 64, 388)[..., :384], 1, 64, 384,
                          odd.device) == 388


def _tiny(**kw):
    bb = ChannelVisionTransformer(8, 32, 8, 128, 4, 2, dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(0), **kw)
    return ChannelAdaptiveClassifier(bb, 128, 5, with_head=True).eval()


@pytest.mark.parametrize("kw", [{}, {"keep_rate": 0.7},
                                {"block_type": "block_v2",
                                 "dropout_tokens_hcs": "token_pruning",
                                 "token_keep_channels": 4}],
                         ids=["dense", "evit", "ppt"])
def test_blocks_pass_views_of_the_qkv_gemm_output(kw, monkeypatch):
    """Every f32 block hands the attention op three views of one (B, N, 3D)
    tensor, rows 3D apart, which the kernels take as they are."""
    seen = []
    real = vit.flash_attention_packed

    def spy(q, k, v, num_heads, sm_scale=None, valid_len=None):
        seen.append((q, k, v, num_heads))
        return real(q, k, v, num_heads, sm_scale, valid_len)

    monkeypatch.setattr(vit, "flash_attention_packed", spy)
    model = _tiny(**kw)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 8, 32, 32))
                         .astype(np.float32))
    with torch.no_grad():
        model(x, torch.arange(8))
    assert len(seen) == (4 if kw else 3)  # the dense model's last block is the readout
    for q, k, v, heads in seen:
        b, n, d = q.shape
        base = q.untyped_storage().data_ptr()
        assert q.dtype == torch.float32
        assert k.untyped_storage().data_ptr() == v.untyped_storage().data_ptr() == base
        assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == (4 * d, 8 * d)
        for name, t in zip("qkv", (q, k, v)):
            assert at._row_stride(name, t, b, n, d, t.device) == 3 * d
        if n % at.PAD_MULTIPLE == 0:  # PPT's unpadded grids are padded by the op
            assert at._flash_check(q, k, v, heads, n)[3] == "_f32"


# --- the DCS recipe's f32 steps at k = 1 and 3 against JAX's Pallas route ----


@pytest.fixture(scope="module")
def recipe_start():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(2, C, IMG, IMG)).astype(np.float32) for _ in RECIPE_KS]
    ys = [rng.integers(0, NC, size=2) for _ in RECIPE_KS]
    jmodel = _jax_model(jnp.float32, attention_impl="pallas")
    params = jax.jit(lambda x: jmodel.init({"params": jax.random.key(0)}, x, jnp.arange(C),
                                           train=False)["params"])(jnp.asarray(xs[0]))
    return xs, ys, jmodel, params


def test_recipe_f32_steps_at_k1_and_k3_match_jax_pallas_route(recipe_start, monkeypatch):
    xs, ys, jmodel, params = recipe_start
    jax_grads = []
    real_norm = optax.global_norm

    def spy(tree):
        jax.debug.callback(lambda t: jax_grads.append(jax.device_get(t)), tree)
        return real_norm(tree)

    monkeypatch.setattr(optax, "global_norm", spy)
    jtx = j_make_optimizer("adamw", dict(OPT), lr_schedule=_jax_lr(), total_steps=2)
    jstate = create_train_state(jmodel, jtx, rng=jax.random.key(1), sample_input=None,
                                sample_channel_ids=None, params=params)
    model = _port_model(torch.float32, params_from_jax(params))
    state = TrainState(model, make_optimizer("adamw", dict(OPT), lr_schedule=_port_lr(),
                                             total_steps=2))
    got, want = [], []
    for t, k in enumerate(RECIPE_KS):
        jstep = j_make_train_step(jmodel, channel_ids=range(C), k=k,
                                  hcs_method="lowest_cosine_prob", hcs_temp=TEMP,
                                  loss_type="ce", extra_loss_lambda=1.0, donate=False)
        step = make_train_step(model, channel_ids=range(C), k=k,
                               hcs_method="lowest_cosine_prob", hcs_temp=TEMP, loss_type="ce",
                               extra_loss_lambda=1.0)
        key = jax.random.key(20 + t)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(xs[t]), "label": jnp.asarray(ys[t])},
                           key)
        draws = jax_draws(jax.random.split(key, 3)[0], C, "lowest_cosine_prob")
        state, m = step(state, {"image": torch.from_numpy(xs[t]),
                                "label": torch.from_numpy(ys[t])}, draws=draws)
        np.testing.assert_array_equal(m["sampled_channels"].numpy(),
                                      np.asarray(jm["sampled_channels"]))
        assert len(m["sampled_channels"]) == k
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
        jax.effects_barrier()
        ref = params_from_jax(jax_grads[-1])
        for name, prm in model.named_parameters():
            scale = np.abs(ref[name].numpy()).max()
            err = np.abs(prm.grad.numpy() - ref[name].numpy()).max()
            assert err <= 1e-4 * scale or err <= 1e-12, (k, name, err, scale)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


# --- TF32 -----------------------------------------------------------------

TINY_MAIN = ["train.num_epochs=1", "train.batch_size=16", "++dataset.num_train_samples=32",
             "++dataset.num_eval_samples=16", "hardware.num_workers=0", "hardware.mesh.data=1",
             "++hardware.device=cpu", "++eval.skip_eval_first_epoch=True"]


@pytest.mark.parametrize("dtype,inside", [("float32", (False, False)),
                                          ("bfloat16", (True, True))])
def test_main_turns_tf32_off_for_an_f32_run_and_restores_it(dtype, inside, tmp_path,
                                                            monkeypatch):
    seen = []
    real_train = port_trainer.Trainer.train

    def train(trainer):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     trainer.dtype))
        return real_train(trainer)

    monkeypatch.setattr(port_trainer.Trainer, "train", train)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        best = port_main.main(["-cn", "synthetic_cfg", *TINY_MAIN, f"++train.dtype={dtype}",
                               f"train.checkpoints={tmp_path}"])
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert np.isfinite(best)
    assert seen == [(*inside, getattr(torch, dtype))]
    assert after == (True, True)


def test_serving_an_f32_model_turns_tf32_off_around_each_forward():
    model = _tiny()
    seen = []
    model.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    engine = ServingEngine(model, buckets=(1, 2), device="cpu")
    assert engine.full_f32
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        out = engine.predict(np.zeros((3, 8, 32, 32), np.float32), list(range(8)))
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert out.shape == (3, 5) and np.isfinite(out).all()
    assert seen == [(False, False)] * 2 and after == (True, True)

"""The port's preemption runtime, RSS recycling, profiler trace and
attention maps (``diverse_channel_vit_torch/trainer.py``,
``training/preemption.py``), on the CPU.

- ``PreemptionGuard``: the port's and the JAX package's (its module loaded
  by path: it imports only ``signal`` and ``threading``) catch a real
  SIGTERM, chain to a previous handler and restore it, alike.
- A SIGTERM in the middle of epoch 2 (after the 5th of 9 steps) of a run
  that draws from every random source the checkpoint must carry: DCS (the
  host generator's k draws and the device generator's channels), DropPath
  (masks from the device generator), SWAD (the running average, from epoch
  2) and MIRO (the pre-featurizer, remade from the seeded init). The
  Trainer saves ``model_preempt``; the next Trainer of the same (dataset,
  seed) re-enters epoch 2 at batch 2 and finishes. Its final weights, the
  epoch-3 train metrics and the last eval equal the uninterrupted run's
  bit for bit (the CPU's kernels are deterministic at a fixed thread
  count); the preempt directory is gone after the clean finish, and the
  SIGTERM handler is the one before the run. These are the JAX package's
  ``tests/test_preemption.py`` cases, held to the uninterrupted port run.
- ``train.max_host_rss_gb`` below any RSS recycles the process at every
  epoch boundary, ``_reexec`` stubbed as JAX's test does: three launches
  finish with the uninterrupted run's weights; without auto_resume it
  never recycles.
- ``train.profile_dir`` writes a Chrome trace of the run.
- ``train.plot_attn`` writes ``cls_attn_epoch{e}.npy``: the last block's CLS
  attention over the valid tokens for 8 eval images, equal within 1e-5 of
  the JAX package's ``attention_maps`` on the same weights (f32, dense
  softmax on both sides), and the figure where matplotlib imports.

f32, the XLA route, the ``test`` preset at 32², 48 images in batches of 16
(3 steps an epoch), 3 epochs; torch on two threads.
"""

import importlib.util
import json
import os
import signal

import numpy as np
import pytest
import torch

from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.trainer import Trainer
from diverse_channel_vit_torch.training import preemption as port_preemption

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNTIME = ["++model.enable_sample=True", "++model.hcs_sampling=lowest_cosine_prob",
           "++model.drop_path_rate=0.2", "++train.swad=True", "++train.swa_start=1",
           "++train.miro=True"]


def _jax_guard_module():
    spec = importlib.util.spec_from_file_location(
        "jax_package_preemption",
        os.path.join(ROOT, "diverse_channel_vit_tpu", "training", "preemption.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GUARDS = {"port": port_preemption.PreemptionGuard,
          "jax": _jax_guard_module().PreemptionGuard}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cfg(root, extra=()):
    return load_config("synthetic_cfg", [
        "train.num_epochs=3", "scheduler=none", "train.batch_size=16",
        "++dataset.num_train_samples=48", "++dataset.num_eval_samples=32",
        f"train.checkpoints={root}/ckpt", "hardware.num_workers=0", "model.attention_impl=xla",
        "train.dtype=float32", "++eval.skip_eval_first_epoch=True",
        "++eval.only_eval_first_and_last=True", *extra])


def _trainer(root, extra=()):
    return Trainer(_cfg(root, extra), device="cpu")


class Recorder:
    """Each Trainer's epoch metrics and evals, by wrapping the class's
    methods for the length of a test."""

    def __init__(self, monkeypatch):
        self.epochs, self.evals = {}, {}
        epoch, evaluate = Trainer.train_one_epoch, Trainer.evaluate_model

        def train_one_epoch(trainer, e, start_batch=0):
            out = epoch(trainer, e, start_batch=start_batch)
            self.epochs.setdefault(id(trainer), {})[e] = {
                k: v for k, v in out.items() if k != "imgs_per_sec_per_chip"}
            return out

        def evaluate_model(trainer, e):
            out = evaluate(trainer, e)
            self.evals.setdefault(id(trainer), {})[e] = out
            return out

        monkeypatch.setattr(Trainer, "train_one_epoch", train_one_epoch)
        monkeypatch.setattr(Trainer, "evaluate_model", evaluate_model)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The reference run: 3 epochs of 3 steps, no interruption."""
    with pytest.MonkeyPatch.context() as mp:
        rec = Recorder(mp)
        t = _trainer(tmp_path_factory.mktemp("uninterrupted"), RUNTIME)
        t.train()
    return t, rec.epochs[id(t)], rec.evals[id(t)]


def _same_weights(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ----------------------------------------------------------------------- guard


@pytest.mark.parametrize("side", sorted(GUARDS))
def test_guard_catches_sigterm_and_restores(side):
    before = signal.getsignal(signal.SIGTERM)
    guard = GUARDS[side]()
    with guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)  # would end the process if unhandled
        assert guard.triggered
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("side", sorted(GUARDS))
def test_guard_chains_previous_handler(side):
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with GUARDS[side]() as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.triggered
            assert seen == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM).__name__ == "<lambda>"
    finally:
        signal.signal(signal.SIGTERM, prev)


# -------------------------------------------------------------- preemption


def test_sigterm_mid_epoch_then_auto_resume_is_bit_exact(uninterrupted, tmp_path, monkeypatch):
    ta, want_epochs, want_evals = uninterrupted
    rec = Recorder(monkeypatch)
    handler = signal.getsignal(signal.SIGTERM)
    tb = _trainer(tmp_path, RUNTIME)
    run = Trainer._train_one_batch_regular
    calls = {"n": 0}

    def batch_then_sigterm(self, batch):
        out = run(self, batch)
        calls["n"] += 1
        if calls["n"] == 5:  # epoch 2, batch 1: batch 2 of epoch 2 never runs
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(Trainer, "_train_one_batch_regular", batch_then_sigterm)
    tb.train()
    monkeypatch.setattr(Trainer, "_train_one_batch_regular", run)
    assert tb.state.step == 5 and signal.getsignal(signal.SIGTERM) is handler
    with open(os.path.join(tb.preempt_dir, "model_preempt.meta.json")) as f:
        meta = json.load(f)
    # the sidecar JAX's _save_preempt writes (trainer.py:955-961)
    assert {"resume_epoch", "resume_batch", "host_rng_state", "channel_counter",
            "swa_n"} <= set(meta)
    assert (meta["epoch"], meta["resume_epoch"], meta["resume_batch"]) == (1, 2, 2)

    tb2 = _trainer(tmp_path, RUNTIME)
    assert (tb2.start_epoch, tb2._resume_start_batch, tb2.state.step) == (2, 2, 5)
    assert tb2.host_rng.bit_generator.state == tb.host_rng.bit_generator.state
    assert torch.equal(tb2.generator.get_state(), tb.generator.get_state())
    assert tb2.swa_n == tb.swa_n == 2 and tb2.channel_counter == tb.channel_counter
    tb2.train()
    assert tb2.state.step == ta.state.step == 9
    _same_weights(tb2, ta)
    assert rec.epochs[id(tb2)][3] == want_epochs[3]
    assert rec.evals[id(tb2)][3] == want_evals[3]
    assert tb2.channel_counter == ta.channel_counter and tb2.swa_n == ta.swa_n == 6
    assert not os.path.isdir(tb2.preempt_dir)  # removed on the clean finish
    assert _trainer(tmp_path, RUNTIME).start_epoch == 1  # nothing shadows a fresh launch


def test_preempt_at_epoch_boundary_then_auto_resume(uninterrupted, tmp_path, monkeypatch):
    ta, *_ = uninterrupted
    tb = _trainer(tmp_path, RUNTIME)
    epoch = Trainer.train_one_epoch

    def epoch_then_sigterm(self, e, start_batch=0):
        out = epoch(self, e, start_batch=start_batch)
        if e == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(Trainer, "train_one_epoch", epoch_then_sigterm)
    tb.train()
    monkeypatch.setattr(Trainer, "train_one_epoch", epoch)
    tb2 = _trainer(tmp_path, RUNTIME)
    assert (tb2.start_epoch, tb2._resume_start_batch, tb2.state.step) == (2, 0, 3)
    tb2.train()
    _same_weights(tb2, ta)


def test_resume_mid_epoch_opt_out_reruns_the_epoch(tmp_path, monkeypatch):
    """``++train.resume_mid_epoch=False``: the partial epoch counts as not
    done and runs again from its first batch; the steps taken stay."""
    t1 = _trainer(tmp_path)
    run = Trainer._train_one_batch_regular

    def batch_then_trigger(self, batch):
        out = run(self, batch)
        self._preempt_guard.trigger()
        return out

    monkeypatch.setattr(Trainer, "_train_one_batch_regular", batch_then_trigger)
    t1.train()
    monkeypatch.setattr(Trainer, "_train_one_batch_regular", run)
    t2 = _trainer(tmp_path, ["++train.resume_mid_epoch=False"])
    assert (t2.start_epoch, t2._resume_start_batch) == (1, 0)
    assert t2.state.step == t1.state.step == 1


def test_auto_resume_opt_out(tmp_path):
    t1 = _trainer(tmp_path)
    t1._save_preempt(2)
    assert os.path.exists(os.path.join(t1.preempt_dir, "model_preempt"))
    assert _trainer(tmp_path, ["++train.auto_resume=False"]).start_epoch == 1
    assert _trainer(tmp_path).start_epoch == 3


# -------------------------------------------------------------- RSS recycling


def test_rss_watermark_recycling(uninterrupted, tmp_path, monkeypatch):
    """A cap below any RSS recycles at each epoch boundary but the last:
    launch 1 runs epoch 1, launch 2 epoch 2, launch 3 epoch 3; together they
    give the uninterrupted run's weights and epoch metrics bit for bit."""
    ta, want_epochs, _ = uninterrupted
    rec = Recorder(monkeypatch)
    recycled = []
    monkeypatch.setattr(Trainer, "_reexec", lambda self: recycled.append(self.start_epoch))
    cap = RUNTIME + ["++train.max_host_rss_gb=1e-9"]
    runs = []
    for want_start in (1, 2, 3):
        t = _trainer(tmp_path, cap)
        assert t.start_epoch == want_start
        t.train()
        runs.append(t)
    assert recycled == [1, 2]
    _same_weights(runs[-1], ta)
    got = {e: m for t in runs for e, m in rec.epochs[id(t)].items()}
    assert got == want_epochs


def test_rss_recycling_respects_auto_resume_opt_out(tmp_path, monkeypatch):
    called = []
    monkeypatch.setattr(Trainer, "_reexec", lambda self: called.append(True))
    t = _trainer(tmp_path, ["++train.max_host_rss_gb=1e-9", "++train.auto_resume=False",
                            "train.num_epochs=2"])
    t.train()
    assert called == [] and t.state.step == 6


# ------------------------------------------------------- profiler and figures


def test_profile_dir_writes_a_trace(tmp_path):
    out = tmp_path / "trace"
    t = _trainer(tmp_path, [f"++train.profile_dir={out}", "train.num_epochs=1"])
    t.train()
    (path,) = list(out.iterdir())
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("linear" in str(e.get("name", "")) for e in events)


def test_plot_attn_writes_the_npy_equal_to_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from diverse_channel_vit_tpu.config import load_config as jload_config
    from diverse_channel_vit_tpu.models import build_model as jbuild_model
    from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint
    from diverse_channel_vit_tpu.models.vit import attention_maps

    t = _trainer(tmp_path, ["++train.plot_attn=True", "train.num_epochs=1"])
    t.train()  # evaluates after its only epoch
    attn = tmp_path / "ckpt" / "synthetic"
    (run_dir,) = [p for p in attn.iterdir() if not p.name.startswith("preempt")]
    got = np.load(run_dir / "attn" / "cls_attn_epoch1.npy")
    assert got.shape == (8, 2, 8 * 16)
    try:
        import matplotlib  # noqa: F401
        figure = True
    except ImportError:
        figure = False
    assert (run_dir / "attn" / "cls_attn_epoch1.png").exists() == figure
    jcfg = jload_config("synthetic_cfg", ["model.attention_impl=xla"])
    jcfg.model.in_channel_names = jcfg.dataset.in_channel_names
    jmodel = jbuild_model(jcfg.model.name, jcfg.model, t.mapper, t.num_classes,
                          dtype=jnp.float32)
    params = load_reference_checkpoint(
        {k: v.detach().numpy().copy() for k, v in t.model.state_dict().items()})[0]
    batch = next(iter(t.val_loader))
    probs = np.asarray(jax.jit(lambda p, x: attention_maps(jmodel, p, x, jnp.arange(8)))(
        params, jnp.asarray(batch["image"][:8])))
    np.testing.assert_allclose(got, probs[:, :, 0, 1:1 + 8 * 16], rtol=0, atol=1e-5)

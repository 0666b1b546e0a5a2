"""The port's stereo-separator training against the JAX package's.

Small sizes throughout (base_channels 4, H 8, B 2, T 2048), weights drawn
by the JAX package's `init` and carried over with `state_dict_from_jax`,
broadband batches (tones under white noise) drawn with numpy. Bars:
- train forward and BN running statistics: 1e-4 (the models' bar);
- loss: 1e-5 relative;
- gradients of the smooth loss terms (time MSE, temporal consistency):
  1e-5 of the largest gradient entry, the same f32 arithmetic summed in
  another order;
- gradients of the reference loss: 5e-2 relative L2 over all parameters.
  Its log-magnitude spectral and clustering terms weigh each STFT bin by
  1/(|S| + 1e-5), so the f32 rounding of the smallest bins, which no two
  FFTs share, moves the gradient: at this size 3e-3 to 2e-2 between the two
  packages, and as much between two float orders inside one of them;
- one Adam step with clipping and EMA: 1e-2 lr on the updated weights.
  Adam's first step moves a weight by about lr times the sign of its
  gradient, and by a rounding-dependent fraction of lr where the clipped
  gradient is near Adam's eps. The conv biases that feed a train-mode BN
  are held to 2 lr: their true gradient is zero (the batch mean cancels
  them), so both sides hand Adam pure rounding noise.
The CUDA kernels run only on a card: tests/test_torch_cuda.py and
chip_smoke.py drive this path there.
"""
import os
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.config import TrainConfig as JTrainConfig
from ml_audio_restoration_tpu.config import load_config as jload_config
from ml_audio_restoration_tpu.data.datasets import \
    StereoDataset as JStereoDataset
from ml_audio_restoration_tpu.data.loader import DataLoader as JDataLoader
from ml_audio_restoration_tpu.data.loader import \
    train_val_split as jtrain_val_split
from ml_audio_restoration_tpu.models import stereo_separator as jstereo
from ml_audio_restoration_tpu.ops.conv import \
    batch_norm_train as jbatch_norm_train
from ml_audio_restoration_tpu.train.trainer import Trainer as JTrainer
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.audio import save_audio
from ml_audio_restoration_torch.compat import state_dict_from_jax
from ml_audio_restoration_torch.config import TrainConfig, load_config
from ml_audio_restoration_torch.data import (
    DataLoader, StereoDataset, train_val_split)
from ml_audio_restoration_torch.models import StereoSeparator
from ml_audio_restoration_torch.ops import batch_norm_train
from ml_audio_restoration_torch.ops import lstm as L
from ml_audio_restoration_torch.train import checkpoints as ckpt
from ml_audio_restoration_torch.train.trainer import (
    Trainer, render_test_outputs, train_from_config)

C, H, B, T = 4, 8, 2, 2048
SR = 22050
FWD_BAR = 1e-4
GRAD_BAR = 1e-5


def _jax_weights(seed=1):
    return jstereo.init(jax.random.PRNGKey(seed), base_channels=C,
                        lstm_hidden=H)


def _port_model(params, state):
    m = StereoSeparator(base_channels=C, lstm_hidden=H)
    m.load_state_dict(state_dict_from_jax("stereo_separator", params, state))
    return m


def _stereo(i, n=T):
    t = np.arange(n) / SR
    rng = np.random.default_rng(100 + i)
    left = 0.3 * np.sin(2 * np.pi * (220 + 17 * i) * t)
    right = 0.2 * np.sin(2 * np.pi * (330 + 11 * i) * t + 0.5)
    x = np.stack([left, right]) + 0.3 * rng.standard_normal((2, n))
    return x.astype(np.float32)


class ToyStereo:
    pairing = "mono_target_stereo"

    def __init__(self, n=4):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"stereo": _stereo(i)}


def _batch(n=B):
    return {"stereo": np.stack([_stereo(i) for i in range(n)])}


def _cfg(cls, **kw):
    base = dict(model="stereo_separator", learning_rate=1e-3, num_epochs=2)
    base.update(kw)
    return cls(**base)


def _trainer(tmp_path=None, params_state=None, **cfg_kw):
    params, state = params_state or _jax_weights()
    loader = DataLoader(ToyStereo(), batch_size=B, seed=0)
    tr = Trainer("stereo_separator", _port_model(params, state), loader,
                 loader, config=_cfg(TrainConfig, **cfg_kw), device="cpu")
    if tmp_path is not None:
        tr.checkpoint_dir = tmp_path
    return tr


def _jax_trainer(params, state, **cfg_kw):
    loader = JDataLoader(ToyStereo(), batch_size=B, num_workers=1, seed=0)
    return JTrainer("stereo_separator", params, state, loader, None,
                    config=_cfg(JTrainConfig, **cfg_kw))


def _param_names(model):
    return [n for n, _ in model.named_parameters()]


# ----------------------------------------------------------- model / ops
def test_batch_norm_train_matches(rng):
    """f32 statistics as E[x^2]-E[x]^2 clamped at 0, unbiased running var
    with n = B*T, momentum 0.1, output in x's dtype -- f32 and bf16 x."""
    x = (rng.standard_normal((3, 5, 40)) * 2 + 1).astype(np.float32)
    scale, bias = rng.standard_normal(5).astype(np.float32), \
        rng.standard_normal(5).astype(np.float32)
    rm, rv = rng.standard_normal(5).astype(np.float32), \
        rng.uniform(0.5, 2, 5).astype(np.float32)
    for dtype, jdtype, bar in ((torch.float32, jnp.float32, 1e-6),
                               (torch.bfloat16, jnp.bfloat16, 1e-2)):
        tx = torch.from_numpy(x).to(dtype)
        y, m, v = batch_norm_train(tx, *(torch.from_numpy(a) for a in
                                         (scale, bias, rm, rv)))
        jy, jm, jv = jbatch_norm_train(
            jnp.asarray(tx.float().numpy().transpose(0, 2, 1)).astype(jdtype),
            *(jnp.asarray(a) for a in (scale, bias, rm, rv)))
        assert y.dtype == dtype
        np.testing.assert_allclose(y.float().numpy().transpose(0, 2, 1),
                                   np.asarray(jy, np.float32), atol=bar)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)


def test_train_forward_and_bn_state_match_jax():
    params, state = _jax_weights()
    x = _batch()["stereo"].mean(axis=1, keepdims=True)  # [B, 1, T]
    want, new_state = jstereo.apply(params, state,
                                    jnp.asarray(x.transpose(0, 2, 1)),
                                    train=True)
    m = _port_model(params, state).train()
    out = m(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=FWD_BAR)
    want_sd = state_dict_from_jax("stereo_separator", params, new_state)
    got_sd = m.state_dict()
    stats = [k for k in got_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 15
    for k in stats:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   atol=FWD_BAR, err_msg=k)
    assert all(int(got_sd[k]) == 1 for k in got_sd
               if k.endswith("num_batches_tracked"))


def test_encode_train_matches_jax():
    params, state = _jax_weights(1)
    x = _batch()["stereo"][:, :1]
    want, _ = jstereo.encode(params, state, jnp.asarray(x.transpose(0, 2, 1)),
                             train=True)
    got = _port_model(params, state).train().encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=FWD_BAR)


# ------------------------------------------------------------ loss / step
def _jax_inputs():
    stereo = jnp.asarray(_batch()["stereo"].transpose(0, 2, 1))
    return jnp.mean(stereo, axis=-1, keepdims=True), stereo


SMOOTH = {"spectral_weight": 0.0, "clustering_weight": 0.0}


def _loss_and_grads(seed, kw):
    params, state = _jax_weights(seed)
    jtr = _jax_trainer(params, state, **kw)
    inputs, targets = _jax_inputs()
    (jloss, (jparts, _, _)), jgrads = jax.value_and_grad(
        jtr._loss, has_aux=True)(params, state, inputs, targets, {},
                                 jax.random.PRNGKey(0), True)
    tr = _trainer(params_state=(params, state), **kw)
    tin, ttg = tr._derive(_batch())
    np.testing.assert_array_equal(tin.numpy(), np.asarray(inputs))
    tr.model.train()
    loss, (parts, _) = tr._loss(tin, ttg)
    loss.backward()
    assert set(parts) == set(jparts)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=GRAD_BAR)
    want = state_dict_from_jax("stereo_separator", jgrads, state)
    names = _param_names(tr.model)
    got = {n: p.grad.numpy() for n, p in tr.model.named_parameters()}
    return got, {n: want[n].numpy() for n in names}


def _assert_grads_close(seed, bar):
    got, want = _loss_and_grads(seed, SMOOTH)
    scale = max(np.abs(w).max() for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name],
                                   atol=bar * scale, err_msg=name)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_loss_and_grads_match_jax_value_and_grad(seed):
    """The smooth terms: every parameter's gradient within 1e-5 of the
    largest gradient entry of the JAX package's value_and_grad."""
    _assert_grads_close(seed, GRAD_BAR)


@pytest.mark.parametrize("seed", [0, 7])
def test_loss_and_grads_match_jax_ill_conditioned_draws(seed):
    """Weight draws 0 and 7 of 0..7: at this width their stem's gradient
    cancels inside the train-mode BN to ~1e-3 of its terms, so the two
    packages' f32 summation orders part by up to 4.5e-3 of the largest
    gradient entry (1.1e-4 for draw 7); held to 1e-2."""
    _assert_grads_close(seed, 1e-2)


def test_reference_loss_grads_match_jax():
    """The reference weights: the loss at 1e-5, the whole gradient at 5e-2
    relative L2 (see the module docstring for why no tighter)."""
    got, want = _loss_and_grads(1, {})
    g = np.concatenate([got[n].ravel() for n in want])
    w = np.concatenate([want[n].ravel() for n in want])
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 5e-2


def _zero_grad_biases(model):
    """Conv biases that feed a train-mode BN (all but the decoders' final
    convs): their true gradient is zero."""
    return {n for n in _param_names(model)
            if n.endswith(".bias") and n.replace(".bias", ".weight") in
            dict(model.named_parameters())
            and model.get_submodule(n.rsplit(".", 1)[0]).__class__.__name__
            == "Conv1d" and not n.endswith("decoder.9.bias")}


def test_one_step_with_clipping_and_ema_matches_jax():
    lr = 1e-3
    kw = dict(learning_rate=lr, max_grad_norm=0.05, ema_decay=0.9,
              **SMOOTH)
    params, state = _jax_weights()
    jtr = _jax_trainer(params, state, **kw)
    new_state, jmetrics = jtr._train_step(
        jtr.state, {"stereo": jnp.asarray(_batch()["stereo"])},
        jax.random.PRNGKey(1))
    tr = _trainer(**kw)
    metrics = tr._train_step(_batch())
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=GRAD_BAR)
    for k in ("correlation", "width"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=FWD_BAR)
    # the clip was active: the global norm is well above 0.05
    norm = np.sqrt(sum(float((p.grad ** 2).sum())
                       for p in tr.model.parameters()))
    np.testing.assert_allclose(norm, 0.05, rtol=1e-5)

    want = state_dict_from_jax("stereo_separator", new_state["params"],
                               new_state["model_state"])
    want_ema = state_dict_from_jax("stereo_separator",
                                   new_state["ema_params"],
                                   new_state["model_state"])
    loose = _zero_grad_biases(tr.model)
    assert len(loose) == 15
    got = tr.model.state_dict()
    for name in got:
        if name.endswith("num_batches_tracked"):
            continue
        bar = 2 * lr if name in loose else 1e-2 * lr
        if name.endswith(("running_mean", "running_var")):
            bar = FWD_BAR
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=bar, err_msg=name)
        if name in tr.ema_params:
            np.testing.assert_allclose(
                tr.ema_params[name].numpy(), want_ema[name].numpy(),
                atol=(1 - 0.9) * bar, err_msg=f"ema {name}")


def test_routes_train_step_through_train_recurrence(monkeypatch):
    """A train step runs the training recurrence (K2/K3's plain versions
    on the CPU); validation and rendering run the inference route."""
    calls = []
    for name in ("lstm_recurrence_plain", "lstm_recurrence_train_plain",
                 "lstm_recurrence_bwd_plain"):
        real = getattr(L, name)
        monkeypatch.setattr(
            L, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    tr = _trainer(ema_decay=0.5)
    tr._train_step(_batch())
    assert calls == ["lstm_recurrence_train_plain",
                     "lstm_recurrence_bwd_plain"]
    calls.clear()
    tr.validate()
    tr._render(_batch())
    assert calls == ["lstm_recurrence_plain"] * 3
    assert tr.model.training is False


def test_trainer_selects_repeatable_full_f32_convolutions():
    torch.backends.cudnn.deterministic = False
    _trainer()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_eval_step_uses_ema_weights():
    tr = _trainer(ema_decay=0.99)
    tr._train_step(_batch())
    ema_loss = float(tr._eval_step(_batch())["loss"])
    tr.ema_params = None
    live_loss = float(tr._eval_step(_batch())["loss"])
    assert ema_loss != live_loss
    m = _trainer().eval_model()
    assert m.training is False


def test_fixed_batch_loss_falls():
    tr = _trainer(learning_rate=3e-3)
    losses = [float(tr._train_step(_batch())["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_epoch_counts_steps():
    tr = _trainer()
    loss = tr.train_epoch()
    assert np.isfinite(loss) and tr.global_step == 2


# -------------------------------------------------------------- schedule
def test_plateau_scheduler_halves_lr():
    tr = _trainer(learning_rate=1e-3)
    tr.best_val_loss = 1.0
    for _ in range(tr.cfg.plateau_patience + 1):
        tr._plateau_step(2.0)
    assert abs(tr.lr - 5e-4) < 1e-12
    assert all(abs(g["lr"] - 5e-4) < 1e-12
               for g in tr.optimizer.param_groups)


def test_plateau_improvement_resets_wait():
    tr = _trainer()
    tr.best_val_loss = 1.0
    tr._plateau_step(2.0)
    assert tr._plateau_wait == 1
    tr._plateau_step(0.5)
    assert tr._plateau_wait == 0 and tr.lr == 1e-3


# ----------------------------------------------------------- checkpoints
def test_checkpoint_save_resume_roundtrip(tmp_path):
    tr = _trainer(tmp_path, ema_decay=0.9)
    tr.train_epoch()
    tr.epoch = 3
    tr.best_val_loss = 0.123
    tr.history["train_loss"] = [1.0, 0.5, 0.3]
    tr.save_checkpoint("checkpoint_epoch_3.pth")

    tr2 = _trainer(tmp_path, params_state=_jax_weights(5), ema_decay=0.9)
    assert tr2.maybe_resume()
    assert (tr2.epoch, tr2.global_step) == (3, 2)
    assert abs(tr2.best_val_loss - 0.123) < 1e-9
    assert tr2.history["train_loss"] == [1.0, 0.5, 0.3]
    for (k, a), b in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in tr.ema_params.items():
        assert torch.equal(v, tr2.ema_params[k]), k
    s1, s2 = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    for i, st in s1["state"].items():
        for k, v in st.items():
            assert torch.equal(v, s2["state"][i][k]), (i, k)
    # the port's restore loads the checkpoint as an upstream .pth
    from ml_audio_restoration_torch.pipeline.restore import load_stage

    m = load_stage(tmp_path / "checkpoint_epoch_3.pth", "stereo_separator")
    assert torch.equal(m.lstm.weight_hh_l0, tr.model.lstm.weight_hh_l0)
    # training continues from the restored state
    assert np.isfinite(tr2.train_epoch())


def test_checkpoint_payload_keys(tmp_path):
    tr = _trainer(tmp_path, ema_decay=0.5)
    tr.save_checkpoint("best_model.pth")
    payload = ckpt.load_checkpoint(tmp_path / "best_model.pth")
    assert set(payload) == {
        "model_state_dict", "opt_state", "epoch", "global_step",
        "best_val_loss", "lr", "history", "model_name", "plateau_wait",
        "ema_params"}
    assert payload["model_name"] == "stereo_separator"


def test_checkpoint_retention(tmp_path):
    tr = _trainer(tmp_path)
    tr.save_checkpoint("checkpoint_epoch_1.pth")
    tr.save_checkpoint("best_model.pth")
    tr.save_checkpoint("checkpoint_epoch_2.pth")
    names = sorted(p.name for p in tmp_path.glob("*.pth"))
    assert names == ["best_model.pth", "checkpoint_epoch_2.pth"]
    assert [p.name for p in ckpt.all_checkpoints(tmp_path)] == [
        "checkpoint_epoch_2.pth", "best_model.pth"]
    assert ckpt.latest_checkpoint(tmp_path).name == "checkpoint_epoch_2.pth"
    assert ckpt.all_checkpoints(tmp_path / "missing") == []


def test_resume_falls_back_past_corrupt_checkpoint(tmp_path):
    tr = _trainer(tmp_path)
    tr.epoch = 1
    tr.save_checkpoint("best_model.pth")
    tr.epoch = 2
    tr.save_checkpoint("checkpoint_epoch_2.pth")
    p2 = tmp_path / "checkpoint_epoch_2.pth"
    p2.write_bytes(p2.read_bytes()[: p2.stat().st_size // 2])

    tr2 = _trainer(tmp_path)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tr2.maybe_resume()
    assert any("unreadable checkpoint" in str(x.message) for x in w)
    assert tr2.epoch == 1


def test_rejected_checkpoint_leaves_trainer_untouched(tmp_path):
    tr = _trainer(tmp_path, params_state=_jax_weights(3))
    tr.epoch = 7
    tr.save_checkpoint("best_model.pth")
    path = tmp_path / "best_model.pth"
    payload = ckpt.load_checkpoint(path)
    del payload["history"]
    ckpt.save_checkpoint(path, payload)

    tr2 = _trainer(tmp_path)
    before = tr2.model.lstm.weight_hh_l0.detach().clone()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert not tr2.maybe_resume()
    assert any("unreadable checkpoint" in str(x.message) for x in w)
    assert tr2.epoch == 0
    assert torch.equal(before, tr2.model.lstm.weight_hh_l0)


def test_checkpoint_rejects_wrong_model_family(tmp_path):
    tr = _trainer(tmp_path, params_state=_jax_weights(3))
    tr.save_checkpoint("checkpoint_epoch_1.pth")
    path = tmp_path / "checkpoint_epoch_1.pth"
    payload = ckpt.load_checkpoint(path)
    payload["model_name"] = "denoiser"
    ckpt.save_checkpoint(path, payload)

    tr2 = _trainer(tmp_path)
    before = tr2.model.lstm.weight_hh_l0.detach().clone()
    with pytest.raises(ValueError, match="is for model"):
        tr2.load_checkpoint("checkpoint_epoch_1.pth")
    assert tr2.epoch == 0
    assert torch.equal(before, tr2.model.lstm.weight_hh_l0)


def test_plateau_wait_survives_resume(tmp_path):
    tr = _trainer(tmp_path)
    tr.best_val_loss = 1.0
    for _ in range(2):
        tr._plateau_step(2.0)
    tr.save_checkpoint("checkpoint_epoch_1.pth")
    tr2 = _trainer(tmp_path)
    assert tr2.maybe_resume()
    assert tr2._plateau_wait == 2


def test_resume_without_ema_seeds_average(tmp_path):
    tr = _trainer(tmp_path)
    tr.save_checkpoint("checkpoint_epoch_1.pth")
    tr2 = _trainer(tmp_path, params_state=_jax_weights(4), ema_decay=0.9)
    assert tr2.maybe_resume()
    for name, p in tr.model.named_parameters():
        assert torch.equal(tr2.ema_params[name], p.detach()), name


def test_async_checkpoint_failure_surfaces_and_retention_waits(tmp_path):
    tr = _trainer(tmp_path)
    tr.epoch = 1
    tr.save_checkpoint("checkpoint_epoch_1.pth")
    tr.epoch = 2
    tr.save_checkpoint("checkpoint_epoch_2.pth", async_=True)
    tr._async_ckpt.wait()
    names = [p.name for p in ckpt.all_checkpoints(tmp_path)]
    assert "checkpoint_epoch_2.pth" in names
    assert "checkpoint_epoch_1.pth" not in names

    ac = ckpt.AsyncCheckpointer()
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    ac.save(blocker / "x" / "ckpt.pth", {"a": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ac.wait()
    ac.wait()


def test_retention_failure_warns_not_fails(tmp_path):
    ac = ckpt.AsyncCheckpointer()

    def bad():
        raise OSError("disk gone")

    # record from before the save: the worker may warn before wait() is
    # reached
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ac.save(tmp_path / "c.pth", {"a": torch.zeros(2)}, on_done=bad)
        ac.wait()
    assert any("retention failed" in str(x.message) for x in w)
    assert (tmp_path / "c.pth").exists()


def test_async_snapshot_taken_before_next_step(tmp_path):
    """The device-to-host copy happens at save(), so a step after it does
    not leak into the checkpoint being written."""
    tr = _trainer(tmp_path)
    want = tr.model.lstm.weight_hh_l0.detach().clone()
    tr.save_checkpoint("checkpoint_epoch_1.pth", async_=True)
    tr._train_step(_batch())
    tr._async_ckpt.wait()
    got = ckpt.load_checkpoint(tmp_path / "checkpoint_epoch_1.pth")
    assert torch.equal(got["model_state_dict"]["lstm.weight_hh_l0"], want)


# ------------------------------------------------------------------ data
def _write_corpus(root, n=6, frames=3000, rate=SR):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    for i in range(n):
        ch = 1 if i == 2 else 2
        length = 1000 if i == 3 else frames
        save_audio(root / f"f{i}.wav",
                   (rng.standard_normal((ch, length)) * 0.1).astype(
                       np.float32), rate, subtype="FLOAT")
    return root


def test_loader_batches_equal_jax_loader(tmp_path):
    """From one seed the port's StereoDataset + DataLoader yield the JAX
    package's batches exactly (same seeded numpy generators and order),
    including a mono file duplicated to stereo and a short file padded."""
    root = _write_corpus(tmp_path / "wavs")
    ds, jds = (cls(root, SR, chunk_duration=0.1, seed=3)
               for cls in (StereoDataset, JStereoDataset))
    assert [p.name for p in ds.files] == [p.name for p in jds.files]
    tr, va = train_val_split(ds, 0.2, seed=5)
    jtr, jva = jtrain_val_split(jds, 0.2, seed=5)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    for epoch in range(2):
        got = list(DataLoader(ds, 2, indices=tr, seed=11))
        want = list(JDataLoader(jds, 2, indices=jtr, seed=11,
                                num_workers=1))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["stereo"].shape == (2, 2, int(SR * 0.1))
            np.testing.assert_array_equal(g["stereo"], w["stereo"])


def test_native_rate_quirk_matches_jax(tmp_path):
    """A long file at another rate: the seek path keeps the native rate
    (with a warning) unless resample_chunks, as in the JAX package."""
    root = _write_corpus(tmp_path / "wavs", n=2, frames=8000, rate=44100)
    for resample in (False, True):
        ds = StereoDataset(root, SR, 0.1, seed=1, resample_chunks=resample)
        jds = JStereoDataset(root, SR, 0.1, seed=1,
                             resample_chunks=resample)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got = ds[0]["stereo"]
        assert any("native rate" in str(x.message) for x in w) != resample
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jds[0]["stereo"]
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_flac_in_corpus_raises(tmp_path):
    """(Named for the refusal it pinned before FLAC was ported.) A FLAC
    corpus is read: the same audio as 16-bit WAVs and as 16-bit FLACs (a
    mono file, a short one, stereo ones) gives StereoDataset the same
    items bit for bit, and the JAX package's StereoDataset reads the FLACs
    to the same items."""
    rng = np.random.default_rng(7)
    for i, (ch, length) in enumerate([(2, 3000), (1, 3000), (2, 1000)]):
        x = (rng.standard_normal((ch, length)) * 0.1).astype(np.float32)
        for ext in ("wav", "flac"):
            save_audio(tmp_path / ext / f"f{i}.{ext}", x, SR)
    wav, flac = (StereoDataset(tmp_path / ext, SR, 0.1, seed=1)
                 for ext in ("wav", "flac"))
    jflac = JStereoDataset(tmp_path / "flac", SR, 0.1, seed=1)
    assert [p.suffix for p in flac.files] == [".flac"] * 3
    for _ in range(2):  # two epochs of draws
        for i in range(3):
            got = flac[i]["stereo"]
            np.testing.assert_array_equal(got, wav[i]["stereo"])
            np.testing.assert_array_equal(got, jflac[i]["stereo"])
            assert got.shape == (2, int(SR * 0.1))


def test_abandoned_loader_iterator_releases_worker():
    before = threading.active_count()
    for _ in range(3):
        it = iter(DataLoader(ToyStereo(n=64), 2, prefetch=1,
                             shuffle=False))
        next(it)
        del it
    import gc

    gc.collect()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_config_matches_jax(tmp_path):
    import dataclasses

    import yaml

    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({
        "train": {"model": "stereo_separator", "batch_size": 16,
                  "max_grad_norm": 1.0, "lstm_impl": "pallas_train"},
        "data": {"chunk_duration": 1.5,
                 "artifacts": {"rolloff_freq": [5000.0, 7000.0]}}}))
    got = dataclasses.asdict(load_config(path))
    want = dataclasses.asdict(jload_config(path))
    assert got == want
    with pytest.raises(KeyError):
        load_config(overrides={"train": {"nope": 1}})


# ------------------------------------------------------- unported options
# data_parallel > 1 trains with one process a device; in one process it
# is refused (tests/test_torch_multiprocess.py holds the multi-process runs)
@pytest.mark.parametrize("kw,match", [
    ({"data_parallel": 2}, "--num-processes"),
])
def test_unported_options_raise(kw, match):
    pairing = kw.pop("pairing", None)
    params, state = _jax_weights()
    loader = DataLoader(ToyStereo(), batch_size=B, seed=0)
    with pytest.raises(ValueError, match=match):
        Trainer("stereo_separator", _port_model(params, state), loader,
                config=_cfg(TrainConfig, **kw), pairing=pairing,
                device="cpu")


# ------------------------------------------------------------ entry points
def _stereo_corpus(root, n=5, frames=3000):
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        save_audio(root / f"s{i}.wav", _stereo(i, frames), SR)
    return root


def test_train_from_config_runs_and_checkpoints(tmp_path):
    cfg = load_config(overrides={
        "train": {"model": "stereo_separator", "batch_size": 2,
                  "num_epochs": 2, "save_every": 1,
                  "checkpoint_dir": str(tmp_path / "ck"),
                  "log_dir": str(tmp_path / "runs")},
        "data": {"data_dir": str(_stereo_corpus(tmp_path / "wavs")),
                 "chunk_duration": 0.1, "val_split": 0.2},
        "stereo_separator": {"base_channels": C, "lstm_hidden": H}})
    history = train_from_config(cfg, steps_per_epoch=1, device="cpu")
    assert len(history["train_loss"]) == 2
    assert all(np.isfinite(history["train_loss"] + history["val_loss"]))
    ck = tmp_path / "ck" / "stereo_separator"
    assert (ck / "checkpoint_epoch_2.pth").exists()
    assert not (ck / "checkpoint_epoch_1.pth").exists()
    assert (ck / "best_model.pth").exists()
    assert (tmp_path / "runs" / "stereo_separator"
            / "stereo_separator.jsonl").exists()
    # a rerun resumes at epoch 2 and trains one more
    cfg.train.num_epochs = 3
    history = train_from_config(cfg, steps_per_epoch=1, device="cpu")
    assert len(history["train_loss"]) == 3


def test_cli_train_on_cpu_and_card_default(tmp_path):
    wavs = _stereo_corpus(tmp_path / "wavs", n=10)  # one validation file
    args = ["train", "stereo_separator", "--data-dir", str(wavs),
            "--steps-per-epoch", "1", "--num-epochs", "1",
            "--chunk-duration", "0.1", "--batch-size", "2",
            "--checkpoint-dir", str(tmp_path / "ck")]
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the default log dir is relative
    try:
        assert cli.main(args + ["--device", "cpu"]) == 0
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(args)
    finally:
        os.chdir(cwd)
    assert (tmp_path / "ck" / "stereo_separator" / "best_model.pth").exists()


def test_render_test_outputs_writes_wavs(tmp_path):
    tests = _stereo_corpus(tmp_path / "test_audio", n=2, frames=2500)
    tr = _trainer()
    render_test_outputs(tr, "epoch_1", tests, tmp_path / "out",
                        chunk_seconds=0.05)
    render_test_outputs(tr, "epoch_2", tests, tmp_path / "out",
                        chunk_seconds=0.05)
    names = sorted(p.name for p in (tmp_path / "out").glob("*.wav"))
    assert names == sorted(
        [f"s{i}_{k}" for i in range(2) for k in (
            "original.wav", "degraded_epoch_2.wav", "restored_epoch_2.wav")])


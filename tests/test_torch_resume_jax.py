"""Resuming a JAX training run in the port's trainer.

The JAX package's Trainer writes `.msgpack` runs (the stereo separator at
the small widths of test_torch_train.py, two steps, then progress and
history set by hand) in four variants: Adam without and with global-norm
clipping (optax's 7 + 2N and 3 + 2N leaf layouts), with an EMA, and with
a plateau-reduced learning rate and a plateau counter above 0. The port
resumes each: its weights, BN statistics, Adam moments (held to JAX's own
moments unflattened by JAX's params treedef, so the port's leaf order is
checked independently), step, learning rate, EMA, epoch, step count and
history equal the payload exactly. Its next step on one batch is held to
JAX's next step in two parts. The gradient at the resumed weights: within
1e-5 of the largest entry (the smooth loss terms' bar of
test_torch_train.py) of JAX's gradient run op by op. The update the
resumed Adam state makes: fed the gradient JAX's jitted step applied, the
weights within 1e-2 lr of JAX's (the bar of one step there), the BN
statistics at the models' 1e-4, the EMA at (1 - d) of the weights' bar.
The two JAX gradients differ: at the weights two clipped steps reach, the
stem's gradient nearly cancels inside the train-mode BN, and XLA's fused
jitted program departs from JAX's own op-by-op gradient by up to 9.7e-4 of
the largest entry (the port is 4.3e-7 from the op-by-op one), so the whole
step fed the port's own gradient moves one BN bias element 1.1% of lr
from JAX's.
"""
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ml_audio_restoration_torch.compat import (
    model_from_state_dict, msgpack, state_dict_from_jax)
from ml_audio_restoration_torch.compat.optim import LeafMap, jax_leaves
from ml_audio_restoration_torch.train import checkpoints as ckpt
from test_torch_train import (
    FWD_BAR, GRAD_BAR, SMOOTH, _batch, _jax_trainer, _jax_weights, _trainer)

LR = 1e-3
NAME = "stereo_separator"
VARIANTS = {
    "adam": dict(),
    "clipped": dict(max_grad_norm=0.05),
    "ema": dict(ema_decay=0.9),
    "plateau_clipped_ema": dict(max_grad_norm=0.05, ema_decay=0.9),
}


def _cfg(variant):
    return dict(learning_rate=LR, plateau_patience=1, **SMOOTH,
                **VARIANTS[variant])


def _host(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{variant: (checkpoint path, the saved JAX state, the state after
    JAX's next step, the trainer's progress)}."""
    out = {}
    batch = {"stereo": jnp.asarray(_batch()["stereo"])}
    for variant in VARIANTS:
        jtr = _jax_trainer(*_jax_weights(), **_cfg(variant))
        jtr.checkpoint_dir = tmp_path_factory.mktemp(variant)
        for i in range(2):
            jtr.state, _ = jtr._train_step(jtr.state, batch,
                                           jax.random.PRNGKey(i))
        jtr.epoch, jtr.global_step = 1, 2
        jtr.best_val_loss = 0.25
        jtr.history = {"train_loss": [0.5, 0.375], "val_loss": [0.25, 0.3],
                       "learning_rate": [LR, LR]}
        if variant.startswith("plateau"):
            for _ in range(3):  # patience 1: cut after 2, then wait 1
                jtr._plateau_step(1.0)
            assert jtr.lr == LR / 2 and jtr._plateau_wait == 1
        jtr.save_checkpoint("checkpoint_epoch_1.msgpack")
        saved = _host(jtr.state)
        inputs, targets = jtr._derive(batch, jax.random.PRNGKey(9))
        grad_fn = jax.value_and_grad(
            lambda p: jtr._loss(p, saved["model_state"], inputs, targets,
                                batch, jax.random.PRNGKey(9), True),
            has_aux=True)
        grads = jax.jit(grad_fn)(saved["params"])[1]
        eager = grad_fn(saved["params"])[1]
        after, _ = jtr._train_step(jtr.state, batch, jax.random.PRNGKey(9))
        out[variant] = (jtr.checkpoint_dir / "checkpoint_epoch_1.msgpack",
                        saved, _host(after),
                        dict(lr=jtr.lr, plateau_wait=jtr._plateau_wait,
                             grads=_host(grads), eager=_host(eager)))
    return out


def _moments(saved, clipped):
    """JAX's mu and nu as port state dicts, unflattened by JAX's own params
    treedef (not the port's leaf order)."""
    leaves = jax.tree_util.tree_leaves(saved["opt_state"])
    treedef = jax.tree_util.tree_structure(saved["params"])
    n = treedef.num_leaves
    head = 3 if clipped else 7
    assert len(leaves) == head + 2 * n
    return [state_dict_from_jax(NAME, jax.tree_util.tree_unflatten(
        treedef, leaves[a:a + n]), saved["model_state"])
        for a in (head, head + n)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_resumes_jax_run_exactly(runs, variant, tmp_path):
    path, saved, _, progress = runs[variant]
    tr = _trainer(tmp_path, params_state=_jax_weights(5), **_cfg(variant))
    shutil.copy(path, tmp_path / path.name)
    assert tr.maybe_resume()

    want = state_dict_from_jax(NAME, saved["params"], saved["model_state"])
    for k, v in tr.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    mu, nu = _moments(saved, "clipped" in variant)
    for name, p in tr.model.named_parameters():
        st = tr.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == 2.0
    assert tr.lr == progress["lr"]
    assert all(g["lr"] == progress["lr"] for g in tr.optimizer.param_groups)
    assert tr._plateau_wait == progress["plateau_wait"]
    assert (tr.epoch, tr.global_step, tr.best_val_loss) == (1, 2, 0.25)
    assert tr.history == {"train_loss": [0.5, 0.375], "val_loss": [0.25, 0.3],
                          "learning_rate": [LR, LR]}
    if "ema" in variant:
        ema = state_dict_from_jax(NAME, saved["ema_params"],
                                  saved["model_state"])
        for name, e in tr.ema_params.items():
            assert torch.equal(e, ema[name]), name
    else:
        assert tr.ema_params is None


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resumed_next_step_matches_jax(runs, variant, tmp_path):
    """The step after the resume against JAX's next step: the gradient
    against JAX's op-by-op one, then the update of the gradient JAX's step
    applied (see the module docstring)."""
    path, saved, after, progress = runs[variant]
    tr = _trainer(tmp_path, **_cfg(variant))
    tr.load_checkpoint(path)
    tr.model.train()
    tr.optimizer.zero_grad(set_to_none=True)
    loss, _ = tr._loss(*tr._derive(_batch()))
    loss.backward()
    jgrads, eager = (state_dict_from_jax(NAME, progress[k],
                                         saved["model_state"])
                     for k in ("grads", "eager"))
    scale = max(float(eager[n].abs().max())
                for n, _ in tr.model.named_parameters())
    for name, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), eager[name].numpy(),
                                   atol=GRAD_BAR * scale, err_msg=name)
        p.grad = jgrads[name].clone()
    tr._update()

    lr = progress["lr"]
    want = state_dict_from_jax(NAME, after["params"], after["model_state"])
    ema = (state_dict_from_jax(NAME, after["ema_params"],
                               after["model_state"])
           if tr.ema_params is not None else {})
    ema = {n: ema[n] for n in (tr.ema_params or {})}
    for name, v in tr.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        bar = 1e-2 * lr
        if name.endswith(("running_mean", "running_var")):
            bar = FWD_BAR
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=bar,
                                   err_msg=name)
        if name in ema:
            np.testing.assert_allclose(
                tr.ema_params[name].numpy(), ema[name].numpy(),
                atol=(1 - 0.9) * bar, err_msg=f"ema {name}")
    for p in tr.model.parameters():
        assert float(tr.optimizer.state[p]["step"]) == 3.0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_writer_leaves_equal_jax_trainer_file(runs, variant, tmp_path):
    """chip_smoke's JAX-layout writer, given the resumed trainer, writes
    what the JAX trainer wrote: every optimizer leaf (dtype, shape, value),
    the weights, BN statistics, EMA and progress."""
    path, *_ = runs[variant]
    tr = _trainer(tmp_path, **_cfg(variant))
    tr.load_checkpoint(path)
    want = ckpt.load_msgpack(path)
    got = msgpack.loads(msgpack.dumps(chip_smoke.jax_checkpoint_payload(tr)))
    assert set(got) == set(want)
    wl, gl = want["opt_state"]["leaves"], got["opt_state"]["leaves"]
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        g, w = np.asarray(g), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), i
        np.testing.assert_array_equal(g, w, err_msg=str(i))
    for key in ("params", "model_state", "ema_params"):
        if key in want:
            for g, w in zip(jax_leaves(got[key]), jax_leaves(want[key])):
                np.testing.assert_array_equal(g, w, err_msg=key)
    for key in ("epoch", "global_step", "best_val_loss", "lr",
                "plateau_wait", "model_name"):
        assert np.asarray(got[key]) == np.asarray(want[key]), key
    for k, v in want["history"].items():
        np.testing.assert_array_equal(got["history"][k], v)


@pytest.mark.parametrize("family,leaves", [
    ("denoiser", 70), ("super_resolution", 44), ("stereo_separator", 68)])
def test_leaf_order_is_jax_flatten_order(family, leaves):
    """At full width, each leaf of the port's order holds the elements of
    jax.tree_util's leaf of the same place (sorted dict keys, lists in
    order) of the JAX params pytree."""
    from ml_audio_restoration_tpu import models as jmodels

    params, state = getattr(jmodels, family).init(jax.random.PRNGKey(0))
    model = model_from_state_dict(
        family, state_dict_from_jax(family, params, state))
    leaf_map = LeafMap(family, model)
    flat = np.concatenate([p.detach().numpy().ravel()
                           for p in model.parameters()])
    want = jax.tree_util.tree_leaves(params)
    assert len(leaf_map) == len(want) == leaves
    for idx, w in zip(leaf_map.index, want):
        np.testing.assert_array_equal(flat[idx], np.asarray(w))


def _edit(path, out, edit):
    payload = ckpt.load_msgpack(path)
    edit(payload)
    out.write_bytes(msgpack.dumps(payload))
    return out


@pytest.mark.parametrize("edit,match", [
    (lambda p: p["opt_state"]["leaves"].pop(), "leaves"),
    (lambda p: p["opt_state"]["leaves"].__setitem__(1, np.float32(0.8)),
     "b1"),
    (lambda p: p["opt_state"]["leaves"].__setitem__(5, np.float32(0.5)),
     "learning_rate"),
    (lambda p: p["opt_state"]["leaves"].__setitem__(
        8, np.zeros(3, np.float32)), "shape"),
    (lambda p: p.__setitem__("model_name", "denoiser"), "is for model")])
def test_wrong_layout_leaves_trainer_untouched(runs, tmp_path, edit, match):
    path = _edit(runs["adam"][0], tmp_path / "checkpoint_epoch_2.msgpack",
                 edit)
    tr = _trainer(tmp_path, **_cfg("adam"))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt = tr.optimizer
    with pytest.raises(ValueError, match=match):
        tr.load_checkpoint(path)
    assert tr.optimizer is opt and not opt.state
    assert (tr.epoch, tr.global_step, tr.lr) == (0, 0, LR)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # maybe_resume warns, skips it and takes the next candidate
    shutil.copy(runs["adam"][0], tmp_path / "checkpoint_epoch_1.msgpack")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tr.maybe_resume()
    assert any("checkpoint_epoch_2.msgpack" in str(x.message) for x in w)
    assert tr.global_step == 2


def test_clipping_layout_must_match_config(runs, tmp_path):
    """A clipped run's 3 + 2N leaves are refused by a trainer that does not
    clip, and the reverse."""
    for src, variant in (("clipped", "adam"), ("adam", "clipped")):
        tr = _trainer(tmp_path, **_cfg(variant))
        with pytest.raises(ValueError, match="leaves"):
            tr.load_checkpoint(runs[src][0])
        assert tr.global_step == 0 and not tr.optimizer.state


def test_mixed_directory_resumes_in_order(runs, tmp_path):
    """Epochs newest first, `.pth` before `.msgpack` at an equal epoch, then
    best_model.pth and best_model.msgpack; retention deletes no .msgpack."""
    src = runs["adam"][0]
    tr = _trainer(tmp_path, **_cfg("adam"))
    tr.load_checkpoint(src)
    for name in ("checkpoint_epoch_2.pth", "best_model.pth"):
        tr.save_checkpoint(name)
    for name in ("checkpoint_epoch_3.msgpack", "checkpoint_epoch_2.msgpack",
                 "best_model.msgpack"):
        shutil.copy(src, tmp_path / name)
    assert [p.name for p in ckpt.all_checkpoints(tmp_path)] == [
        "checkpoint_epoch_3.msgpack", "checkpoint_epoch_2.pth",
        "checkpoint_epoch_2.msgpack", "best_model.pth", "best_model.msgpack"]
    (tmp_path / "checkpoint_epoch_3.msgpack").write_bytes(b"torn")
    tr2 = _trainer(tmp_path, **_cfg("adam"))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert tr2._resume_from_first_readable() == "checkpoint_epoch_2.pth"
    tr2.save_checkpoint("checkpoint_epoch_4.pth")
    assert sorted(p.name for p in tmp_path.glob("checkpoint_epoch_*")) == [
        "checkpoint_epoch_2.msgpack", "checkpoint_epoch_3.msgpack",
        "checkpoint_epoch_4.pth"]

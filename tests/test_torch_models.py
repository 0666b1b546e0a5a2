"""The port's models against the JAX package's eval `apply`.

Weights come from JAX `init` with the BN running statistics and affine
parameters randomized first (`init` leaves mean 0, var 1, which would hide a
wrong fold), go through `state_dict_from_jax`, and load strictly. The bar is
1e-4 max abs per model, the bar the JAX package holds against upstream;
the observed deviation is float summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu import models as jm
from ml_audio_restoration_tpu.compat.torch_saver import EXPORTERS
from ml_audio_restoration_torch.compat import (
    load_pth, model_from_state_dict, state_dict_from_jax)
from ml_audio_restoration_torch.models import (
    AudioDenoiser, AudioSuperResolution, StereoSeparator, count_params,
    fold_conv_bn, init_params)
from ml_audio_restoration_torch.pipeline import load_stage

MODEL_BAR = 1e-4


def randomize_bn(params, state, rng):
    """Random BN scale/bias (params) and mean/var (state), in place of the
    identity statistics JAX `init` leaves."""
    def draw(path, a):
        name = str(path[-1])
        if "var" in name or "scale" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        return jnp.asarray(rng.normal(0.0, 0.1, a.shape), jnp.float32)

    def bn_only(path, a):
        keys = [str(k) for k in path]
        if any("bn" in k for k in keys) and ("scale" in keys[-1]
                                             or "bias" in keys[-1]):
            return draw(path, a)
        return a

    return (jax.tree_util.tree_map_with_path(bn_only, params),
            jax.tree_util.tree_map_with_path(draw, state))


def jax_model(name, seed, rng, **cfg):
    mod = {"denoiser": jm.denoiser, "super_resolution": jm.super_resolution,
           "stereo_separator": jm.stereo_separator}[name]
    params, state = mod.init(jax.random.PRNGKey(seed), **cfg)
    return mod, randomize_bn(params, state, rng)


def port_model(name, params, state):
    sd = state_dict_from_jax(name, params, state)
    return model_from_state_dict(name, sd)


def _check(name, rng, x, **cfg):
    mod, (params, state) = jax_model(name, 0, rng, **cfg)
    want, _ = mod.apply(params, state, jnp.asarray(x.transpose(0, 2, 1)))
    want = np.asarray(want).transpose(0, 2, 1)
    model = port_model(name, params, state)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < MODEL_BAR


@pytest.mark.parametrize("t", [512, 515])
def test_denoiser_matches_jax(rng, t):
    """515 samples: an odd length at the second level takes the decoder's
    right-pad."""
    x = (rng.normal(size=(2, 1, t)) * 0.3).astype(np.float32)
    _check("denoiser", rng, x)


@pytest.mark.parametrize("factor", [2, 4])
def test_super_resolution_matches_jax(rng, factor):
    x = (rng.normal(size=(2, 1, 301)) * 0.3).astype(np.float32)
    _check("super_resolution", rng, x, upscale_factor=factor)


@pytest.mark.parametrize("cfg", [
    {}, {"base_channels": 8, "lstm_hidden": 16, "num_lstm_layers": 2}])
def test_stereo_separator_matches_jax(rng, cfg):
    x = (rng.normal(size=(2, 1, 257)) * 0.3).astype(np.float32)
    _check("stereo_separator", rng, x, **cfg)


@pytest.mark.parametrize("cls,count", [
    (AudioDenoiser, 676_242), (AudioSuperResolution, 38_273),
    (StereoSeparator, 494_786)])
def test_default_param_counts(cls, count):
    assert count_params(cls()) == count


@pytest.mark.parametrize("name", ["denoiser", "super_resolution",
                                  "stereo_separator"])
def test_state_dict_from_jax_equals_torch_saver(rng, name):
    _, (params, state) = jax_model(name, 1, rng)
    got = state_dict_from_jax(name, params, state)
    want = EXPORTERS[name](params, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name,cls,cfg", [
    ("denoiser", AudioDenoiser, {"features": (8, 16)}),
    ("super_resolution", AudioSuperResolution,
     {"base_channels": 8, "num_residual_blocks": 2, "upscale_factor": 4}),
    ("stereo_separator", StereoSeparator,
     {"base_channels": 8, "lstm_hidden": 16})])
def test_pth_roundtrip_infers_shapes(rng, tmp_path, name, cls, cfg):
    """An upstream-format .pth (trainer dict) loads through load_stage into
    a model of the right shape, strictly."""
    _, (params, state) = jax_model(name, 2, rng, **cfg)
    path = tmp_path / "best_model.pth"
    torch.save({"epoch": 3, "model_state_dict": EXPORTERS[name](params,
                                                                 state)},
               path)
    model = load_stage(path, name)
    assert isinstance(model, cls) and not model.training
    sd = load_pth(path)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_fold_conv_bn_matches_jax(rng):
    from ml_audio_restoration_tpu.models.common import fold_conv_bn as jfold

    conv = torch.nn.Conv1d(4, 6, 3)
    bn = torch.nn.BatchNorm1d(6)
    with torch.no_grad():
        for p in (conv.weight, conv.bias, bn.weight, bn.bias,
                  bn.running_mean):
            p.copy_(torch.from_numpy(rng.normal(size=p.shape)
                                     .astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2.0, size=6).astype(np.float32)))
    w, b = fold_conv_bn(conv, bn)
    jw, jb = jfold(
        {"w": jnp.asarray(conv.weight.detach().numpy().transpose(2, 1, 0)),
         "b": jnp.asarray(conv.bias.detach().numpy())},
        {"scale": jnp.asarray(bn.weight.detach().numpy()),
         "bias": jnp.asarray(bn.bias.detach().numpy())},
        {"mean": jnp.asarray(bn.running_mean.numpy()),
         "var": jnp.asarray(bn.running_var.numpy())})
    np.testing.assert_allclose(w.detach().numpy(),
                               np.asarray(jw).transpose(2, 1, 0), atol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), atol=1e-6)


def test_init_params_follows_the_generator():
    def weights(seed):
        m = init_params(StereoSeparator(base_channels=8, lstm_hidden=16),
                        torch.Generator().manual_seed(seed))
        return torch.cat([p.detach().flatten() for p in m.parameters()])

    a, b, c = weights(0), weights(0), weights(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 1.0

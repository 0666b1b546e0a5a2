"""The port's packed (space-to-depth) convs against the JAX package's.

The port carries the packed layout only inside its int8 forwards
(ml_audio_restoration_torch/ops/packed.py). Its index maps are copies of
the JAX package's and must equal them exactly; each packed op must equal
the plain conv of the unpacked signal and the JAX package's packed op on
the same input within 1e-5 (float summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings, strategies as st

from ml_audio_restoration_tpu.ops import packed as jp
from ml_audio_restoration_torch.ops import packed as pp

TOL = 1e-5

# (k, r, padding, dilation) of every packed_conv the three models run
CONV_USES = [(3, 4, 1, 1), (3, 2, 1, 1), (3, 1, 1, 1), (5, 8, 2, 1),
             (1, 4, 0, 1), (7, 2, 3, 1), (1, 1, 0, 1), (3, 1, 4, 4),
             (3, 1, 8, 8), (3, 1, 2, 2)]
# (k, r_in, r_out, padding, dilation) of every rate-raising packed_conv_r
RAISE_USES = [(3, 1, 4, 1, 1), (7, 1, 4, 3, 1), (7, 1, 2, 3, 1)]
# (k, r_in, r_out, stride, padding, dilation) of every transpose map: the
# up-convs, and the exits packed_conv_r runs as flipped transposes
TRANSPOSE_USES = [(2, 1, 1, 2, 0, 1), (2, 1, 2, 2, 0, 1), (2, 2, 4, 2, 0, 1),
                  (4, 4, 8, 2, 1, 1), (3, 4, 1, 1, 1, 1), (1, 4, 1, 1, 0, 1),
                  (7, 8, 1, 1, 3, 1), (3, 4, 1, 1, 2, 2), (7, 2, 1, 1, 3, 1)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y


@pytest.mark.parametrize("case", CONV_USES)
def test_conv_index_map_matches_jax(case):
    _same(pp._conv_index_map(*case), jp._conv_index_map(*case))


@pytest.mark.parametrize("case", RAISE_USES)
def test_raise_index_map_matches_jax(case):
    _same(pp._conv_raise_index_map(*case), jp._conv_raise_index_map(*case))


@pytest.mark.parametrize("case", TRANSPOSE_USES)
def test_transpose_index_map_matches_jax(case):
    _same(pp._transpose_index_map(*case), jp._transpose_index_map(*case))


@settings(max_examples=60, deadline=None)
@given(k=st.integers(1, 8), r=st.sampled_from([1, 2, 4, 8]),
       d=st.integers(1, 8), p=st.integers(0, 12),
       r_out=st.sampled_from([1, 2, 4, 8, 16]), s=st.sampled_from([1, 2]))
def test_index_maps_sweep(k, r, d, p, r_out, s):
    """Every map over a sweep of shapes, wherever the JAX package's map
    exists (the raise map needs r_out a multiple of r, the transpose map
    s*r a multiple of r_out)."""
    _same(pp._conv_index_map(k, r, p, d), jp._conv_index_map(k, r, p, d))
    if r_out % r == 0:
        _same(pp._conv_raise_index_map(k, r, r_out, p, d),
              jp._conv_raise_index_map(k, r, r_out, p, d))
    if (s * r) % r_out == 0:
        _same(pp._transpose_index_map(k, r, r_out, s, p, d),
              jp._transpose_index_map(k, r, r_out, s, p, d))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _pack(x, r):
    b, t, c = x.shape
    return x.reshape(b, t // r, r * c)


def _unpack(xp, r, c):
    b, tp, _ = xp.shape
    return xp.reshape(b, tp * r, c)


def _plain_conv(x, w, b, p, d):
    """Plain 'same' conv: NWC x, WIO w, in PyTorch."""
    y = F.conv1d(torch.from_numpy(x).permute(0, 2, 1),
                 torch.from_numpy(w).permute(2, 1, 0), torch.from_numpy(b),
                 padding=p, dilation=d)
    return y.permute(0, 2, 1).numpy()


def _check(got, plain, jax_out):
    assert got.shape == plain.shape == jax_out.shape
    assert np.abs(got - plain).max() <= TOL
    assert np.abs(got - jax_out).max() <= TOL


@pytest.mark.parametrize("k,r,p,d", CONV_USES)
def test_packed_conv_matches_plain_and_jax(k, r, p, d):
    rng = np.random.default_rng(k * 100 + r * 10 + d)
    cin, cout, t = 3, 5, 8 * 12
    x, w, b = _rand(rng, 2, t, cin), _rand(rng, k, cin, cout) * 0.3, \
        _rand(rng, cout)
    got = pp.packed_conv(torch.from_numpy(_pack(x, r)), torch.from_numpy(w),
                         torch.from_numpy(b), r=r, padding=p, dilation=d)
    want = jp.packed_conv(jnp.asarray(_pack(x, r)), jnp.asarray(w),
                          jnp.asarray(b), r=r, padding=p, dilation=d)
    _check(_unpack(got.numpy(), r, cout), _plain_conv(x, w, b, p, d),
           _unpack(np.asarray(want), r, cout))


@pytest.mark.parametrize("k,r_in,r_out,p,d", RAISE_USES + [
    (3, 4, 1, 1, 1), (1, 4, 1, 0, 1), (7, 8, 1, 3, 1), (3, 4, 1, 2, 2),
    (7, 2, 1, 3, 1), (3, 2, 4, 1, 1)])
def test_packed_conv_r_matches_plain_and_jax(k, r_in, r_out, p, d):
    """Rate-raising entries and the exits (transposes with a flipped
    kernel under lhs dilation r_in/r_out)."""
    rng = np.random.default_rng(k * 1000 + r_in * 10 + r_out)
    cin, cout, t = 4, 3, 8 * 12
    x, w, b = _rand(rng, 2, t, cin), _rand(rng, k, cin, cout) * 0.3, \
        _rand(rng, cout)
    got = pp.packed_conv_r(torch.from_numpy(_pack(x, r_in)),
                           torch.from_numpy(w), torch.from_numpy(b),
                           r_in=r_in, r_out=r_out, padding=p, dilation=d,
                           t_in=t)
    want = jp.packed_conv_r(jnp.asarray(_pack(x, r_in)), jnp.asarray(w),
                            jnp.asarray(b), r_in=r_in, r_out=r_out,
                            padding=p, dilation=d, t_in=t)
    _check(_unpack(got.numpy(), r_out, cout), _plain_conv(x, w, b, p, d),
           _unpack(np.asarray(want), r_out, cout))


@pytest.mark.parametrize("k,r_in,r_out,s,p", [
    (2, 1, 1, 2, 0), (2, 1, 2, 2, 0), (2, 2, 4, 2, 0), (4, 4, 8, 2, 1),
    (4, 1, 1, 2, 1), (4, 2, 4, 2, 1)])
def test_packed_conv_transpose_matches_plain_and_jax(k, r_in, r_out, s, p):
    """The up-convs, w in torch's tap order [k, Cin, Cout]."""
    rng = np.random.default_rng(k * 100 + r_out)
    cin, cout, t = 3, 4, 8 * 6
    x, w, b = _rand(rng, 2, t, cin), _rand(rng, k, cin, cout) * 0.3, \
        _rand(rng, cout)
    got = pp.packed_conv_transpose(
        torch.from_numpy(_pack(x, r_in)), torch.from_numpy(w),
        torch.from_numpy(b), r_in=r_in, r_out=r_out, stride=s, padding=p,
        t_in=t)
    want = jp.packed_conv_transpose(
        jnp.asarray(_pack(x, r_in)), jnp.asarray(w), jnp.asarray(b),
        r_in=r_in, r_out=r_out, stride=s, padding=p, t_in=t)
    plain = F.conv_transpose1d(
        torch.from_numpy(x).permute(0, 2, 1),
        torch.from_numpy(w).permute(1, 2, 0), torch.from_numpy(b),
        stride=s, padding=p).permute(0, 2, 1).numpy()
    _check(_unpack(got.numpy(), r_out, cout), plain,
           _unpack(np.asarray(want), r_out, cout))


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_packed_max_pool2_matches_plain_and_jax(r, dtype):
    rng = np.random.default_rng(r)
    c, t = 3, 8 * 5
    x = (rng.integers(-127, 128, (2, t, c)) if dtype == np.int8
         else rng.normal(size=(2, t, c))).astype(dtype)
    got = pp.packed_max_pool2(torch.from_numpy(_pack(x, r)), c)
    want = np.asarray(jp.packed_max_pool2(jnp.asarray(_pack(x, r)), c))
    plain = x.reshape(2, t // 2, 2, c).max(axis=2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_unpack(got.numpy(), r // 2, c), plain)


def test_plain_exec_crops_a_negative_pad():
    """XLA reads a negative pad as a crop; the float executor does too."""
    x = torch.arange(10.0).reshape(1, 10, 1)
    w = torch.ones((1, 1, 1))
    y = pp._plain_exec(x, lambda: (w, None), window_strides=(1,),
                       padding=[(-2, 1)])
    assert y[0, :, 0].tolist() == [2.0, 3, 4, 5, 6, 7, 8, 9, 0]


@pytest.mark.parametrize("m", [2, 4])
def test_upsample_linear_matches_jax_conv_form(m):
    """The int8 SR forward adds the port's upsample_linear where the JAX
    package's packed forward adds its transpose-conv form of it
    (`_upsample_linear_conv`); the two agree within 1e-6."""
    from ml_audio_restoration_tpu.models.super_resolution import (
        _upsample_linear_conv)
    from ml_audio_restoration_torch.ops import upsample_linear

    x = _rand(np.random.default_rng(m), 2, 1024, 1)
    want = np.asarray(_upsample_linear_conv(jnp.asarray(x), 1, 1024, m))
    got = upsample_linear(torch.from_numpy(x).permute(0, 2, 1), m)
    assert np.abs(got.permute(0, 2, 1).numpy() - want).max() <= 1e-6

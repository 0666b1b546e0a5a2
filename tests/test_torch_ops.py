"""The port's ops against their JAX twins on the same numpy inputs.

Layouts: the JAX ops are NWC with [k, in, out] kernels, the port's NCW with
torch's weight layouts, so inputs are transposed on the way in and out.
Tolerances: 1e-5 where a convolution sums in another order than XLA's CPU
kernel; 1e-6 for elementwise work and reshapes; exact where nothing is
summed.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ml_audio_restoration_tpu import ops as jops
from ml_audio_restoration_tpu.ops import chunking as jchunk
from ml_audio_restoration_torch import ops


def _nwc(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _back(y):
    return np.asarray(y).transpose(0, 2, 1)


@pytest.mark.parametrize("t,k,padding,dilation,stride", [
    (101, 3, 1, 1, 1), (100, 7, 3, 1, 1), (97, 3, 4, 4, 1),
    (64, 1, 0, 1, 1), (99, 5, 2, 1, 2)])
def test_conv1d(rng, t, k, padding, dilation, stride):
    x = rng.normal(size=(2, 6, t)).astype(np.float32)
    w = rng.normal(size=(5, 6, k)).astype(np.float32) * 0.3
    b = rng.normal(size=(5,)).astype(np.float32)
    want = jops.conv1d(_nwc(x), jnp.asarray(w.transpose(2, 1, 0)),
                       jnp.asarray(b), stride=stride, padding=padding,
                       dilation=dilation)
    got = ops.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), stride=stride, padding=padding,
                     dilation=dilation)
    np.testing.assert_allclose(got.numpy(), _back(want), atol=1e-5)


@pytest.mark.parametrize("t,k,stride,padding", [
    (33, 2, 2, 0), (32, 2, 2, 0), (33, 4, 2, 1), (50, 4, 2, 1)])
def test_conv_transpose1d(rng, t, k, stride, padding):
    """Torch's kernel order on both sides: the JAX op flips the kernel
    itself, the port hands it to torch unflipped."""
    x = rng.normal(size=(2, 6, t)).astype(np.float32)
    w = rng.normal(size=(6, 4, k)).astype(np.float32) * 0.3  # [in, out, k]
    b = rng.normal(size=(4,)).astype(np.float32)
    want = jops.conv_transpose1d(_nwc(x), jnp.asarray(w.transpose(2, 0, 1)),
                                 jnp.asarray(b), stride=stride,
                                 padding=padding)
    got = ops.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), stride=stride,
                               padding=padding)
    assert got.shape[-1] == (t - 1) * stride - 2 * padding + k
    np.testing.assert_allclose(got.numpy(), _back(want), atol=1e-5)


@pytest.mark.parametrize("t", [64, 65, 3])
def test_max_pool1d(rng, t):
    x = rng.normal(size=(2, 3, t)).astype(np.float32)
    got = ops.max_pool1d(torch.from_numpy(x))
    assert got.shape[-1] == t // 2  # floor mode
    np.testing.assert_array_equal(got.numpy(),
                                  _back(jops.max_pool1d(_nwc(x))))


@pytest.mark.parametrize("t", [50, 51])
def test_moving_average(rng, t):
    x = rng.normal(size=(2, 1, t)).astype(np.float32)
    got = ops.moving_average(torch.from_numpy(x), 5)
    want = _back(jops.moving_average(_nwc(x), 5))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_leaky_relu(rng):
    x = rng.normal(size=(2, 3, 40)).astype(np.float32)
    got = ops.leaky_relu(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  _back(jops.leaky_relu(_nwc(x))))


def test_batch_norm(rng):
    x = rng.normal(size=(2, 4, 30)).astype(np.float32)
    scale, bias, mean = (rng.normal(size=(4,)).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2.0, size=(4,)).astype(np.float32)
    got = ops.batch_norm(*(torch.from_numpy(a)
                           for a in (x, scale, bias, mean, var)))
    want = jops.batch_norm(_nwc(x), *(jnp.asarray(a)
                                      for a in (scale, bias, mean, var)))
    np.testing.assert_allclose(got.numpy(), _back(want), atol=1e-6)


@pytest.mark.parametrize("t,out_len,tol", [
    (100, 200, 1e-6), (101, 404, 1e-6), (1000, 3000, 1e-4)])
def test_interp_linear(rng, t, out_len, tol):
    """float32 source positions on both sides (torch's own math). Dyadic
    scales are exact; at a non-dyadic scale XLA rounds the float32
    position arithmetic differently in a few places (1e-4)."""
    x = rng.normal(size=(2, 1, t)).astype(np.float32)
    got = ops.interp_linear(torch.from_numpy(x), out_len)
    want = _back(jops.interp_linear(_nwc(x), out_len))
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_linear(rng, factor):
    x = rng.normal(size=(2, 1, 77)).astype(np.float32)
    got = ops.upsample_linear(torch.from_numpy(x), factor)
    want = _back(jops.upsample_linear(_nwc(x), factor))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("length,chunk,hop", [
    (100, 200, 150), (200, 200, 150), (201, 200, 150), (5000, 1000, 800),
    (2646000, 44100, 42998)])
def test_num_chunks(length, chunk, hop):
    assert ops.num_chunks(length, chunk, hop) == jchunk.num_chunks(
        length, chunk, hop)


@pytest.mark.parametrize("chunk,overlap", [(100, 0), (100, 7), (64, 32)])
def test_crossfade_window(chunk, overlap):
    got = ops.crossfade_window(chunk, overlap)
    want = np.asarray(jchunk.crossfade_window(chunk, overlap))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)


@pytest.mark.parametrize("overlap,valid", [
    (0, None), (100, None), (100, 3), (0, 2), (300, 5)])
def test_overlap_add(rng, overlap, valid):
    n, chunk = 6, 700
    hop = chunk - overlap
    total = (n - 1) * hop + chunk
    length = total - 37
    x = rng.normal(size=(n, 2, chunk)).astype(np.float32)
    got = ops.overlap_add(torch.from_numpy(x), hop, length, overlap=overlap,
                          valid=valid)
    want = jchunk.overlap_add(jnp.asarray(x), hop, length, overlap=overlap,
                              valid=valid)
    assert got.shape == (2, length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("overlap", [0, 100, 512, 1024])
def test_frame_structured(rng, overlap):
    chunk, n = 2048, 5
    hop = chunk - overlap
    total = (n - 1) * hop + chunk
    x = rng.normal(size=(1, total)).astype(np.float32)
    got = ops.frame_structured(torch.from_numpy(x), n, chunk, hop)
    want = jchunk.frame_structured(jnp.asarray(x), n, chunk, hop)
    assert got.shape == (n, chunk, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

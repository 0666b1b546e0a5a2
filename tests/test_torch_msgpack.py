"""The port's flax msgpack reader and writer (compat/msgpack.py) against
flax, and `.msgpack` checkpoints served by the port.

- `loads` equals `flax.serialization.msgpack_restore` on the JAX package's
  own `save_checkpoint` output (a trainer payload: params, BN state, the
  optimizer tree, EMA weights, scalars, history, the model name) and on a
  tree of every msgpack format and flax ext type, chunked arrays
  included; an unmappable dtype name (bfloat16) raises.
- `dumps` writes flax's bytes for the same trees, so its files restore in
  flax.
- `jax_from_state_dict` equals the JAX package's torch_loader converters.
- A `.msgpack` stage is within 1e-4 of the JAX model's `apply`, the chain
  from `.msgpack` files within 1e-3 of the JAX pipeline's (the model and
  chain bars), and equal to the port's chain from the same weights' `.pth`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ml_audio_restoration_tpu.compat.torch_loader import CONVERTERS
from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.pipeline import RestorationPipeline as JaxPipe
from ml_audio_restoration_tpu.train import checkpoints as jckpt
from ml_audio_restoration_tpu.train.trainer import _opt_state_to_tree
from ml_audio_restoration_torch.compat import (
    jax_from_state_dict, msgpack, save_pth, state_dict_from_jax)
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.pipeline import (
    RestorationPipeline, StreamingRestorer, load_stage)
from ml_audio_restoration_torch.train.checkpoints import (
    load_msgpack, load_native)
from test_torch_models import MODEL_BAR, jax_model
from test_torch_pipeline import CHAIN_BAR, CHUNKED, RATE, SMALL


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A JAX trainer payload of each family at narrow widths, written by
    the JAX package's save_checkpoint: {name: (module, params, state,
    path)}."""
    root = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(5)
    out = {}
    for i, (name, cfg) in enumerate(SMALL.items()):
        mod, (params, state) = jax_model(name, i, rng, **cfg)
        path = root / f"{name}.msgpack"
        jckpt.save_checkpoint(path, {
            "params": params, "model_state": state,
            "opt_state": _opt_state_to_tree(optax.adam(1e-3).init(params)),
            "epoch": np.asarray(3), "global_step": np.asarray(12),
            "best_val_loss": np.asarray(0.25), "lr": np.asarray(1e-3),
            "history": {"train_loss": np.asarray([1.0, 0.5], np.float64)},
            "model_name": name, "plateau_wait": np.asarray(0),
            "ema_params": jax.tree_util.tree_map(lambda x: x * 0.5, params),
        })
        out[name] = (mod, params, state, path)
    return out


def _assert_same(got, want, where="tree"):
    """Equal trees: the same containers, key order, leaf types, dtypes,
    shapes and values."""
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}/{i}")
    elif isinstance(want, np.ndarray):
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name", list(SMALL))
def test_reader_and_writer_equal_flax_on_jax_checkpoints(checkpoints, name):
    data = checkpoints[name][3].read_bytes()
    want = serialization.msgpack_restore(data)
    got = load_msgpack(checkpoints[name][3])
    _assert_same(got, want)
    assert msgpack.dumps(got) == data
    params, state = load_native(checkpoints[name][3])
    jparams, jstate = jckpt.load_native(checkpoints[name][3])
    _assert_same(params, jparams)
    _assert_same(state, jstate)


def _every_format():
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
            2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
            -2**31 - 1, -2**63]
    return {
        "ints": ints, "floats": [0.0, -1.5, 1e300, float("inf")],
        "none_bool": [None, True, False],
        "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536,
                "ünïcode"],
        "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "lists": [list(range(15)), list(range(16)), list(range(65536))],
        "maps": {"m15": {f"k{i}": i for i in range(15)},
                 "m16": {f"k{i:02d}": i for i in range(16)},
                 "m65536": {f"{i:05d}": i for i in range(65536)}},
        "arrays": [np.arange(n, dtype=np.float32) for n in (0, 1, 9, 60,
                                                          20000)]
        + [np.ones((2, 3), np.int8), np.array([True, False]),
           np.arange(6, dtype=np.uint16).reshape(3, 2),
           np.array([1 + 2j], np.complex64), np.zeros((), np.float64)],
        "scalars": [np.float32(1.5), np.float64(-2.0), np.int64(7),
                    np.bool_(True), np.uint8(3), 3 + 4j],
    }


def test_every_format_both_ways():
    tree = _every_format()
    data = serialization.msgpack_serialize(tree)
    _assert_same(msgpack.loads(data), serialization.msgpack_restore(data))
    assert msgpack.dumps(tree) == data
    _assert_same(serialization.msgpack_restore(msgpack.dumps(tree)),
                 serialization.msgpack_restore(data))


def test_chunked_arrays_are_joined(monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into
    `__msgpack_chunked_array__` maps; the reader joins them as flax does
    (here with the chunk size cut to 64 bytes)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "nested": {"w": np.arange(40, dtype=np.int64)}, "small": 1}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack.loads(data)
    _assert_same(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])


def test_unmappable_dtype_raises():
    data = serialization.msgpack_serialize(
        {"w": np.asarray(jnp.zeros(3, jnp.bfloat16))})
    with pytest.raises(ValueError, match="bfloat16"):
        msgpack.loads(data)
    with pytest.raises(ValueError, match="truncated"):
        msgpack.loads(data[:-2])


@pytest.mark.parametrize("name", list(SMALL))
def test_jax_from_state_dict_equals_jax_converters(checkpoints, name):
    _, params, state, _ = checkpoints[name]
    sd = state_dict_from_jax(name, params, state)
    got = jax_from_state_dict(name, sd)
    want = jax.tree_util.tree_map(
        np.asarray, CONVERTERS[name]({k: v.numpy() for k, v in sd.items()}))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                           jax.tree_util.tree_map(np.asarray,
                                                  (params, state)))


@pytest.mark.parametrize("name,t", [("denoiser", 515),
                                    ("super_resolution", 300),
                                    ("stereo_separator", 400)])
def test_msgpack_stage_matches_jax_apply(checkpoints, name, t):
    mod, params, state, path = checkpoints[name]
    x = (np.random.default_rng(t).normal(size=(2, 1, t)) * 0.3).astype(
        np.float32)
    want, _ = mod.apply(params, state, jnp.asarray(x.transpose(0, 2, 1)))
    with torch.inference_mode():
        got = load_stage(path, name)(torch.from_numpy(x)).numpy()
    assert got.shape == np.asarray(want).transpose(0, 2, 1).shape
    assert np.max(np.abs(got - np.asarray(want).transpose(0, 2, 1))) \
        < MODEL_BAR


def test_msgpack_chain_matches_jax_and_pth_twin(checkpoints, tmp_path):
    paths = [checkpoints[name][3] for name in SMALL]
    audio = (np.random.default_rng(3).normal(size=(1, 5000)) * 0.2).astype(
        np.float32)
    port = RestorationPipeline.from_checkpoints(
        *paths, config=PipelineConfig(**CHUNKED), device="cpu")
    want, rate = JaxPipe.from_checkpoints(
        *paths, config=JaxConfig(**CHUNKED)).restore(audio, RATE)
    got, got_rate = port.restore(audio, RATE)
    assert got_rate == rate and tuple(got.shape) == np.asarray(want).shape
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < CHAIN_BAR
    pths = []
    for name in SMALL:
        _, params, state, _ = checkpoints[name]
        pths.append(save_pth(tmp_path / f"{name}.pth", name,
                             state_dict_from_jax(name, params, state)))
    twin = RestorationPipeline.from_checkpoints(
        *pths, config=PipelineConfig(**CHUNKED), device="cpu")
    assert torch.equal(twin.restore(audio, RATE)[0], got)
    stream = StreamingRestorer.from_checkpoints(*paths, device="cpu",
                                                context=512, lookahead=256)
    out = stream.feed(audio[0, :2000])
    assert out.shape[0] == 2 and np.isfinite(out).all()


def test_missing_checkpoint_names_msgpack(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"\.msgpack"):
        load_stage(tmp_path / "none.msgpack", "denoiser")


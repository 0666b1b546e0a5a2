"""The port's denoiser and super-resolution data and entry points against
the JAX package's.

The loaders must yield the JAX package's batches exactly. JAX reads a mono
batch through `_MonoBatchReadMixin.getitems` when its native reader loads,
and item by item when it does not: the two routes normalize in other
float orders and fall back differently, so each is held on its own, over a
corpus with a file shorter than the chunk, a file exactly one chunk long
and a stereo file to mix down. Then
`train_from_config`, a resumed run's next step, test-audio rendering and
the CLI for both families, on the CPU at tiny sizes.
"""
import os
import warnings

import numpy as np
import pytest
import torch
import yaml

from ml_audio_restoration_tpu.audio import native
from ml_audio_restoration_tpu.data.datasets import \
    RestorationDataset as JRestorationDataset
from ml_audio_restoration_tpu.data.datasets import \
    SuperResolutionDataset as JSuperResolutionDataset
from ml_audio_restoration_tpu.data.loader import DataLoader as JDataLoader
from ml_audio_restoration_tpu.data.loader import \
    train_val_split as jtrain_val_split
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.audio import save_audio, wav_info
from ml_audio_restoration_torch.config import load_config
from ml_audio_restoration_torch.data import (
    DataLoader, RestorationDataset, SuperResolutionDataset, train_val_split)
from ml_audio_restoration_torch.train.trainer import (
    build_trainer, render_test_outputs, train_from_config)
from test_torch_pipeline import SMALL

SR = 22050
CHUNK_S = 0.1  # 2,205 frames at 22.05 kHz


def _corpus(root, rate=SR, n=8, odd_rate_file=False):
    """Mono WAVs of several lengths: a short one (1,000 frames), one of
    exactly one chunk, a stereo one, PCM_16 and FLOAT; optionally one long
    file at another rate."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    chunk = int(rate * CHUNK_S)
    lengths = [3000, 1000, chunk, 5000, 4000, 2600, 7000, 3500][:n]
    for i, length in enumerate(lengths):
        ch = 2 if i == 4 else 1
        x = rng.standard_normal((ch, length)) * (0.05 + 0.05 * i)
        save_audio(root / f"f{i}.wav", x.astype(np.float32), rate,
                   subtype="FLOAT" if i % 2 else "PCM_16")
    if odd_rate_file:
        save_audio(root / "g_other_rate.wav",
                   (rng.standard_normal((1, 9000)) * 0.1).astype(np.float32),
                   16000)
    return root


class PerItem:
    """A dataset without `getitems`: the loader reads it item by item."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def _batches(loader):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(loader)


def _assert_batches_equal(got, want, key, shape):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {key}
        assert g[key].shape == shape and g[key].dtype == np.float32
        np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("route", ["native", "per_item"])
def test_restoration_loader_equals_jax(tmp_path, monkeypatch, route):
    """Two epochs of shuffled batches equal, bit for bit, on each route."""
    root = _corpus(tmp_path / "wavs")
    if route == "native":
        assert native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    ds, jds = (cls(root, SR, CHUNK_S, seed=3)
               for cls in (RestorationDataset, JRestorationDataset))
    tr, va = train_val_split(ds, 0.25, seed=5)
    jtr, jva = jtrain_val_split(jds, 0.25, seed=5)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    source = ds if route == "native" else PerItem(ds)
    for _ in range(2):
        got = _batches(DataLoader(source, 2, indices=tr, seed=11))
        want = _batches(JDataLoader(jds, 2, indices=jtr, seed=11,
                                    num_workers=1))
        _assert_batches_equal(got, want, "clean", (2, 1, int(SR * CHUNK_S)))


def test_batch_route_agrees_with_per_item_route(tmp_path):
    """The two routes draw the same starts (for the short file the range
    is {0}, which numpy's `integers` returns without a draw) and normalize
    the short row over its true length, so they agree to the f32 rounding
    of the RMS (np.sum / n against np.mean); the short row is -20 dB over
    its 1,000 frames and zero after them."""
    root = _corpus(tmp_path / "wavs")
    a, b = (RestorationDataset(root, SR, CHUNK_S, seed=3) for _ in range(2))
    order = [1, 0, 3, 2, 4]  # the short file first
    batch = a.getitems(order)
    for got, i in zip(batch, order):
        np.testing.assert_allclose(got["clean"], b[i]["clean"], atol=1e-6)
    short = batch[0]["clean"][0]
    np.testing.assert_allclose(np.sqrt(np.mean(short[:1000] ** 2)), 0.1,
                               rtol=1e-5)
    assert not np.any(short[1000:])


def test_batch_route_falls_back_like_jax(tmp_path):
    """A file at another rate sends the whole batch to per-item reads after
    the starts already drawn, in both packages."""
    root = _corpus(tmp_path / "wavs", n=4, odd_rate_file=True)
    assert native.available()
    ds, jds = (cls(root, SR, CHUNK_S, seed=2)
               for cls in (RestorationDataset, JRestorationDataset))
    for order in ([0, 4, 2], [3, 1], [4, 0]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, want = ds.getitems(order), jds.getitems(order, threads=1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["clean"], w["clean"])


def test_super_resolution_loader_equals_jax(tmp_path):
    """2 s at 44.1 kHz in the configs; here 0.1 s chunks (4,410 frames) of
    44.1 kHz files, read item by item as in the JAX package."""
    root = _corpus(tmp_path / "wavs", rate=44100)
    ds = SuperResolutionDataset(root, chunk_duration=CHUNK_S, seed=4)
    jds = JSuperResolutionDataset(root, chunk_duration=CHUNK_S, seed=4)
    assert ds.pairing == jds.pairing == "downsample"
    assert (ds.chunk_size, ds.low_chunk_size) == (4410, 2205)
    assert not hasattr(ds, "getitems")
    for _ in range(2):
        got = _batches(DataLoader(ds, 3, seed=1))
        want = _batches(JDataLoader(jds, 3, seed=1, num_workers=1))
        _assert_batches_equal(got, want, "high", (3, 1, 4410))


def test_dataset_options(tmp_path):
    """The pairings, and a FLAC corpus (once refused): 16-bit FLAC twins of
    16-bit WAVs give the denoiser's batch route and the SR set's per-item
    route the WAV batches bit for bit."""
    root = _corpus(tmp_path / "wavs", n=2)
    assert RestorationDataset(root).pairing == "degrade"
    assert RestorationDataset(root, add_artifacts=False).pairing == "identity"
    rng = np.random.default_rng(3)
    for rate, name in ((SR, "mono"), (44100, "high")):
        for i, length in enumerate((3000, 1000, 6000)):
            x = (rng.standard_normal((1, length)) * 0.1).astype(np.float32)
            for ext in ("wav", "flac"):
                save_audio(tmp_path / f"{name}_{ext}" / f"f{i}.{ext}", x,
                           rate)
    for cls, name, key in ((RestorationDataset, "mono", "clean"),
                           (SuperResolutionDataset, "high", "high")):
        wav, flac = (cls(tmp_path / f"{name}_{ext}", chunk_duration=CHUNK_S,
                         seed=3) for ext in ("wav", "flac"))
        assert all(p.suffix == ".flac" for p in flac.files)
        for _ in range(2):
            got = _batches(DataLoader(flac, 2, seed=11))
            want = _batches(DataLoader(wav, 2, seed=11))
            _assert_batches_equal(got, want, key,
                                  (2, 1, flac.chunk_size))


# ------------------------------------------------------------ entry points
def _config(tmp_path, name, wavs, **train):
    return load_config(overrides={
        "train": {"model": name, "batch_size": 2, "num_epochs": 2,
                  "save_every": 1, "checkpoint_dir": str(tmp_path / "ck"),
                  "log_dir": str(tmp_path / "runs"), **train},
        "data": {"data_dir": str(wavs), "chunk_duration": CHUNK_S,
                 "val_split": 0.25},
        name: SMALL[name]})


CORPUS_RATE = {"denoiser": SR, "super_resolution": 44100}


@pytest.mark.parametrize("name", list(CORPUS_RATE))
def test_train_from_config_runs_and_resumes(tmp_path, name):
    wavs = _corpus(tmp_path / "wavs", rate=CORPUS_RATE[name])
    cfg = _config(tmp_path, name, wavs)
    history = train_from_config(cfg, steps_per_epoch=1, device="cpu")
    assert len(history["train_loss"]) == 2
    assert all(np.isfinite(history["train_loss"] + history["val_loss"]))
    ck = tmp_path / "ck" / name
    assert (ck / "checkpoint_epoch_2.pth").exists()
    assert (ck / "best_model.pth").exists()
    # the checkpoint restores as the pipeline's stage
    from ml_audio_restoration_torch.pipeline.restore import load_stage

    assert load_stage(ck / "best_model.pth", name) is not None
    cfg.train.num_epochs = 3
    history = train_from_config(cfg, steps_per_epoch=1, device="cpu")
    assert len(history["train_loss"]) == 3


@pytest.mark.parametrize("name", list(CORPUS_RATE))
def test_resumed_trainer_takes_the_uninterrupted_step(tmp_path, name):
    """A fresh trainer resumed from a checkpoint takes, on the same batch
    and the same (epoch, step) draws, the step the uninterrupted trainer
    takes: equal bit for bit, the degradation included."""
    wavs = _corpus(tmp_path / "wavs", rate=CORPUS_RATE[name])
    cfg = _config(tmp_path, name, wavs, num_epochs=1, ema_decay=0.9,
                  max_grad_norm=1.0)
    tr = build_trainer(cfg, steps_per_epoch=2, device="cpu")
    tr.train()
    batch = next(iter(tr.train_loader))
    fresh = build_trainer(cfg, steps_per_epoch=2, device="cpu")
    assert (fresh.epoch, fresh.global_step) == (1, 2)
    steps = [t._train_step(batch, t._seeded(4, 0)) for t in (tr, fresh)]
    assert torch.equal(steps[0]["loss"], steps[1]["loss"])
    for (k, a), b in zip(tr.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in tr.ema_params.items():
        assert torch.equal(v, fresh.ema_params[k]), k


@pytest.mark.parametrize("name", list(CORPUS_RATE))
def test_render_test_outputs_uses_the_stage_slot(tmp_path, name):
    wavs = _corpus(tmp_path / "wavs", rate=CORPUS_RATE[name], n=2)
    tests = _corpus(tmp_path / "tests", n=1)
    tr = build_trainer(_config(tmp_path, name, wavs), device="cpu")
    render_test_outputs(tr, "epoch_1", tests, tmp_path / "out",
                        chunk_seconds=0.05)
    out = wav_info(tmp_path / "out" / "f0_restored_epoch_1.wav")
    assert out.channels == 1
    assert out.sample_rate == (2 * SR if name == "super_resolution" else SR)


@pytest.mark.parametrize("name", list(CORPUS_RATE))
def test_cli_train_on_cpu_and_card_default(tmp_path, name):
    wavs = _corpus(tmp_path / "wavs", rate=CORPUS_RATE[name])
    args = ["train", name, "--data-dir", str(wavs), "--steps-per-epoch",
            "1", "--num-epochs", "1", "--chunk-duration", str(CHUNK_S),
            "--batch-size", "2", "--checkpoint-dir", str(tmp_path / "ck")]
    cfg = tmp_path / "small.yaml"  # narrow widths, two validation files
    cfg.write_text(yaml.safe_dump({
        name: {k: list(v) if isinstance(v, tuple) else v
               for k, v in SMALL[name].items()},
        "data": {"val_split": 0.25}}))
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the default log dir is relative
    try:
        assert cli.main(args + ["--config", str(cfg), "--device",
                                "cpu"]) == 0
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(args)
    finally:
        os.chdir(cwd)
    assert (tmp_path / "ck" / name / "best_model.pth").exists()

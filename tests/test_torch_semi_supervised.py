"""The denoiser's semi-supervised (`mixed`) and adaptive
(`degrade_adaptive`) training against the JAX package's.

Small widths (test_torch_pipeline.SMALL), B 2 or 3, T 2048, inputs at RMS
~0.35 (test_torch_convnet_train.py's GAIN), weights from the JAX
package's `init` with randomized BN. Every degradation is fed the JAX
package's own draws, rebuilt from its key splits as
test_torch_artifacts.py does, here with the adaptive overrides. Bars:
- the semi-supervised losses: 1e-5 relative (the same f32 arithmetic);
- the simulator under per-item overrides: 1e-5 max abs (observed ~1e-7);
- `detect_impulses_analytical`, the two datasets' items and the loader's
  batches: equal;
- a `mixed` step (cycle consistency, contrastive term) and an adaptive
  step: the loss at 1e-4 relative (the consistency loss's energy term
  squares a difference of two sums of squares over T: 1.5e-5 read) and
  the gradient of each loss term within 1e-4 of its largest entry of
  JAX's own gradient in float64 (nearer to that than JAX's f32 gradient
  where JAX's is further: `_assert_step`); the eval-mode re-inference
  and encoder read the BN statistics from before the step's train
  forward, as JAX's do;
- a bf16 `mixed` step: gradients within twice JAX's own bf16-vs-f32
  deviation, and the loss terms on average over three weight draws.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ml_audio_restoration_tpu.audio.analyze import \
    detect_impulses_analytical as jdetect
from ml_audio_restoration_tpu.config import ArtifactConfig as JArtifactConfig
from ml_audio_restoration_tpu.config import TrainConfig as JTrainConfig
from ml_audio_restoration_tpu.data import artifacts as JA
from ml_audio_restoration_tpu.data.datasets import \
    AdaptiveArtifactDataset as JAdaptive
from ml_audio_restoration_tpu.data.datasets import \
    MixedRestorationDataset as JMixed
from ml_audio_restoration_tpu.data.datasets import \
    RestorationDataset as JRestorationDataset
from ml_audio_restoration_tpu.data.loader import DataLoader as JDataLoader
from ml_audio_restoration_tpu.losses import semi_supervised as JS
from ml_audio_restoration_tpu.train import trainer as JT
from ml_audio_restoration_tpu.train.trainer import Trainer as JTrainer
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.audio import (
    detect_impulses_analytical, load_audio, save_audio)
from ml_audio_restoration_torch.compat import state_dict_from_jax
from ml_audio_restoration_torch.config import ArtifactConfig, TrainConfig
from ml_audio_restoration_torch.config import load_config
from ml_audio_restoration_torch.data import (
    AdaptiveArtifactDataset, DataLoader, MixedRestorationDataset,
    RestorationDataset)
from ml_audio_restoration_torch.data import artifacts as PA
from ml_audio_restoration_torch.losses import semi_supervised as PS
from ml_audio_restoration_torch.train.trainer import Trainer, build_trainer
from test_torch_artifacts import _stack, clean_batch, jax_draws
from test_torch_models import jax_model, port_model
from test_torch_pipeline import SMALL

SR = 22050
LOSS_BAR = 1e-5
SIM_BAR = 1e-5
GRAD_BAR = 1e-4
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
STEP_BAR = 1e-4  # a step's loss, relative: the consistency loss's energy
#                  term squares a difference of sums over T of squares
B, T = 2, 2048
GAIN = 4.0
MASKS = {"synthetic": [1.0, 1.0, 1.0], "real": [0.0, 0.0, 0.0],
         "mixed": [1.0, 0.0, 1.0]}


# ------------------------------------------------------------------ losses
def _pair(seed=0, b=3, t=3000):
    rng = np.random.default_rng(seed)
    x = clean_batch(b, 1, t, seed).transpose(0, 2, 1) * GAIN  # [B, T, 1]
    y = x * 0.8 + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    return x, y.astype(np.float32)


def _close(got, want, bar=LOSS_BAR):
    np.testing.assert_allclose(float(got), float(want), rtol=bar,
                               atol=1e-12)


@pytest.mark.parametrize("mask", list(MASKS))
def test_semi_supervised_losses_match_jax(mask):
    """Each loss and the combination at a mask of all-synthetic, all-real
    and mixed items, the cycle's re-degradation and re-inference being
    fixed functions on both sides."""
    out, inp = _pair()
    tgt = _pair(1)[0]
    m = np.asarray(MASKS[mask], np.float32)
    noise = np.random.default_rng(2).standard_normal(out.shape).astype(
        np.float32) * 0.02
    j = {k: jnp.asarray(v) for k, v in (("o", out), ("i", inp), ("t", tgt),
                                         ("m", m), ("n", noise))}
    p = {k: torch.from_numpy(v) for k, v in (("o", out), ("i", inp),
                                              ("t", tgt), ("m", m),
                                              ("n", noise))}
    for jm, pm in ((j["m"], p["m"]), (None, None)):
        _close(PS.supervised_loss(p["o"], p["t"], pm),
               JS.supervised_loss(j["o"], j["t"], jm))
        _close(PS.consistency_loss(p["o"], p["i"], pm),
               JS.consistency_loss(j["o"], j["i"], jm))
        _close(PS.cycle_consistency_loss(
            p["o"], p["t"], lambda x: x + p["n"], lambda x: 0.9 * x, pm),
            JS.cycle_consistency_loss(
                j["o"], j["t"], lambda x: x + j["n"], lambda x: 0.9 * x,
                jm))
    total, parts = PS.semi_supervised_loss(
        p["o"], p["i"], p["t"], p["m"], model_fn=lambda x: 0.9 * x,
        redegrade_fn=lambda x: x + p["n"])
    jtotal, jparts = JS.semi_supervised_loss(
        j["o"], j["i"], j["t"], j["m"], model_fn=lambda x: 0.9 * x,
        redegrade_fn=lambda x: x + j["n"])
    assert set(parts) == set(jparts) == {"supervised", "consistency",
                                         "cycle", "total"}
    for k in parts:
        _close(parts[k], jparts[k])
    _close(total, jtotal)


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((4, 32)).astype(np.float32)
            for _ in range(2))
    for label in ([0.0] * 4, [1.0, 0.0, 1.0, 0.0]):
        lab = np.asarray(label, np.float32)
        _close(PS.contrastive_loss(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(lab)),
               JS.contrastive_loss(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(lab)))


def test_masked_branches_keep_their_shapes():
    """A mask of no synthetic items gives a zero supervised term, not a
    division by zero (denominator clamped at 1)."""
    out, inp = _pair()
    zero = torch.zeros(3)
    assert float(PS.supervised_loss(torch.from_numpy(out),
                                    torch.from_numpy(inp), zero)) == 0.0


# --------------------------------------------------------- the simulator
def _jax_item_draws_ov(key, c, t, cfg, max_pops, rate, amp_max, nl):
    """simulate_vinyl_artifacts' draws for one item under overrides
    (ml_audio_restoration_tpu/data/artifacts.py:181-225, _make_pops)."""
    (k_surf_lvl, k_surf, k_pops, k_crackle_lvl, k_crackle, k_rumble_lvl,
     k_rumble, k_rolloff) = jax.random.split(key, 8)
    k_n, k_loc, k_amp, k_pol, k_decay, k_freq = jax.random.split(k_pops, 6)
    f32 = jnp.float32
    rate, amp_max, nl = (jnp.asarray(v, f32) for v in (rate, amp_max, nl))
    lo = cfg.impulse_amplitude[0]
    amp_hi = jnp.clip(amp_max, lo + 1e-6, max(cfg.impulse_amplitude[1], 1.0))
    p = (max_pops,)
    return {
        "surface_level": jax.random.uniform(k_surf_lvl, (), f32) * nl
        + 0.5 * nl,
        "surface": jax.random.normal(k_surf, (c, t), f32),
        "pop_count": jax.random.poisson(
            k_n, jnp.asarray((t / SR) * rate, f32)),
        "pop_locs": jax.random.randint(k_loc, p, 0, t),
        "pop_amps": jax.random.uniform(k_amp, p, f32, lo, amp_hi),
        "pop_polarity": jnp.where(jax.random.uniform(k_pol, p) < 0.45,
                                  -1.0, 1.0).astype(f32),
        "pop_decay": jax.random.uniform(k_decay, p, f32, 0.001, 0.003),
        "pop_freq": jax.random.uniform(k_freq, p, f32, 3000.0, 8000.0),
        "crackle_level": jax.random.uniform(k_crackle_lvl, (), f32)
        * (0.5 * nl) + 0.3 * nl,
        "crackle": jax.random.normal(k_crackle, (c, t), f32),
        "rumble_level": jax.random.uniform(k_rumble_lvl, (), f32,
                                           *cfg.rumble_level),
        "rumble": jax.random.normal(k_rumble, (c, t), f32),
        "rolloff_freq": jax.random.uniform(k_rolloff, (), f32,
                                           *cfg.rolloff_freq),
    }


def jax_draws_ov(key, shape, overrides, cfg=None):
    """JAX's draws of simulate_batch(key, batch, overrides=...) vmapped
    per item (the degrade_adaptive derive), as the port's draw dict."""
    cfg = cfg or JArtifactConfig()
    b, c, t = shape
    max_pops = PA.max_pops_for(t, SR, cfg, PA.ADAPTIVE_RATE_BOUND)
    ov = [np.asarray(overrides[k], np.float32) for k in
          ("impulse_rate", "impulse_amplitude_max", "noise_level")]
    return _stack([_jax_item_draws_ov(k, c, t, cfg, max_pops,
                                      *(v[i] for v in ov))
                   for i, k in enumerate(jax.random.split(key, b))])


def _jax_adaptive(key, x, overrides, cfg=None):
    cfg = cfg or JArtifactConfig()
    keys = jax.random.split(key, x.shape[0])
    ov = {k: jnp.asarray(v, jnp.float32) for k, v in overrides.items()}
    return np.asarray(jax.vmap(
        lambda k, a, r, m, n: JA.simulate_vinyl_artifacts(
            k, a, SR, cfg, overrides={"impulse_rate": r,
                                      "impulse_amplitude_max": m,
                                      "noise_level": n}))(
        keys, jnp.asarray(x), ov["impulse_rate"],
        ov["impulse_amplitude_max"], ov["noise_level"]))


OVERRIDES = {
    "fitted": {"impulse_rate": [12.0, 40.0, 3.0],
               "impulse_amplitude_max": [0.4, 0.8, 0.2],
               "noise_level": [0.02, 0.05, 0.008]},
    # amplitude bounds past both clamp ends
    "clamped": {"impulse_rate": [50.0, 1.0, 25.0],
                "impulse_amplitude_max": [3.0, 0.01, 1.0],
                "noise_level": [0.1, 0.005, 0.03]}}


@pytest.mark.parametrize("case", list(OVERRIDES))
def test_apply_artifacts_with_overrides_matches_jax(case):
    ov = OVERRIDES[case]
    x = clean_batch(3, 1, 4001, seed=5)
    key = jax.random.PRNGKey(17)
    want = _jax_adaptive(key, x, ov)
    draws = jax_draws_ov(key, x.shape, ov)
    got = PA.apply_artifacts(torch.from_numpy(x), draws, SR)
    assert float(np.abs(got.numpy() - want).max()) <= SIM_BAR
    assert float(np.abs(want - x).max()) > 0.1


def test_draws_follow_the_overrides():
    """The 50/s pop bound, Poisson means at each item's rate, amplitudes
    under each item's clamped bound and noise levels in their ranges."""
    b, t = 64, 44100
    cfg = ArtifactConfig()
    ov = {"impulse_rate": torch.tensor([5.0, 45.0] * (b // 2)),
          "impulse_amplitude_max": torch.tensor([3.0, 0.01] * (b // 2)),
          "noise_level": torch.tensor([0.01, 0.08] * (b // 2))}
    d = PA.draw_artifacts(torch.Generator().manual_seed(1), (b, 1, t), SR,
                          cfg, overrides=ov)
    assert d["pop_locs"].shape == (b, 316)  # ceil(3 * 2 s * 50) + 16
    counts = d["pop_count"].float().view(-1, 2).mean(dim=0)
    assert 7 < float(counts[0]) < 13 and 80 < float(counts[1]) < 100
    amps = d["pop_amps"].view(-1, 2, 316)
    assert float(amps[:, 0].max()) <= 1.0 and float(amps[:, 0].max()) > 0.9
    assert float(amps[:, 1].max()) <= cfg.impulse_amplitude[0] + 1e-6
    n = ov["noise_level"]
    for key, lo, hi in (("surface_level", 0.5, 1.5),
                        ("crackle_level", 0.3, 0.8)):
        assert bool((d[key] >= lo * n - 1e-9).all()
                    and (d[key] <= hi * n + 1e-9).all()), key
    # without overrides the draws are the config's, as before
    plain = PA.draw_artifacts(torch.Generator().manual_seed(1), (2, 1, t),
                              SR, cfg)
    assert plain["pop_locs"].shape == (2, PA.max_pops_for(t, SR, cfg))


# ------------------------------------------------------------- analysis
def test_detect_impulses_analytical_equals_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 22050)) * 0.05).astype(np.float32)
    x[0, rng.integers(0, 22050, 40)] += 0.8
    for audio in (x, x[0], np.zeros((1, 500), np.float32)):
        got, want = (f(audio, SR) for f in (detect_impulses_analytical,
                                            jdetect))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


# ------------------------------------------------------------- datasets
CHUNK_S = 0.1


def _write(root, n, seed, degrade=False, length=5000):
    """Seeded mono WAVs; `degrade` runs the port's simulator over them
    (the 'real' recordings)."""
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        x = clean_batch(1, 1, length + 300 * i, seed + i)[0]
        if degrade:
            x = PA.simulate_batch(torch.Generator().manual_seed(seed + i),
                                  torch.from_numpy(x[None]), SR)[0].numpy()
        save_audio(root / f"r{i}.wav", x.astype(np.float32), SR,
                   subtype="FLOAT" if i % 2 else "PCM_16")
    return root


@pytest.fixture
def corpora(tmp_path):
    return (_write(tmp_path / "clean", 6, 100),
            _write(tmp_path / "real", 4, 200, degrade=True))


def _items_equal(a, b, n):
    for i in range(n):
        x, y = a[i], b[i]
        assert set(x) == set(y), i
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype


@pytest.mark.parametrize("contrastive", [False, True])
@pytest.mark.parametrize("with_real", [True, False])
def test_mixed_dataset_items_equal_jax(corpora, contrastive, with_real):
    clean, real = corpora
    kw = dict(sample_rate=SR, chunk_duration=CHUNK_S, synthetic_ratio=0.5,
              use_contrastive=contrastive, seed=9)
    args = (clean, real if with_real else None)
    ds, jds = MixedRestorationDataset(*args, **kw), JMixed(*args, **kw)
    assert ds.pairing == jds.pairing == "mixed"
    assert ds.num_synthetic == jds.num_synthetic
    assert ds.use_contrastive == jds.use_contrastive == (contrastive
                                                         and with_real)
    for _ in range(2):  # a second pass draws new chunks and pairs
        _items_equal(ds, jds, len(ds))


def test_adaptive_dataset_equals_jax(corpora):
    """The five-file analysis, the items, the per-epoch re-analysis and the
    item-counter re-analysis outside a trainer."""
    clean, real = corpora
    kw = dict(sample_rate=SR, chunk_duration=CHUNK_S, analyze_every=2,
              seed=4)
    ds, jds = (cls(clean, real, **kw) for cls in (AdaptiveArtifactDataset,
                                                  JAdaptive))
    assert ds.pairing == jds.pairing == "degrade_adaptive"
    assert ds.artifact_params == jds.artifact_params
    assert ds.artifact_params["impulse_rate"] != 10.0  # fitted, not default
    for _ in range(5):  # the counter re-analyses after 2 passes
        _items_equal(ds, jds, len(ds))
        assert ds.artifact_params == jds.artifact_params
    assert ds._counter == jds._counter
    for _ in range(3):
        ds.on_epoch_end()
        jds.on_epoch_end()
        _items_equal(ds, jds, len(ds))
        assert ds.artifact_params == jds.artifact_params


def test_degraded_dirs_take_wav_only(corpora, tmp_path):
    """(Named for the refusal it pinned before FLAC was ported.) Degraded
    directories of FLACs are read: 16-bit FLAC twins of 16-bit WAVs give
    the mixed and adaptive sets the same items and fitted statistics, equal
    to the JAX package's over the FLACs."""
    clean, real = corpora
    for path in sorted(real.glob("*.wav")):
        x, _ = load_audio(path, None, mono=False)
        for ext in ("wav", "flac"):
            save_audio(tmp_path / f"real_{ext}" / f"{path.stem}.{ext}", x, SR)
    kw = dict(sample_rate=SR, chunk_duration=CHUNK_S, seed=9)
    for cls, jcls, extra in ((MixedRestorationDataset, JMixed,
                              dict(synthetic_ratio=0.5,
                                   use_contrastive=True)),
                             (AdaptiveArtifactDataset, JAdaptive, {})):
        wav, flac, flac2 = (cls(clean, tmp_path / f"real_{ext}", **kw,
                                **extra) for ext in ("wav", "flac", "flac"))
        jflac = jcls(clean, tmp_path / "real_flac", **kw, **extra)
        assert all(p.suffix == ".flac" for p in flac.degraded_files)
        assert (getattr(flac, "artifact_params", None)
                == getattr(wav, "artifact_params", None))
        _items_equal(flac, wav, len(flac))
        _items_equal(jflac, flac2, len(flac))
    with pytest.raises(ValueError, match="No reference recordings"):
        AdaptiveArtifactDataset(clean, clean / "missing")


def _batches(loader):
    return list(loader)


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_batches_equal_jax_for_each_worker_count(corpora, workers):
    """The batch read route (rows spread over the workers once the starts
    are drawn) and the per-item route of the mixed set, each equal to the
    JAX loader's batches at the same worker count."""
    clean, real = corpora
    for make in (lambda m: m[0](clean, SR, CHUNK_S, seed=3),
                 lambda m: m[1](clean, real, SR, CHUNK_S, seed=3,
                                use_contrastive=True)):
        ds = make((RestorationDataset, MixedRestorationDataset))
        jds = make((JRestorationDataset, JMixed))
        got = _batches(DataLoader(ds, 2, seed=1, num_workers=workers))
        want = _batches(JDataLoader(jds, 2, seed=1, num_workers=workers))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


# ------------------------------------------------------------ the steps
def _weights(seed=0):
    return jax_model("denoiser", seed, np.random.default_rng(seed),
                     **SMALL["denoiser"])[1]


class _Toy:
    def __init__(self, batch, pairing):
        self.batch, self.pairing = batch, pairing

    def __len__(self):
        return B

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.batch.items()}


def _mixed_batch(contrastive):
    audio = clean_batch(B, 1, T, seed=6) * GAIN
    batch = {"audio": audio, "is_synthetic": np.asarray([1.0, 0.0],
                                                        np.float32)}
    if contrastive:
        batch.update({
            "contrastive_pair": clean_batch(B, 1, T, seed=7) * GAIN,
            "contrastive_pair_is_synthetic": np.asarray([0.0, 1.0],
                                                        np.float32),
            "contrastive_label": np.zeros(B, np.float32)})
    return batch


def _adaptive_batch():
    return {"clean": clean_batch(B, 1, T, seed=8) * GAIN,
            "impulse_rate": np.asarray([20.0, 45.0], np.float32),
            "impulse_amplitude_max": np.asarray([0.6, 1.4], np.float32),
            "noise_level": np.asarray([0.03, 0.01], np.float32)}


def _jax_grads(jtr, terms, *args):
    """(gradients {term: {name: f32 numpy}} of each loss term, (total,
    parts, new state, output)) of JAX's `_loss` at `args`, one backward
    pass a term."""
    def f(*a):
        total, (parts, jstate, out) = jtr._loss(*a, True)
        return {k: parts[k] for k in terms}, (total, parts, jstate, out)

    grads, aux = jax.jit(jax.jacrev(f, has_aux=True))(*args)
    state = args[1]
    return {k: {n: v.numpy() for n, v in
                state_dict_from_jax("denoiser", g, state).items()
                if not n.endswith(BUFFERS)}
            for k, g in grads.items()}, aux


def _jax_step(jtr, terms, params, state, inputs, targets, jb, k_loss):
    """JAX's loss, parts, gradients of each term, new BN statistics and
    output of one train step."""
    grads, (loss, parts, jstate, out) = _jax_grads(
        jtr, terms, params, state, inputs, targets, jb, k_loss)
    return (float(loss), {k: float(v) for k, v in parts.items()}, grads,
            jstate, out)


def _jax_f64_grads(monkeypatch, jtr, terms, params, state, inputs, targets,
                   jb, k_loss, out):
    """JAX's own gradients of the same step in float64: `_loss` under x64,
    the JAX package's f32 casts on the step's way (the BN statistics, the
    output's cast before the loss) made float64 for the call by patching
    `jnp.float32`, and its degradations (the cycle's re-degradation and
    the pair's, through which no gradient flows) fed in as the f32 step
    computed them on the same draws."""
    k_cycle, k_pair = jax.random.split(k_loss)
    fed = []  # in `_loss`'s order of calls
    if jtr.pairing == "mixed":
        fed.append(JA.simulate_batch(k_cycle, jnp.transpose(out, (0, 2, 1)),
                                     jtr.sample_rate, jtr.artifact_cfg))
    if "contrastive_pair" in jb:
        fed.append(JA.simulate_batch(k_pair, jb["contrastive_pair"],
                                     jtr.sample_rate, jtr.artifact_cfg))
    fed = [np.asarray(d, np.float64) for d in fed]

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      tree)

    with jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(jnp, "float32", jnp.float64)
        m.setattr(JT, "simulate_batch", lambda *a: jnp.asarray(fed.pop(0)))
        m.setattr(jtr, "compute_dtype", jnp.dtype(jnp.float64))
        grads, _ = _jax_grads(jtr, terms, f64(params), f64(state),
                              f64(inputs), f64(targets), f64(jb), k_loss)
    assert not fed
    assert all(g.dtype == np.float64 for t in grads.values()
               for g in t.values())
    return grads


def _port_grads(model, loss, parts, terms):
    """{term: {name: numpy}}: the gradient of each loss term, one backward
    pass a term."""
    named = dict(model.named_parameters())
    out = {}
    for k in terms:
        gs = torch.autograd.grad(parts[k], list(named.values()),
                                 retain_graph=True, allow_unused=True)
        out[k] = {n: (torch.zeros_like(p) if g is None else g).numpy()
                  for (n, p), g in zip(named.items(), gs)}
    return out


def _steps(pairing, batch, monkeypatch, dtype="float32", seed=0,
           terms=("total",), **cfg):
    """One train step of JAX's and the port's trainer at `dtype` on JAX's
    draws (the derive's from k_data, then (mixed) the cycle's from k_cycle
    and the pair's from k_pair), with the gradient of each loss term in
    `terms`. Besides: at float32, JAX's gradients in float64
    (`_jax_f64_grads`); at bfloat16, JAX's float32 step on the same
    inputs."""
    params, state = _weights(seed)
    key = jax.random.PRNGKey(5)
    k_data, k_loss = jax.random.split(key)
    k_cycle, k_pair = jax.random.split(k_loss)
    loader = JDataLoader(_Toy(batch, pairing), batch_size=B, num_workers=1,
                         seed=0)

    def jax_trainer(dt):
        return JTrainer("denoiser", params, state, loader, None,
                        config=JTrainConfig(model="denoiser",
                                            learning_rate=1e-3,
                                            compute_dtype=dt, **cfg),
                        pairing=pairing)

    jtr = jax_trainer(dtype)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    inputs, targets = jtr._derive(jb, k_data)
    jloss, jparts, want, jstate, jout = _jax_step(
        jtr, terms, params, state, inputs, targets, jb, k_loss)
    r = {"jloss": jloss, "jparts": jparts, "want": want,
         "jstats": state_dict_from_jax("denoiser", params, jstate)}
    if dtype == "float32":
        r["j64"] = _jax_f64_grads(monkeypatch, jtr, terms, params, state,
                                  inputs, targets, jb, k_loss, jout)
    else:
        r["jloss32"], r["jparts32"], r["want32"], _, _ = _jax_step(
            jax_trainer("float32"), terms, params, state, inputs, targets,
            jb, k_loss)

    keys = [k_data, k_cycle, k_pair]

    def draws(g, shape, sr, cfg=None, **kw):
        k = keys.pop(0)
        if kw.get("overrides"):
            return jax_draws_ov(k, shape, {n: v.numpy() for n, v in
                                           kw["overrides"].items()})
        return jax_draws(k, shape, sr)

    monkeypatch.setattr(PA, "draw_artifacts", draws)

    def trainer(model_dtype, compute_dtype):
        model = port_model("denoiser", params, state).to(model_dtype)
        return Trainer("denoiser", model.train(), [],
                       config=TrainConfig(model="denoiser",
                                          learning_rate=1e-3,
                                          compute_dtype=compute_dtype,
                                          **cfg),
                       pairing=pairing, device="cpu")

    tr = trainer(torch.float32, dtype)
    gen = torch.Generator()
    tin, ttg = tr._derive(batch, gen)
    np.testing.assert_allclose(tin.numpy(), np.asarray(inputs), atol=SIM_BAR)
    loss, (parts, _) = tr._loss(tin, ttg, None, batch, gen)
    # JAX's draws, in its order: the derive's, the cycle's, the pair's
    used = (1 if pairing != "mixed" else
            3 if "contrastive_pair" in batch else 2)
    assert len(keys) == 3 - used
    r.update(loss=float(loss.detach()),
             parts={k: float(v.detach()) for k, v in parts.items()},
             got=_port_grads(tr.model, loss, parts, terms),
             stats=tr.model.state_dict())
    return r


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_step(r):
    """The loss and its parts within STEP_BAR of JAX's. Each term's
    gradient, on the scale of the largest entry of JAX's float64 gradient
    of that term (on the total's scale the consistency energy term's
    gradient, the largest by far, would hide the others): the port's within
    GRAD_BAR of JAX's float64 gradient. Where JAX's own f32 gradient of a
    parameter lies further than GRAD_BAR from its float64 one, the port's
    lies nearer to that than JAX's. Read: the consistency energy term
    squares a difference of two sums of ~250 over T, so JAX's f32
    first-layer gradients of it and of the total part from float64 by up to
    9.2e-4 (encoder.0.0/0.3/1.0 weights), the port's by 8.8e-6; JAX's of
    the cycle term by 2.0e-4, the port's by 2.1e-5; the contrastive term's
    gradient is ~1e-5 (its cosine similarities sit near 1), and JAX's f32
    parts from float64 by 2.5e-2 of it, the port's by 7.8e-3."""
    assert set(r["parts"]) == set(r["jparts"])
    for k in r["parts"]:
        _close(r["parts"][k], r["jparts"][k], STEP_BAR)
    _close(r["loss"], r["jloss"], STEP_BAR)
    assert set(r["got"]) == set(r["j64"])
    for term, j64 in r["j64"].items():
        got, want = r["got"][term], r["want"][term]
        scale = max(np.abs(w).max() for w in j64.values())
        assert scale > 0, term
        bar = GRAD_BAR * scale
        for name in j64:
            msg = f"{term}: {name}"
            drift = np.abs(want[name] - j64[name]).max()
            port = np.abs(got[name] - j64[name]).max()
            if drift <= bar:
                assert port <= bar, (msg, port / scale)
            else:
                assert port < drift, (msg, port / scale, drift / scale)
    for k, v in r["stats"].items():
        if k.endswith(BUFFERS[:2]):
            np.testing.assert_allclose(v.numpy(), r["jstats"][k].numpy(),
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("contrastive", [0.0, 0.5])
def test_mixed_step_matches_jax(monkeypatch, contrastive):
    """Supervised and consistency terms, cycle consistency through a
    re-degradation and an eval-mode re-inference on the pre-step BN
    statistics, and (weight 0.5) the contrastive term through encode."""
    terms = ["total", "supervised", "consistency", "cycle"] + (
        ["contrastive"] if contrastive > 0 else [])
    result = _steps("mixed", _mixed_batch(contrastive > 0), monkeypatch,
                    terms=terms, contrastive_weight=contrastive)
    assert ("contrastive" in result["parts"]) == (contrastive > 0)
    assert "cycle" in result["parts"]
    _assert_step(result)


@pytest.mark.parametrize("contrastive", [0.0, 0.5])
def test_bf16_mixed_step_matches_jax(monkeypatch, contrastive):
    """The `mixed` step at compute_dtype bfloat16, where the re-inference
    and (weight 0.5) both encoder passes run on the step's one bf16 cast
    with the f32 pre-step BN statistics, over three weight draws: each
    draw's gradients (relative L2 over all parameters) within twice JAX's
    own bf16-vs-f32 deviation at the same inputs and draws, and the loss
    and each of its parts on average too. The scalars are averaged as in
    test_torch_bf16_train.py: the consistency energy term squares a
    difference of two sums of squares over T, so one draw's loss moves
    with the bf16 output's rounding (read, seed 0: port 1.55 from JAX's
    bf16 loss, JAX's bf16 0.33 from its f32; seed 1: 1.73 and 7.27), while
    the outputs lie as far from f32 on both sides (relative L2 0.0388 and
    0.0394)."""
    dev = {}
    for seed in range(3):
        r = _steps("mixed", _mixed_batch(contrastive > 0), monkeypatch,
                   "bfloat16", seed=seed, contrastive_weight=contrastive)
        names = list(r["got"]["total"])
        got, j16, j32 = (np.concatenate([g["total"][n].astype(np.float64)
                                         .ravel() for n in names])
                         for g in (r["got"], r["want"], r["want32"]))
        assert _rel_l2(got, j16) <= 2 * _rel_l2(j16, j32), seed
        assert set(r["parts"]) == set(r["jparts"])
        for k in r["parts"]:
            port, jax_ = dev.setdefault(k, ([], []))
            port.append(abs(r["parts"][k] - r["jparts"][k]))
            jax_.append(abs(r["jparts"][k] - r["jparts32"][k]))
        monkeypatch.undo()
    assert ("contrastive" in dev) == (contrastive > 0)
    for k, (port, jax_) in dev.items():
        assert np.mean(port) <= 2 * np.mean(jax_), (k, port, jax_)


def test_adaptive_step_matches_jax(monkeypatch):
    """The per-item overrides in the derive; the loss is restoration_loss
    on its smooth terms (test_torch_convnet_train.py's SMOOTH: the
    log-magnitude spectral term's gradient moves with any f32 change)."""
    _assert_step(_steps("degrade_adaptive", _adaptive_batch(), monkeypatch,
                        spectral_weight=0.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_step_reads_pre_step_statistics(dtype):
    """The eval forwards inside the step (the re-inference and both
    encoder passes) run in eval mode on the statistics the step started
    from, which the train forward has since moved; in f32 whatever the
    compute dtype, beside the step's one cast of the parameters."""
    params, state = _weights()
    tr = Trainer("denoiser", port_model("denoiser", params, state), [],
                 config=TrainConfig(model="denoiser", contrastive_weight=0.5,
                                    compute_dtype=dtype),
                 pairing="mixed", device="cpu")
    before = {n: b.clone() for n, b in tr.model.named_buffers()}
    seen = []
    forward = tr._forward

    def spy(inputs, params=None, *, buffers=None, module=None):
        seen.append((tr.model.training, params,
                     None if buffers is None else
                     {n: b.clone() for n, b in buffers.items()}))
        return forward(inputs, params, buffers=buffers, module=module)

    tr._forward = spy
    tr._train_step(_mixed_batch(True), torch.Generator().manual_seed(0))
    assert [s[0] for s in seen] == [True, False, False, False]
    assert tr.model.training
    cast = seen[0][1]  # None: the live f32 parameters
    assert (cast is None if dtype == "float32" else
            all(v.dtype == torch.bfloat16 for v in cast.values()))
    for _, params_seen, bufs in seen[1:]:
        assert params_seen is cast
        assert bufs.keys() == before.keys()
        assert all(torch.equal(bufs[n], before[n]) for n in before)
    means = [n for n in before if n.endswith("running_mean")]
    assert len(means) == 10 and all(
        not torch.equal(tr.model.get_buffer(n), before[n]) for n in means)


# ------------------------------------------------------- entry points
def _small_yaml(path):
    path.write_text(yaml.safe_dump({
        "denoiser": {"features": list(SMALL["denoiser"]["features"])},
        "data": {"val_split": 0.25, "synthetic_ratio": 0.5}}))
    return path


@pytest.mark.parametrize("kind", ["mixed", "adaptive"])
def test_build_trainer_takes_the_dataset_kinds(corpora, tmp_path, kind):
    clean, real = corpora
    cfg = load_config(_small_yaml(tmp_path / "s.yaml"), {
        "train": {"model": "denoiser", "batch_size": 2, "num_epochs": 1,
                  "checkpoint_dir": str(tmp_path / "ck"),
                  "log_dir": str(tmp_path / "runs")},
        "data": {"data_dir": str(clean), "degraded_dir": str(real),
                 "chunk_duration": CHUNK_S}})
    tr = build_trainer(cfg, steps_per_epoch=1, device="cpu",
                       dataset_kind=kind)
    ds = tr.train_loader.dataset
    want = {"mixed": (MixedRestorationDataset, "mixed"),
            "adaptive": (AdaptiveArtifactDataset, "degrade_adaptive")}[kind]
    assert isinstance(ds, want[0]) and tr.pairing == want[1]
    history = tr.train()
    assert all(np.isfinite(history["train_loss"] + history["val_loss"]))
    if kind == "adaptive":
        assert ds._hook_used and ds._epoch == 1  # on_epoch_end fired


@pytest.mark.parametrize("flag", ["--mixed", "--adaptive"])
def test_cli_train_semi_supervised_on_cpu(corpora, tmp_path, flag):
    clean, real = corpora
    args = ["train", "denoiser", "--data-dir", str(clean), flag,
            "--degraded-dir", str(real), "--steps-per-epoch", "1",
            "--num-epochs", "1", "--chunk-duration", str(CHUNK_S),
            "--batch-size", "2", "--checkpoint-dir", str(tmp_path / "ck"),
            "--config", str(_small_yaml(tmp_path / "s.yaml")),
            "--device", "cpu"]
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the default log dir is relative
    try:
        assert cli.main(args) == 0
    finally:
        os.chdir(cwd)
    assert (tmp_path / "ck" / "denoiser" / "best_model.pth").exists()

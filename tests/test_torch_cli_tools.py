"""The port's CLI tools against the JAX package's: `export` (bit for bit,
and its error exits), `analyze` (the same statistics on a FLAC), and the
no-op flags `restore --no-packed-convs` and `stream --lstm-impl`, which a
JAX command line passes."""
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu import cli as jcli
from ml_audio_restoration_tpu.audio.analyze import \
    analyze_78rpm_recording as janalyze
from ml_audio_restoration_tpu.compat.torch_saver import save_pth as jsave_pth
from ml_audio_restoration_tpu.train import checkpoints as jckpt
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.audio import (
    analyze, detect_impulses_analytical, load_audio, save_audio)
from ml_audio_restoration_torch.compat import (
    load_pth, model_from_state_dict, save_pth, state_dict_from_jax)
from ml_audio_restoration_torch.data.artifacts import simulate_vinyl_artifacts
from ml_audio_restoration_torch.train import checkpoints as ckpt
from test_torch_models import jax_model
from test_torch_pipeline import SMALL


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The denoiser at narrow width as a JAX .msgpack with and without EMA
    weights, an upstream .pth and a port trainer checkpoint."""
    root = tmp_path_factory.mktemp("export")
    _, (params, state) = jax_model("denoiser", 0, np.random.default_rng(1),
                                   **SMALL["denoiser"])
    ema = {k: v for k, v in params.items()}
    ema["final_conv"] = {"w": np.asarray(params["final_conv"]["w"]) * 0.5,
                         "b": np.asarray(params["final_conv"]["b"]) + 1.0}
    base = {"params": params, "model_state": state, "epoch": np.asarray(7),
            "model_name": "denoiser"}
    jckpt.save_checkpoint(root / "ema.msgpack", {**base, "ema_params": ema})
    jckpt.save_checkpoint(root / "plain.msgpack", base)
    jsave_pth(root / "upstream.pth", "denoiser", params, state, epoch=5)
    model = model_from_state_dict("denoiser",
                                  state_dict_from_jax("denoiser", params,
                                                      state))
    ema_sd = {n: p.detach() * 0.5 for n, p in model.named_parameters()}
    port = {"model_state_dict": model.state_dict(), "epoch": 4,
            "model_name": "denoiser", "ema_params": ema_sd}
    ckpt.save_checkpoint(root / "port.pth", port)
    ckpt.save_checkpoint(root / "port_no_ema.pth",
                         {k: v for k, v in port.items() if k != "ema_params"})
    return root, model, ema_sd


@pytest.mark.parametrize("src,flags", [("plain.msgpack", []),
                                       ("ema.msgpack", ["--ema"]),
                                       ("ema.msgpack", []),
                                       ("upstream.pth", ["--model",
                                                         "denoiser"])])
def test_export_equals_jax_bit_for_bit(sources, tmp_path, src, flags):
    root = sources[0]
    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        (tmp_path / pkg).mkdir()
        assert main(["export", str(root / src),
                     str(tmp_path / pkg / "out.pth"), *flags]) == 0
    assert ((tmp_path / "port" / "out.pth").read_bytes()
            == (tmp_path / "jax" / "out.pth").read_bytes())


@pytest.mark.parametrize("ema", [False, True])
def test_export_port_checkpoint(sources, tmp_path, ema):
    """The port's trainer .pth is self-describing; --ema takes its
    ema_params. The file loads strict into the upstream model, equal to
    its source (num_batches_tracked 0, as the JAX exporter writes)."""
    root, model, ema_sd = sources
    out = tmp_path / "out.pth"
    assert cli.main(["export", str(root / "port.pth"), str(out)]
                    + (["--ema"] if ema else [])) == 0
    saved = torch.load(out, weights_only=True)
    assert set(saved) == {"epoch", "model_state_dict"} and saved["epoch"] == 4
    back = model_from_state_dict("denoiser", saved["model_state_dict"])
    for k, v in model.state_dict().items():
        want = ema_sd[k] if ema and k in ema_sd else v
        if k.endswith("num_batches_tracked"):
            want = torch.zeros_like(v)
        assert torch.equal(back.state_dict()[k], want), k
    assert list(load_pth(out)) == list(model.state_dict())


@pytest.mark.parametrize("src,flags", [
    ("upstream.pth", []),
    ("upstream.pth", ["--model", "denoiser", "--ema"]),
    ("plain.msgpack", ["--model", "stereo_separator"]),
    ("plain.msgpack", ["--ema"])])
def test_export_error_exits_equal_jax(sources, tmp_path, capsys, src,
                                      flags):
    root = sources[0]
    outs = []
    for main in (jcli.main, cli.main):
        rc = main(["export", str(root / src), str(tmp_path / "x.pth"),
                   *flags])
        outs.append((rc, capsys.readouterr().err))
    assert outs[1] == outs[0] and outs[0][0] == 2
    assert not (tmp_path / "x.pth").exists()


def test_export_port_checkpoint_errors(sources, tmp_path, capsys):
    root = sources[0]
    assert cli.main(["export", str(root / "port_no_ema.pth"),
                     str(tmp_path / "x.pth"), "--ema"]) == 2
    assert "carries no ema_params" in capsys.readouterr().err
    assert cli.main(["export", str(root / "port.pth"),
                     str(tmp_path / "x.pth"), "--model", "stereo_separator"]
                    ) == 2
    assert "not 'stereo_separator'" in capsys.readouterr().err


@pytest.fixture(scope="module")
def crackly(tmp_path_factory):
    """2 s of a tone with 80 clicks, as 16-bit FLAC at 22.05 kHz: the
    clicks hold the top 0.5% of the second difference, so the impulses
    are the clicks and background windows are found quickly."""
    rng = np.random.default_rng(8)
    x = 0.2 * np.sin(2 * np.pi * 330 * np.arange(44100) / 22050)
    x[rng.choice(44100, 80, replace=False)] += rng.uniform(-0.6, 0.6, 80)
    path = tmp_path_factory.mktemp("analyze") / "rec.flac"
    save_audio(path, x[None].astype(np.float32), 22050)
    return path


def test_analyze_equals_jax(crackly, capsys):
    got = analyze.analyze_78rpm_recording(crackly)
    want = janalyze(crackly)
    assert got["impulse_stats"] == want["impulse_stats"]
    assert got["impulse_stats"]["num_impulses"] >= 60
    assert got["duration"] == want["duration"]
    np.testing.assert_array_equal(got["peaks"], want["peaks"])
    np.testing.assert_array_equal(got["amplitudes"], want["amplitudes"])
    assert set(got["frequency_analysis"]) == set(want["frequency_analysis"])
    for k, v in want["frequency_analysis"].items():
        np.testing.assert_array_equal(got["frequency_analysis"][k], v)
    port_text = capsys.readouterr().out.split("\nAnalyzing")[1]
    assert cli.main(["analyze", str(crackly)]) == 0
    assert capsys.readouterr().out == "\nAnalyzing" + port_text


def test_compare_synthetic_vs_real_on_the_cpu(crackly):
    clean, _ = load_audio(crackly, 22050)
    out = analyze.compare_synthetic_vs_real(crackly, clean, seed=3,
                                            device="cpu")
    synthetic = simulate_vinyl_artifacts(torch.Generator().manual_seed(3),
                                         torch.from_numpy(clean), 22050)
    assert out["synthetic"] == detect_impulses_analytical(
        synthetic.numpy(), 22050)[2]
    assert out["real"]["impulse_stats"] == janalyze(crackly)[
        "impulse_stats"]


def test_noop_flags_parse(sources, tmp_path):
    """A JAX command line with --no-packed-convs (restore) or --lstm-impl
    (stream) runs in the port."""
    root = sources[0]
    dn = save_pth(tmp_path / "d.pth", "denoiser",
                  load_pth(root / "upstream.pth"))
    audio = (0.2 * np.random.default_rng(0).normal(size=(1, 3000))).astype(
        np.float32)
    save_audio(tmp_path / "in.flac", audio, 22050)
    assert cli.main(["restore", str(tmp_path / "in.flac"),
                     str(tmp_path / "out.flac"), "--denoiser", str(dn),
                     "--no-super-res", "--no-stereo", "--no-packed-convs",
                     "--device", "cpu"]) == 0
    out, rate = load_audio(tmp_path / "out.flac", None, mono=False)
    assert out.shape == (1, 3000) and rate == 22050
    assert cli.main(["stream", str(tmp_path / "in.flac"), "--denoiser",
                     str(dn), "--no-super-res", "--no-stereo",
                     "--lstm-impl", "scan", "--output-dir",
                     str(tmp_path / "streamed"), "--device", "cpu"]) == 0
    assert (tmp_path / "streamed" / "in_restored.wav").exists()

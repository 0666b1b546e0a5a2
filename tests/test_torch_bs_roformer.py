"""BS-RoFormer (models/bs_roformer.py) and the restore path's enhancer
stage, on the CPU at tiny widths, against the plain reference in
`tests/plain_bs_roformer.py` (plain torch, band by band, the attention
scores written out, torch.stft / torch.istft): the model within 1e-5 of
the reference's peak in float32 (what separates float32 orderings at
these sizes; one rounding of the inputs moves the output ~1e-7), the
grouped band layers against a loop over the bands, RoPE, the state
dict's names, the stage in `restore` and `restore_many`, its spans, its
loading from a state dict and a YAML, and the paths that refuse it.
The JAX package has no counterpart."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_bs_roformer as plain
from ml_audio_restoration_torch import PipelineConfig, RestorationPipeline
from ml_audio_restoration_torch.models import (
    AudioDenoiser, AudioSuperResolution, BSRoformer, StereoSeparator,
    init_params)
from ml_audio_restoration_torch.models import bs_roformer as BR
from ml_audio_restoration_torch.ops import attention as A
from ml_audio_restoration_torch.ops import bands as B
from ml_audio_restoration_torch.ops import num_chunks, overlap_add
from ml_audio_restoration_torch.pipeline import StreamingRestorer, load_stage
from ml_audio_restoration_torch.utils import profiling as P

TOL = 1e-5
RATE = 22050
CHUNK, OVERLAP = 1000, 100
HOP = CHUNK - OVERLAP
# bands of 2, 4, 7 and 8 bins over n_fft 64's 33: four runs of widths
WIDTHS = dict(stereo=True, dim_head=16, heads=2,
              freqs_per_bands=(2, 2, 2, 4, 4, 4, 7, 8),
              stft_n_fft=64, stft_hop_length=10, stft_win_length=64,
              stft_normalized=False)
# the ep_317 configuration's model group
EP_317 = dict(depth=12, stereo=True, num_stems=1, time_transformer_depth=1,
              freq_transformer_depth=1, dim_head=64, heads=8,
              freqs_per_bands=(2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8
              + (48,) * 8 + (128, 129), mask_estimator_depth=2,
              stft_n_fft=2048, stft_hop_length=441, stft_win_length=2048,
              stft_normalized=False)


def _seed(model, seed=0):
    """Linear weights and biases U(+-0.3), RMSNorm gammas U(0.5, 1.5)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            u = torch.rand(p.shape, generator=gen)
            if name.endswith("gamma"):
                p.copy_(u + 0.5)
            elif not name.endswith("freqs"):
                p.copy_((u * 2 - 1) * 0.3)
    return model.eval()


def _model(seed=0, **kw):
    widths = dict(WIDTHS, **kw)
    return _seed(BSRoformer(32, depth=2, time_transformer_depth=1,
                            freq_transformer_depth=1, **widths), seed), widths


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("kw", [
    dict(stereo=True),
    dict(stereo=False, stft_hop_length=16, stft_normalized=True),
    dict(stereo=True, num_stems=2, stft_win_length=48),
    dict(stereo=False, mask_estimator_depth=3),
], ids=["stereo", "mono_normalized", "two_stems_short_window",
        "deep_mask"])
def test_model_matches_plain(kw):
    model, widths = _model(**kw)
    s = 2 if widths["stereo"] else 1
    x = torch.randn(3, s, 397, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = model(x)
    want = plain.forward(model.state_dict(), x, dict(widths, **kw))
    assert got.shape == want.shape
    assert _gap(got, want) < TOL


def test_grouped_band_layers_match_a_loop_over_bands():
    model, _ = _model()
    split, est = model.band_split, model.mask_estimators[0]
    widths = [2 * f * 2 for f in WIDTHS["freqs_per_bands"]]
    x = torch.randn(50, sum(widths))
    with torch.inference_mode():
        want = torch.stack([net(part) for net, part in zip(
            split.to_features, x.split(widths, dim=-1))], dim=1)
        got = split(x)
        assert [r[1:] for r in split.runs] == [(3, 8), (3, 16), (1, 28),
                                               (1, 32)]
        assert _gap(got, want) < TOL
        want = torch.cat([f(got[:, j]) for j, f in enumerate(est.to_freqs)],
                         dim=-1)
        assert _gap(est(got), want) < TOL


def test_runs_keep_band_order():
    assert B.runs([8, 8, 16, 8, 8]) == [(0, 2, 8), (2, 1, 16), (3, 2, 8)]


def test_rope_freqs_are_theta_10000():
    """rotary_embedding_torch's freqs, written out: 10000 ** (-2j / 64),
    j = 0..31."""
    want = [10000.0 ** (-2 * j / 64) for j in range(32)]
    freqs = BR.RotaryEmbedding(64).freqs
    assert not freqs.requires_grad
    np.testing.assert_allclose(freqs.numpy(), want, rtol=1e-6)
    assert torch.equal(plain.rope_freqs(64), freqs)


def test_plain_reference_makes_its_own_rope():
    """A program whose RoPE is built at another theta falls out of the
    plain comparison: the reference reads no `freqs` of the state dict."""
    model, widths = _model()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BR.RotaryEmbedding):
                m.freqs.copy_(BR.RotaryEmbedding(m.freqs.numel() * 2,
                                                 theta=1e5).freqs)
    x = torch.randn(2, 2, 397, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = model(x)
    assert _gap(got, plain.forward(model.state_dict(), x, widths)) > 100 * TOL


def test_rope_identity_at_zero_and_interleaved_pairs():
    freqs = BR.RotaryEmbedding(8).freqs
    table = A.rope_table(freqs, 5)
    x = torch.randn(5, 8)
    y = A.rope(x, table)
    assert torch.equal(y[0], x[0])
    # position 3, pair j = channels (2j, 2j + 1), rotated by 3 * freqs[j]
    for j in range(4):
        a = 3 * freqs[j]
        c, s = torch.cos(a), torch.sin(a)
        x0, x1 = x[3, 2 * j], x[3, 2 * j + 1]
        assert torch.allclose(y[3, 2 * j:2 * j + 2],
                              torch.stack([x0 * c - x1 * s, x1 * c + x0 * s]),
                              atol=1e-6)


def test_fused_attention_call_matches_plain():
    """The card's call (F.scaled_dot_product_attention, default scale) on
    the CPU against the written-out scores."""
    q, k, v = torch.randn(3, 6, 2, 9, 16).unbind(0)
    got = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    assert _gap(got, A.attention_plain(q, k, v)) < TOL


KEYS = """layers.0.0.layers.0.0.rotary_embed.freqs
layers.0.0.layers.0.0.norm.gamma
layers.0.0.layers.0.0.to_qkv.weight
layers.0.0.layers.0.0.to_gates.weight
layers.0.0.layers.0.0.to_gates.bias
layers.0.0.layers.0.0.to_out.0.weight
layers.0.0.layers.0.1.net.0.gamma
layers.0.0.layers.0.1.net.1.weight
layers.0.0.layers.0.1.net.1.bias
layers.0.0.layers.0.1.net.4.weight
layers.0.0.layers.0.1.net.4.bias
layers.0.1.layers.0.0.rotary_embed.freqs
layers.0.1.layers.0.0.norm.gamma
layers.0.1.layers.0.0.to_qkv.weight
layers.0.1.layers.0.0.to_gates.weight
layers.0.1.layers.0.0.to_gates.bias
layers.0.1.layers.0.0.to_out.0.weight
layers.0.1.layers.0.1.net.0.gamma
layers.0.1.layers.0.1.net.1.weight
layers.0.1.layers.0.1.net.1.bias
layers.0.1.layers.0.1.net.4.weight
layers.0.1.layers.0.1.net.4.bias
final_norm.gamma
band_split.to_features.0.0.gamma
band_split.to_features.0.1.weight
band_split.to_features.0.1.bias
band_split.to_features.1.0.gamma
band_split.to_features.1.1.weight
band_split.to_features.1.1.bias
mask_estimators.0.to_freqs.0.0.0.weight
mask_estimators.0.to_freqs.0.0.0.bias
mask_estimators.0.to_freqs.0.0.2.weight
mask_estimators.0.to_freqs.0.0.2.bias
mask_estimators.0.to_freqs.1.0.0.weight
mask_estimators.0.to_freqs.1.0.0.bias
mask_estimators.0.to_freqs.1.0.2.weight
mask_estimators.0.to_freqs.1.0.2.bias""".split()


def test_state_dict_names_are_lucidrains():
    model = BSRoformer(16, depth=1, time_transformer_depth=1,
                       freq_transformer_depth=1, freqs_per_bands=(2, 3),
                       dim_head=8, heads=2, stft_n_fft=8, stft_hop_length=2,
                       stft_win_length=8)
    assert list(model.state_dict()) == KEYS


def test_ep_317_widths():
    """The published configuration's parameters (built on the meta device):
    ~160 M, in lucidrains's shapes."""
    with torch.device("meta"):
        model = BSRoformer(512, **EP_317)
    sd = model.state_dict()
    assert sum(p.numel() for p in model.parameters()) == 159_758_092
    assert len(sd) == 12 * 2 * 11 + 1 + 62 * 3 + 62 * 4
    assert sd["layers.11.1.layers.0.0.to_qkv.weight"].shape == (1536, 512)
    assert sd["layers.0.0.layers.0.1.net.1.weight"].shape == (2048, 512)
    assert sd["band_split.to_features.61.1.weight"].shape == (512, 516)
    assert sd["mask_estimators.0.to_freqs.0.0.2.weight"].shape == (16, 2048)
    assert model.num_tokens(2, 352_800) == 2 * 801 * 62


def _pipe(enhancer, stages=(None, None, None), **cfg):
    return RestorationPipeline(*stages, device="cpu", enhancer=enhancer,
                               config=PipelineConfig(
                                   chunk_seconds=CHUNK / RATE,
                                   overlap_seconds=OVERLAP / RATE, **cfg))


def _plain_chain(model, widths, audio):
    """The mono pipeline with no upstream stage, written out: the
    recording framed (its tail the recording reflected), the reference
    model on every chunk, the port's crossfade."""
    t = audio.shape[-1]
    n = num_chunks(t, CHUNK, HOP)
    total = (n - 1) * HOP + CHUNK
    x = torch.from_numpy(audio[0])
    assert total - t < t
    x = torch.cat([x, x.flip(0)[1:1 + total - t]])
    chunks = torch.stack([x[i * HOP:i * HOP + CHUNK] for i in range(n)])
    y = plain.forward(model.state_dict(), chunks[:, None], widths)
    return overlap_add(y, HOP, total, overlap=OVERLAP)[:, :t]


@pytest.mark.parametrize("t", [800, 2600], ids=["one_chunk", "three_chunks"])
def test_pipeline_enhancer_matches_plain_chain(t):
    model, widths = _model(stereo=False)
    audio = np.random.default_rng(t).normal(0, 0.1, (1, t)).astype(np.float32)
    pipe = _pipe(model)
    out, rate = pipe.restore(audio, RATE)
    assert rate == RATE and out.shape == (1, t)
    assert _gap(out, _plain_chain(model, dict(widths, stereo=False),
                                  audio)) < TOL


def test_restore_many_runs_the_enhancer():
    model, _ = _model(stereo=False)
    rng = np.random.default_rng(3)
    audios = [rng.normal(0, 0.1, (1, t)).astype(np.float32)
              for t in (800, 2600, 1500)]
    pipe = _pipe(model)
    for (got, _), audio in zip(pipe.restore_many(audios, RATE), audios):
        assert _gap(got, pipe.restore(audio, RATE)[0]) < TOL


def _stages():
    gen = torch.Generator().manual_seed(0)
    return tuple(init_params(m, gen).eval() for m in (
        AudioDenoiser(features=(8, 16)),
        AudioSuperResolution(base_channels=8, num_residual_blocks=2),
        StereoSeparator(base_channels=8, lstm_hidden=16)))


def test_stage_runs_on_the_combined_stereo_output():
    """With the three upstream stages the enhancer takes each chunk's
    stereo output at the output rate, before the crossfade: the pipeline
    equals the stages without it, the same enhancer on their chunk rows
    and the crossfade (the model's own numbers are held above)."""
    model, _ = _model()
    stages = _stages()
    audio = np.random.default_rng(4).normal(0, 0.1, (1, 2600)).astype(
        np.float32)
    pipe = _pipe(model, stages)
    got, rate = pipe.restore(audio, RATE)
    base = _pipe(None, stages)
    x = pipe._pad_end(torch.from_numpy(audio), 4 * HOP + OVERLAP - 2600)
    with torch.inference_mode():
        rows = base._stage_stack(CHUNK, RATE)(torch.stack(
            [x[0, i * HOP:i * HOP + CHUNK] for i in range(4)])[:, :, None])
        want = overlap_add(model(rows), 2 * HOP, 2 * (4 * HOP + OVERLAP),
                           overlap=2 * OVERLAP, valid=3)[:, :5200]
    assert rate == 2 * RATE and got.shape == (2, 5200)
    assert _gap(got, want) < 1e-6


def test_enhancer_off_pads_with_zeros():
    x = torch.arange(1.0, 6.0)[None]
    assert _pipe(None)._pad_end(x, 3).tolist() == [[1, 2, 3, 4, 5, 0, 0, 0]]
    model, _ = _model(stereo=False)
    assert _pipe(model)._pad_end(x, 10).tolist() == [
        [1, 2, 3, 4, 5, 4, 3, 2, 1, 2, 3, 4, 5, 4, 3]]


def test_spans_and_tokens():
    model, widths = _model(stereo=False)
    pipe = _pipe(model, max_chunks_per_program=4)
    P.clear_spans()
    audio = np.zeros((1, 5500), np.float32) + 0.1
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.restore(audio, RATE)  # 6 chunks: two slabs of 4 rows
    spans = P.spans()
    P.clear_spans()
    named = {n: [s for s in spans if s["name"] == n] for n in (
        "restore", "restore.enhance", "enhance.spec", "enhance.bands",
        "enhance.time", "enhance.band")}
    root, = named["restore"]
    assert len(named["restore.enhance"]) == 2
    frames = 1 + CHUNK // widths["stft_hop_length"]
    for stage in named["restore.enhance"]:
        assert stage["parent"] == root["id"]
        # no TF32x3 GEMM launch on the CPU
        assert stage["counts"] == {"tokens": 4 * frames * 8,
                                   "gemm_launches": 0}
        inner = [s for s in spans if s["parent"] == stage["id"]]
        assert sorted(s["name"] for s in inner) == sorted(
            ["enhance.spec"] * 2 + ["enhance.bands"] * 2
            + ["enhance.time"] * 2 + ["enhance.band"] * 2)


def test_refused_where_it_cannot_run():
    from ml_audio_restoration_torch.parallel import make_mesh

    model, _ = _model()
    mono, _ = _model(stereo=False)
    with pytest.raises(ValueError, match="streaming"):
        StreamingRestorer(*_stages(), device="cpu", enhancer=model)
    with pytest.raises(ValueError, match="int8"):
        _pipe(model, _stages(), quantize_int8=True)
    with pytest.raises(ValueError, match="'model' axis"):
        RestorationPipeline(*_stages(), device="cpu", enhancer=model,
                            mesh=make_mesh(1, 2, devices=["cpu"] * 2))
    pipe = _pipe(model, _stages())
    pipe.mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="'model' axis"):
        pipe.restore(np.zeros((1, 800), np.float32), RATE)
    with pytest.raises(ValueError, match="channel"):
        _pipe(mono, _stages())
    with pytest.raises(ValueError, match="stems"):
        _pipe(_model(num_stems=2)[0], _stages())


YAML = """audio:
  chunk_size: 1000
model:
  dim: 32
  depth: 2
  stereo: false
  num_stems: 1
  time_transformer_depth: 1
  freq_transformer_depth: 1
  linear_transformer_depth: 0
  freqs_per_bands: !!python/tuple
  - 2
  - 2
  - 2
  - 4
  - 4
  - 4
  - 7
  - 8
  dim_head: 16
  heads: 2
  attn_dropout: 0.1
  ff_dropout: 0.1
  flash_attn: true
  dim_freqs_in: 33
  stft_n_fft: 64
  stft_hop_length: 10
  stft_win_length: 64
  stft_normalized: false
  mask_estimator_depth: 2
  multi_stft_resolution_loss_weight: 1.0
  multi_stft_resolutions_window_sizes: !!python/tuple
  - 64
  - 32
  multi_stft_hop_size: 16
  multi_stft_normalized: false
"""


def test_load_stage_reload_and_cli(tmp_path):
    from ml_audio_restoration_torch import cli
    from ml_audio_restoration_torch.audio import load_audio, save_audio

    model, _ = _model(stereo=False)
    other, _ = _model(seed=1, stereo=False)
    ckpt = tmp_path / "rf.ckpt"
    torch.save(model.state_dict(), ckpt)
    (tmp_path / "rf.yaml").write_text(YAML)
    torch.save({"model_state_dict": other.state_dict()}, tmp_path / "o.pth")
    (tmp_path / "o.yaml").write_text(YAML)
    x = torch.randn(2, 1, 400)
    with torch.inference_mode():
        loaded = load_stage(ckpt, "enhancer")
        assert torch.equal(loaded(x), model(x))
        audio = np.random.default_rng(5).normal(0, 0.1, (1, 1500)).astype(
            np.float32)
        pipe = RestorationPipeline.from_checkpoints(
            config=PipelineConfig(chunk_seconds=CHUNK / RATE,
                                  overlap_seconds=OVERLAP / RATE),
            device="cpu", enhancer_path=ckpt)
        assert torch.equal(pipe.restore(audio, RATE)[0],
                           _pipe(model).restore(audio, RATE)[0])
        assert pipe.reload_stages({"enhancer": tmp_path / "o.pth"}) == [
            "enhancer"]
        assert torch.equal(pipe.restore(audio, RATE)[0],
                           _pipe(other).restore(audio, RATE)[0])
    (tmp_path / "bad.yaml").write_text(YAML.replace(
        "linear_transformer_depth: 0", "linear_transformer_depth: 1"))
    torch.save(model.state_dict(), tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="linear_transformer_depth"):
        load_stage(tmp_path / "bad.pth", "enhancer")
    save_audio(tmp_path / "in.wav", audio, RATE)
    assert cli.main(["restore", str(tmp_path / "in.wav"),
                     str(tmp_path / "out.wav"), "--no-denoise",
                     "--no-super-res", "--no-stereo", "--enhancer", str(ckpt),
                     "--chunk-seconds", str(CHUNK / RATE),
                     "--overlap-seconds", str(OVERLAP / RATE),
                     "--device", "cpu"]) == 0
    pipe.reload_stages({"enhancer": ckpt})
    pipe.restore_file(tmp_path / "in.wav", tmp_path / "want.wav")
    got, _ = load_audio(tmp_path / "out.wav", sample_rate=RATE, mono=True)
    want, _ = load_audio(tmp_path / "want.wav", sample_rate=RATE, mono=True)
    assert np.array_equal(got, want)


def test_bf16_cast():
    """cast_model's bf16 copy runs the transformers in bf16 and the STFT,
    the mask product and the iSTFT in float32; it lands near float32."""
    model, _ = _model(stereo=False)
    audio = np.random.default_rng(6).normal(0, 0.1, (1, 1500)).astype(
        np.float32)
    f32 = _pipe(model).restore(audio, RATE)[0]
    bf16 = _pipe(model, compute_dtype="bfloat16").restore(audio, RATE)[0]
    assert bf16.dtype == torch.float32
    assert 0 < _gap(bf16, f32) < 0.1

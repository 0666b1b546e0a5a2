"""Multi-device serving of the port (parallel/mesh.py): RestorationPipeline
and StreamingRestorer over a device mesh, and the CLI's --data-parallel,
against the JAX package's sharded pipeline on its 8 virtual CPU devices
(tests/conftest.py) and against the port's own unsharded runs.

The CPU is one torch device, so the port's meshes here repeat it: the
shards run one after another on it, each with its own slice of the batch,
which checks the split, the gather, the shard state and the numbers.

Bars:
- the port's sharded restore against the JAX package's: CHAIN_BAR (1e-3);
- sharded against unsharded: atol 2e-5, rtol 1e-4, the bar of JAX
  tests/test_pipeline.py:181 (a shard's convolutions run on a smaller
  batch, which may sum in another order);
- a one-entry mesh against no mesh: bit for bit (the same shapes);
- sharded streams against unsharded ones: 1e-6 (JAX
  tests/test_streaming.py:229).
"""
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.parallel import make_mesh as jax_mesh
from ml_audio_restoration_tpu.pipeline import RestorationPipeline as JaxPipe
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.audio import save_audio
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.parallel import (Mesh, make_mesh, replicate,
                                                 shard_batch)
from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                 StreamingRestorer)
from ml_audio_restoration_torch.pipeline import restore as restore_mod
from test_torch_models import jax_model, port_model
from test_torch_pipeline import CHAIN_BAR, CHUNKED, RATE, SMALL
from test_torch_serving import _checkpoints, stages  # noqa: F401

SHARD_TOL = dict(atol=2e-5, rtol=1e-4)
STREAM_TOL = 1e-6
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    suite's other workers, each op's thread pool otherwise contends for
    the cores (test_torch_quant.py's fixture). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _port(stages, mesh=None, names=tuple(SMALL), **cfg):  # noqa: F811
    kw = {"denoiser": "denoiser", "super_resolution": "super_resolution",
          "stereo_separator": "stereo"}
    return RestorationPipeline(
        **{kw[n]: port_model(n, *stages[n]) for n in names},
        config=PipelineConfig(**cfg), device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def packable():
    """A narrow denoiser with the default three encoder levels: the int8
    path rides the packed layout, which needs them."""
    return jax_model("denoiser", 0, np.random.default_rng(13),
                     features=(8, 16, 32))[1]


def _int8_pipe(dn, mesh=None, **cfg):
    return RestorationPipeline(
        denoiser=port_model("denoiser", *dn), device="cpu", mesh=mesh,
        config=PipelineConfig(quantize_int8=True, **cfg))


def _audio(t, seed=1):
    return (np.random.default_rng(seed).normal(size=(1, t)) * 0.2).astype(
        np.float32)


@pytest.fixture
def shard_rows(monkeypatch):
    """The row count of every batch the pipeline shards, and each shard's
    rows, as restore.py's shard_batch returns them."""
    seen = []

    def spy(mesh, x):
        parts = shard_batch(mesh, x)
        seen.append((x.shape[0], [p.shape[0] for p in parts]))
        return parts

    monkeypatch.setattr(restore_mod, "shard_batch", spy)
    return seen


# ------------------------------------------------------------- the mesh

def test_make_mesh():
    mesh = _cpu_mesh(3)
    assert mesh.shape == {"data": 3, "model": 1}
    assert mesh.data_devices == [CPU] * 3
    assert len(mesh.devices) == 3 and all(len(r) == 1 for r in mesh.devices)
    with pytest.raises(ValueError, match="mesh needs 4 devices, only 3 "
                                         "available"):
        make_mesh(4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 available"):
            make_mesh(1)  # the default devices are the cards


def test_model_axis_raises():
    """Sequence-parallel whole-file serving (the 'model' axis) is not
    ported: asking for it raises, naming ROADMAP item 4."""
    with pytest.raises(NotImplementedError, match="item 4"):
        make_mesh(1, model_parallel=2, devices=["cpu"] * 2)
    mesh = Mesh(((CPU, CPU),))
    assert mesh.shape == {"data": 1, "model": 2}
    with pytest.raises(NotImplementedError, match="item 4"):
        shard_batch(mesh, torch.zeros(4, 1))


def test_shard_batch_uneven_and_replicate():
    x = torch.arange(64.0)[:, None]
    parts = shard_batch(_cpu_mesh(3), x)
    assert [p.shape[0] for p in parts] == [22, 21, 21]
    assert torch.equal(torch.cat(parts), x)
    m = torch.nn.Linear(2, 2)
    reps = replicate(_cpu_mesh(3), m)
    assert list(reps) == [CPU] and reps[CPU] is m  # one a distinct device


# ------------------------------------------------------ sharded restore

def test_sharded_restore_matches_jax_and_unsharded(stages,  # noqa: F811
                                                   shard_rows):
    """JAX tests/test_pipeline.py:181 on the port: the chunk batch sharded
    over an 8-entry mesh against the JAX package's pipeline on its 8-device
    mesh (chain bar) and against the port unsharded (the JAX test's bar).
    6 chunks bucket to 8, one a shard."""
    audio = _audio(5000)
    want, want_rate = JaxPipe(
        denoiser=stages["denoiser"],
        super_resolution=stages["super_resolution"],
        stereo=stages["stereo_separator"], config=JaxConfig(**CHUNKED),
        mesh=jax_mesh(data_parallel=8)).restore(audio, RATE)
    got, rate = _port(stages, _cpu_mesh(8), **CHUNKED).restore(audio, RATE)
    plain, _ = _port(stages, **CHUNKED).restore(audio, RATE)
    assert rate == want_rate == 2 * RATE
    assert tuple(got.shape) == np.asarray(want).shape == (2, 10000)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < CHAIN_BAR
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **SHARD_TOL)
    assert shard_rows == [(8, [1] * 8)]


def test_uneven_slabs_over_three_devices(stages, shard_rows):  # noqa: F811
    """A recording longer than max_chunks_per_program runs in slabs of
    exactly that many chunks, which need not divide over the mesh: 4-chunk
    slabs over 3 devices split 2/1/1 (the chip's 64 over 3: 22/21/21)."""
    cfg = dict(CHUNKED, max_chunks_per_program=4)
    audio = _audio(5000, seed=2)
    got, _ = _port(stages, _cpu_mesh(3), **cfg).restore(audio, RATE)
    plain, _ = _port(stages, **cfg).restore(audio, RATE)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **SHARD_TOL)
    assert shard_rows == [(4, [2, 1, 1])] * 2


def test_one_entry_mesh_is_bit_for_bit(stages):  # noqa: F811
    audio = _audio(4321, seed=3)
    got, _ = _port(stages, _cpu_mesh(1), **CHUNKED).restore(audio, RATE)
    plain, _ = _port(stages, **CHUNKED).restore(audio, RATE)
    assert torch.equal(got, plain)


def test_mesh_assigned_after_construction(stages, shard_rows):  # noqa: F811
    """JAX tests/test_pipeline.py:694: the CLI assigns `pipe.mesh` after
    construction; the next restore must run sharded (at the new mesh's
    bucket) and give the unsharded output. 13,200 samples at 8 kHz are 8
    chunks: one bucket with and without the 8-way mesh."""
    cfg = dict(sample_rate=8000, chunk_seconds=0.25, overlap_seconds=0.05)
    pipe = _port(stages, names=("denoiser",), **cfg)
    audio = _audio(13200, seed=4)
    a, _ = pipe.restore(audio)
    assert shard_rows == []
    pipe.mesh = _cpu_mesh(8)
    b, _ = pipe.restore(audio)
    assert shard_rows == [(8, [1] * 8)]
    np.testing.assert_allclose(a.numpy(), b.numpy(), **SHARD_TOL)


def test_whole_file_runs_its_chunk_on_the_first_device(stages,  # noqa: F811
                                                        shard_rows):
    audio = _audio(3001, seed=5)
    got, _ = _port(stages, _cpu_mesh(3), whole_file=True).restore(audio,
                                                                  RATE)
    plain, _ = _port(stages, whole_file=True).restore(audio, RATE)
    assert shard_rows == [(1, [1, 0, 0])]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **SHARD_TOL)


def test_restore_many_and_warmup_buckets_at_lcm(stages,  # noqa: F811
                                                shard_rows):
    """Under a 3-entry mesh the chunk buckets are multiples of lcm(4, 3) =
    12: restore_many's combined batch (each member's bucket too) and
    warmup's bucket list, whose top is max_chunks_per_program."""
    cfg = dict(CHUNKED, max_chunks_per_program=24)
    pipe = _port(stages, _cpu_mesh(3), names=("denoiser",), **cfg)
    info = pipe.warmup(coalesce=2)
    assert info["buckets"] == [12, 24]
    assert [n for n, _ in shard_rows] == [12, 12, 24, 24]
    shard_rows.clear()
    audios = [_audio(t, seed=t) for t in (2000, 3500, 1000)]
    got = pipe.restore_many(audios, RATE)
    # 2 + 4 + 1 chunks, each bucketed to 12: they cover 6 + 12 rows -> 24
    assert shard_rows == [(24, [8, 8, 8])]
    plain = _port(stages, names=("denoiser",), **cfg)
    for a, (out, rate) in zip(audios, got):
        want, _ = plain.restore(a, RATE)
        assert rate == RATE
        np.testing.assert_allclose(out.numpy(), want.numpy(), **SHARD_TOL)


def test_replica_and_int8_keys_carry_the_device(packable):
    """Every per-device cache is keyed by the device: the stage models in
    each compute dtype (`_cast[dtype][device]`), the int8 contexts and the
    quantized weights inside a context. The CPU mesh repeats one device, so
    one key; a card mesh gets one a card."""
    pipe = _int8_pipe(packable, _cpu_mesh(2), **CHUNKED)
    pipe.restore(_audio(3000, seed=6), RATE)
    assert list(pipe._cast) == ["float32"]
    assert list(pipe._cast["float32"]) == [CPU]
    assert pipe._cast["float32"][CPU][0] is pipe.denoiser  # f32: itself
    assert [k[-1] for k in pipe._qctx] == [CPU]
    ctx = next(iter(pipe._qctx.values()))
    assert ctx._weights and all(k[0] == CPU for k in ctx._weights)
    assert ctx._folded and all(k[0] == CPU for k in ctx._folded)


def test_int8_sharded_restore_shares_the_scales(packable, tmp_path):
    """int8 under a mesh with the unsharded restore's scales file: every
    shard quantizes with those scales (none recalibrates), and the output
    equals the unsharded int8 restore's at the sharded bar."""
    audio = _audio(5000, seed=7)
    plain = _int8_pipe(packable, **CHUNKED)
    want, _ = plain.restore(audio, RATE)
    plain.save_int8_scales(tmp_path / "scales.json")
    sharded = _int8_pipe(packable, _cpu_mesh(2), **CHUNKED)
    scales = sharded.load_int8_scales(tmp_path / "scales.json")
    got, _ = sharded.restore(audio, RATE)
    assert sharded._int8_scales is scales
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SHARD_TOL)


def test_reload_on_a_mesh_drops_every_replica(stages, tmp_path):  # noqa: F811
    """reload_stages on a mesh pipeline: every device's models go with the
    old weights, so the next sharded restore serves the new checkpoint
    (equal to a fresh pipeline on it) on every shard."""
    from ml_audio_restoration_tpu.compat.torch_saver import EXPORTERS
    from test_torch_models import jax_model

    cfg = dict(CHUNKED, compute_dtype="bfloat16")
    pipe = _port(stages, _cpu_mesh(2), names=("denoiser",), **cfg)
    audio = _audio(4000, seed=8)
    before, _ = pipe.restore(audio, RATE)
    new = jax_model("denoiser", 9, np.random.default_rng(9),
                    **SMALL["denoiser"])[1]
    path = tmp_path / "dn.pth"
    torch.save({"model_state_dict": EXPORTERS["denoiser"](*new)}, path)
    assert pipe.reload_stages({"denoiser": str(path)}) == ["denoiser"]
    assert pipe._cast == {}
    after, _ = pipe.restore(audio, RATE)
    fresh = RestorationPipeline.from_checkpoints(
        denoiser_path=path, config=PipelineConfig(**cfg), device="cpu")
    fresh.mesh = _cpu_mesh(2)
    assert torch.equal(after, fresh.restore(audio, RATE)[0])
    assert not torch.equal(before, after)


# -------------------------------------------------------- sharded streams

def test_sharded_streams_match_unsharded(stages):  # noqa: F811
    """JAX tests/test_streaming.py:229: the stream batch sharded over the
    mesh against the unsharded batched restorer, feed by feed and the
    flush; a stream recycled with reset_stream on the second shard's
    device too."""
    names = {"denoiser": "denoiser", "super_resolution": "super_resolution",
             "stereo_separator": "stereo"}
    models = {names[n]: port_model(n, *stages[n]) for n in SMALL}
    plain = StreamingRestorer(**models, batch=4, device="cpu")
    sharded = StreamingRestorer(**models, batch=4, mesh=_cpu_mesh(2),
                                device="cpu")
    assert [hi - lo for _, lo, hi in sharded._shards] == [2, 2]
    blocks = (np.random.default_rng(10).normal(size=(3, 4, 1500))
              * 0.1).astype(np.float32)
    for i, b in enumerate(blocks):
        if i == 2:
            plain.reset_stream(3)
            sharded.reset_stream(3)
        want, got = plain.feed(b), sharded.feed(b)
        assert got.shape == want.shape == (4, 2, got.shape[-1])
        assert float(np.abs(got - want).max()) <= STREAM_TOL
    assert float(np.abs(sharded.flush() - plain.flush()).max()) <= STREAM_TOL


def test_cli_stream_data_parallel_matches_unsharded(stages,  # noqa: F811
                                                    tmp_path):
    """JAX tests/test_framework.py:129: `stream --data-parallel 2` writes
    the unsharded run's WAVs byte for byte; pipe mode refuses the flag."""
    rng = np.random.default_rng(11)
    paths = []
    for i, t in enumerate((3000, 2200)):
        paths.append(tmp_path / f"f{i}.wav")
        save_audio(paths[-1], (rng.normal(size=(1, t)) * 0.1).astype(
            np.float32), RATE)
    ckpts = _checkpoints(stages, tmp_path)
    outs = {}
    for name, extra in (("plain", []), ("dp", ["--data-parallel", "2"])):
        rc = cli.main(["stream", *map(str, paths), "--output-dir",
                       str(tmp_path / name), "--block-seconds",
                       str(1000 / RATE), "--device", "cpu", *ckpts, *extra])
        assert rc == 0
        outs[name] = [(tmp_path / name / f"f{i}_restored.wav").read_bytes()
                      for i in (0, 1)]
    assert outs["plain"] == outs["dp"]
    with pytest.raises(SystemExit, match="single-stream"):
        cli.main(["stream", "-", "--device", "cpu", "--data-parallel", "2"])


def test_cli_restore_data_parallel(stages, tmp_path):  # noqa: F811
    """`restore --data-parallel 1` writes the bytes of a run without the
    flag; asking for more cards than the host has raises, naming how many
    there are (never serving on fewer or on the CPU)."""
    src = tmp_path / "in.wav"
    save_audio(src, _audio(3000, seed=12), RATE)
    ckpts = _checkpoints(stages, tmp_path)
    common = ["--chunk-seconds", str(1000 / RATE), "--overlap-seconds",
              str(100 / RATE), "--device", "cpu", *ckpts]
    cli.main(["restore", str(src), str(tmp_path / "a.wav"), *common])
    cli.main(["restore", str(src), str(tmp_path / "b.wav"), *common,
              "--data-parallel", "1"])
    assert (tmp_path / "a.wav").read_bytes() == (
        tmp_path / "b.wav").read_bytes()
    if not torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"only {n} available"):
            cli.main(["restore", str(src), str(tmp_path / "c.wav"),
                      *ckpts, "--data-parallel", "2"])

"""Multi-process data parallelism of the port on real gloo ranks, on the
CPU.

Each rank is a fresh `python` interpreter running this file's `__main__`
(no helper file): it joins a two-process gloo group over loopback through
`parallel.distributed.initialize`, runs every case of CASES on its share
of a seeded global batch and writes what it saw to an .npz. The test
process computes the same case without a group on the whole global batch
(the ranks' batches concatenated in rank order, the same step seed) and
holds the ranks to it, as the JAX package's sharded step is held to its
unsharded one (tests/test_trainer.py:150). Each step runs in f32 and in
float64. Bars:
- the loss and the logged metrics: 1e-4 relative;
- each gradient (after the all-reduce, before Adam), in float64 (see
  test_two_rank_gradients_equal_one_process): 1e-4 of the largest entry
  of the one-process gradient of that parameter; a conv bias that feeds a
  train-mode BN has a true gradient of zero, and its entries are held at
  1e-4 of the largest entry of the whole gradient instead;
- BN running statistics: 1e-5; parameters after Adam: 2e-3, the JAX
  package's own bar for its dp=4 step;
- the ranks against each other: equal bit for bit (loss, metrics,
  gradients, parameters, statistics).
The BN case holds `ops.batch_norm_train` alone: output 1e-5, the input's
and the weights' gradients 1e-4 of their largest entry.

Then `python -m ml_audio_restoration_torch train` as two processes
(--coordinator/--num-processes/--process-id): disjoint shards, equal
epoch lines, one checkpoint writer and one metrics file. Every
subprocess wait has its own timeout, so a hung rank fails its test.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ml_audio_restoration_torch.config import TrainConfig
from ml_audio_restoration_torch.models import init_params
from ml_audio_restoration_torch.ops import batch_norm_train
from ml_audio_restoration_torch.parallel import distributed as dist
from ml_audio_restoration_torch.train import trainer as T

ROOT = Path(__file__).resolve().parent.parent
W, B = 2, 2           # ranks, items a rank
SR = 22050
LOSS_TOL = 1e-4       # relative
GRAD_TOL = 1e-4       # of the largest entry
STATS_TOL = 1e-5
PARAM_TOL = 2e-3      # JAX tests/test_trainer.py:150-163
OUT_TOL = 1e-5
WAIT_S = 120

SMALL = {"denoiser": {"features": (8, 16)},
         "super_resolution": {"base_channels": 8, "num_residual_blocks": 2},
         "stereo_separator": {"base_channels": 4, "lstm_hidden": 8}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The steps here are small: run their intra-op work on one thread, as
    the gloo ranks do, so that they do not contend with the suite's other
    workers (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio(n, c, t, seed, gain=0.35):
    """n seeded tones under noise, [n, c, t] float32."""
    rng = np.random.default_rng(seed)
    k = np.arange(t) / SR
    f = rng.uniform(150.0, 900.0, size=(n, c, 1))
    x = np.sin(2 * np.pi * f * k) + 0.3 * rng.standard_normal((n, c, t))
    return (gain * x).astype(np.float32)


def _global_batch(case):
    """The global batch of a case: every key [W*B, ...]."""
    n = W * B
    if case == "denoiser_degrade":
        return {"clean": _audio(n, 1, 2048, 1)}
    if case == "super_resolution_downsample":
        return {"high": _audio(n, 1, 2048, 2)}
    if case == "stereo_mono_target_stereo":
        return {"stereo": _audio(n, 2, 2048, 3)}
    if case == "denoiser_mixed":
        # rank 0 holds two synthetic items, rank 1 one: a local masked
        # mean differs from the global one
        return {"audio": _audio(n, 1, 2048, 4),
                "is_synthetic": np.float32([1, 1, 0, 1]),
                "contrastive_pair": _audio(n, 1, 2048, 5),
                "contrastive_pair_is_synthetic": np.float32([0, 0, 1, 0]),
                "contrastive_label": np.float32([0, 1, 0, 0])}
    if case == "denoiser_degrade_adaptive":
        return {"clean": _audio(n, 1, 2048, 6),
                "impulse_rate": np.float32([2.0, 30.0, 45.0, 8.0]),
                "impulse_amplitude_max": np.float32([0.3, 0.9, 0.6, 0.45]),
                "noise_level": np.float32([0.01, 0.08, 0.03, 0.05])}
    raise KeyError(case)


# case -> (family, pairing, TrainConfig fields)
STEPS = {
    "denoiser_degrade": ("denoiser", "degrade", {}),
    "super_resolution_downsample": ("super_resolution", "downsample", {}),
    "stereo_mono_target_stereo": ("stereo_separator", "mono_target_stereo",
                                  {}),
    "denoiser_mixed": ("denoiser", "mixed", {"contrastive_weight": 0.1}),
    "denoiser_degrade_adaptive": ("denoiser", "degrade_adaptive", {}),
}
CASES = ("batch_norm",) + tuple(STEPS)


def _bn_inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((W * B, 3, 50)).astype(np.float32) * 2 + 0.5
    cot = rng.standard_normal(x.shape).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(3).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    return x, cot, scale, bias, mean, var


def _run_bn(rows):
    """batch_norm_train on rows of the BN case's input, in a train step's
    global_batch(): output, gradients, new running statistics."""
    x, cot, scale, bias, mean, var = (torch.from_numpy(a)
                                      for a in _bn_inputs())
    x = x[rows].clone().requires_grad_()
    scale.requires_grad_()
    bias.requires_grad_()
    with dist.global_batch():
        y, m, v = batch_norm_train(x, scale, bias, mean, var)
        (y * cot[rows]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dscale": scale.grad,
            "dbias": bias.grad, "mean": m, "var": v}


def _run_step(case, rows, dtype):
    """One train step of a case's trainer (its model and batch in `dtype`)
    on rows of its global batch, with the step seed of epoch 1, step 0:
    the loss and logged metrics, the gradients Adam was handed, the
    parameters and buffers after."""
    name, pairing, cfg = STEPS[case]
    model = init_params(T.MODELS[name](**SMALL[name]),
                        torch.Generator().manual_seed(3))
    model.to(torch.from_numpy(np.zeros(0, dtype)).dtype)
    tr = T.Trainer(name, model, None, None,
                   config=TrainConfig(model=name, learning_rate=1e-3,
                                      data_parallel=dist.process_count(),
                                      **cfg),
                   pairing=pairing, device="cpu")
    batch = {k: v[rows].astype(dtype) if v.ndim == 3 else v[rows]
             for k, v in _global_batch(case).items()}
    metrics = tr._train_step(batch, tr._seeded(2, 0))
    out = {f"metric.{k}": v for k, v in metrics.items()}
    out.update((f"grad.{n}", p.grad) for n, p in model.named_parameters())
    out.update((f"param.{n}", p.detach())
               for n, p in model.named_parameters())
    out.update((f"buffer.{n}", b) for n, b in model.named_buffers())
    return out


DTYPES = {"float32": np.float32, "float64": np.float64}


def _run(case, rows, dtype="float32"):
    if case == "batch_norm":
        out = _run_bn(rows)
    else:
        out = _run_step(case, rows, DTYPES[dtype])
    return {k: np.asarray(v.detach().cpu()) for k, v in out.items()}


def _worker(rank: int, port: int, out_dir: str):
    torch.set_num_threads(1)
    dist.initialize(f"127.0.0.1:{port}", W, rank, device="cpu")
    try:
        rows = slice(rank * B, (rank + 1) * B)
        for case in CASES:
            for dtype in ("float32",) if case == "batch_norm" else DTYPES:
                np.savez(Path(out_dir) / f"{case}_{dtype}_rank{rank}.npz",
                         **_run(case, rows, dtype))
    finally:
        dist.shutdown()
    print(f"RANK{rank}_DONE", flush=True)


# ------------------------------------------------------------ spawning
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(path=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([*path, str(ROOT)]),
               OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def _spawn(argv_of_rank, cwd, path=()):
    """Start one process a rank, wait for each (WAIT_S apiece), kill any
    left; gloo's loopback connect can time out on a loaded host, so a
    failed connect is retried once on a fresh port, as the JAX package's
    multi-host test does. -> [(returncode, output)]"""
    def once():
        port = _free_port()
        procs = [subprocess.Popen(argv_of_rank(r, port), cwd=cwd,
                                  env=_env(path),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(W)]
        try:
            outs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return [(p.returncode, o) for p, o in zip(procs, outs)]

    runs = once()
    if any("Connect timeout" in o or "Gloo connectFullMesh failed" in o
           for _, o in runs):
        runs = once()
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once on two gloo ranks: {(case, dtype): [rank 0's
    arrays, rank 1's]}."""
    out = tmp_path_factory.mktemp("gloo")
    _spawn(lambda r, port: [sys.executable, str(Path(__file__).resolve()),
                            str(r), str(port), str(out)], str(out))

    def load(case, dtype):
        return [dict(np.load(out / f"{case}_{dtype}_rank{r}.npz"))
                for r in range(W)]

    got = {("batch_norm", "float32"): load("batch_norm", "float32")}
    got.update(((c, d), load(c, d)) for c in STEPS for d in DTYPES)
    return got


def _bn_fed_biases(model):
    """Conv biases that feed a train-mode BN: their true gradient is
    zero."""
    out = set()
    for name, mod in model.named_modules():
        kids = list(mod.named_children())
        for (a, conv), (_, bn) in zip(kids, kids[1:]):
            if (isinstance(conv, torch.nn.Conv1d)
                    and isinstance(bn, torch.nn.BatchNorm1d)):
                out.add(f"{name}.{a}.bias".lstrip("."))
    return out


def _assert_ranks_equal(got):
    for key in got[0]:
        np.testing.assert_array_equal(got[0][key], got[1][key],
                                      err_msg=f"ranks differ on {key}")


def _rel(g, w):
    return float(np.abs(g - w).max()) / float(np.abs(w).max())


# --------------------------------------------------------------- tests
def test_batch_norm_statistics_are_the_global_batch(ranks):
    got = ranks["batch_norm", "float32"]
    want = _run("batch_norm", slice(None))
    for r in range(W):
        rows = slice(r * B, (r + 1) * B)
        np.testing.assert_allclose(got[r]["y"], want["y"][rows], atol=OUT_TOL)
        assert _rel(got[r]["dx"], want["dx"][rows]) <= GRAD_TOL
    np.testing.assert_array_equal(got[0]["mean"], got[1]["mean"])
    np.testing.assert_array_equal(got[0]["var"], got[1]["var"])
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[0][k], want[k], atol=STATS_TOL)
    # each rank holds its own items' share of the weights' gradient
    for k in ("dscale", "dbias"):
        assert _rel(got[0][k] + got[1][k], want[k]) <= GRAD_TOL
    # and a local statistic would not pass: the ranks' batches differ
    local = _run("batch_norm", slice(0, B))
    assert np.abs(local["mean"] - want["mean"]).max() > 100 * STATS_TOL


@pytest.mark.parametrize("case", list(STEPS))
def test_two_rank_step_equals_one_process(ranks, case):
    """f32: the loss, logged metrics, BN statistics and the parameters
    after Adam; the ranks equal bit for bit."""
    got = ranks[case, "float32"]
    _assert_ranks_equal(got)
    want = _run(case, slice(None))
    g = got[0]
    assert set(g) == set(want)
    for k in want:
        if k.startswith("metric."):
            np.testing.assert_allclose(g[k], want[k], rtol=LOSS_TOL,
                                       atol=1e-7, err_msg=k)
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g[k], want[k], atol=STATS_TOL,
                                       err_msg=k)
        elif k.startswith("param."):
            np.testing.assert_allclose(g[k], want[k], atol=PARAM_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("case", list(STEPS))
def test_two_rank_gradients_equal_one_process(ranks, case):
    """The gradients Adam is handed, in float64. In f32 the two routes
    sum the BN statistics in another order, the forwards part by ~1e-6,
    and a leaky ReLU input that close to 0 takes the other slope on one
    side: on the CPU at these widths that moves up to 0.5% of a weight's
    gradient through the BN backward (seen: one such element of 65,536 at
    the denoiser's last block). The routes' arithmetic is held where no
    kink lies that close: float64, every loss term."""
    got = ranks[case, "float64"]
    _assert_ranks_equal(got)
    want = _run(case, slice(None), "float64")
    g = got[0]
    np.testing.assert_allclose(g["metric.loss"], want["metric.loss"],
                               rtol=LOSS_TOL)
    name = STEPS[case][0]
    loose = _bn_fed_biases(T.MODELS[name](**SMALL[name]))
    grads = {k[5:]: v for k, v in want.items() if k.startswith("grad.")}
    top = max(float(np.abs(v).max()) for v in grads.values())
    for n, w in grads.items():
        scale = top if n in loose else float(np.abs(w).max())
        err = float(np.abs(g[f"grad.{n}"] - w).max())
        assert err <= GRAD_TOL * scale, (n, err, scale)
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g[k], w, atol=STATS_TOL, err_msg=k)
        elif k.startswith("param."):
            np.testing.assert_allclose(g[k], w, atol=PARAM_TOL, err_msg=k)


def test_mixed_step_reads_global_masked_means(ranks):
    """The mixed case's ranks hold 2 and 1 synthetic items: the global
    supervised term differs from either rank's local one, and the ranks
    logged the global one."""
    from ml_audio_restoration_torch.losses import supervised_loss

    batch = _global_batch("denoiser_mixed")
    x = torch.from_numpy(batch["audio"]).transpose(1, 2)
    y = x * 0.5
    mask = torch.from_numpy(batch["is_synthetic"])
    whole = float(supervised_loss(x, y, mask))
    halves = [float(supervised_loss(x[s], y[s], mask[s]))
              for s in (slice(0, B), slice(B, None))]
    assert abs(np.mean(halves) - whole) > 1e-3 * whole
    got = ranks["denoiser_mixed", "float32"][0]["metric.supervised"]
    want = _run("denoiser_mixed", slice(None))["metric.supervised"]
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


def _write_corpus(root, n=24, seconds=0.1):
    from ml_audio_restoration_torch.audio import save_audio

    root.mkdir()
    x = _audio(n, 1, int(seconds * SR), 9)
    for i in range(n):
        save_audio(root / f"f{i:02d}.wav", x[i], SR)
    return root


def test_cli_train_runs_as_two_processes(tmp_path):
    data = _write_corpus(tmp_path / "data")
    # rank 0's MetricsLogger attaches TensorBoard, which imports TensorFlow
    # where it is installed: 11 s of a 19 s run on an idle host, while rank
    # 1 waits in its first collective. TensorFlow is hidden from these two
    # processes (TensorBoard then writes through its own stub), so the run
    # stays well inside its wait on a loaded one
    hide = tmp_path / "no_tensorflow"
    (hide / "tensorflow").mkdir(parents=True)
    (hide / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('TensorFlow is hidden from this test')\n")
    cfg = tmp_path / "small.yaml"
    cfg.write_text("denoiser:\n  features: [8, 16]\n"
                   f"train:\n  log_dir: {tmp_path / 'runs'}\n"
                   "  save_every: 1\n")
    runs = _spawn(lambda r, port: [
        sys.executable, "-m", "ml_audio_restoration_torch", "train",
        "denoiser", "--config", str(cfg), "--data-dir", str(data),
        "--device", "cpu", "--batch-size", "4", "--num-epochs", "2",
        "--steps-per-epoch", "2",
        "--chunk-duration", "0.0929", "--checkpoint-dir",
        str(tmp_path / "ckpt"), "--data-parallel", "2",
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
        "--process-id", str(r)], str(tmp_path), path=[str(hide)])
    outs = [o for _, o in runs]
    assert "backend gloo" in outs[0] and "backend gloo" not in outs[1]

    def lines(out, start):
        return [ln for ln in out.splitlines() if ln.startswith(start)]

    # disjoint shards of equal length (2 steps of the global batch 4: 8
    # train items, 4 a rank)
    shards = []
    for r, out in enumerate(outs):
        (line,) = lines(out, f"process {r} of 2:")
        shards.append(set(line.split("(")[1].split(")")[0]
                          .replace(", ...", "").split(", ")))
        assert "4 train items" in line and "local batch 2" in line
    assert not shards[0] & shards[1]
    # equal histories: the epoch lines, less their durations
    epochs = [[ln.split("s train ")[1] for ln in lines(out, "epoch ")]
              for out in outs]
    assert len(epochs[0]) == 2 and epochs[0] == epochs[1]
    # rank 0 is the only writer
    assert "checkpoint saved" in outs[0]
    assert "checkpoint saved" not in outs[1]
    assert sorted(p.name for p in (tmp_path / "ckpt" / "denoiser").glob(
        "*.pth"))
    assert len(list((tmp_path / "runs").rglob("*.jsonl"))) == 1
    history = torch.load(tmp_path / "ckpt" / "denoiser" /
                         "checkpoint_epoch_2.pth",
                         weights_only=False)["history"]
    assert [f"{v:.6f}" for v in history["train_loss"]] == [
        e.split()[0] for e in epochs[0]]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

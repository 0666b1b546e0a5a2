"""Multi-process training of the port with simulated ranks, the parts of
parallel/distributed.py that need no peer, and the JAX cross-check.

Simulated ranks: `process_index` / `process_count` monkeypatched, as the
JAX package's tests do (tests/test_trainer.py:494, :510, :518, :535,
:735, :833); the real path differs only in where those numbers come
from. tests/test_torch_distributed.py runs real gloo ranks.

The JAX cross-check closes the chain port DP = port one-process = JAX =
JAX DP: the JAX package's dp=4 step on the virtual CPU mesh against the
port's one-process step on the same global batch of 4, fed JAX's own
draws (test_torch_convnet_train.jax_draws_patch), at the JAX package's
bars for its dp=4 step: the loss 1e-4 relative, the parameters after
Adam 2e-3, and the BN running statistics at the models' 1e-4.
"""
import socket

import jax
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.config import TrainConfig as JTrainConfig
from ml_audio_restoration_tpu.data.loader import DataLoader as JDataLoader
from ml_audio_restoration_tpu.parallel import shard_batch
from ml_audio_restoration_tpu.train.trainer import Trainer as JTrainer
from ml_audio_restoration_torch.audio import save_audio
from ml_audio_restoration_torch.compat import state_dict_from_jax
from ml_audio_restoration_torch.config import TrainConfig, load_config
from ml_audio_restoration_torch.data import DataLoader
from ml_audio_restoration_torch.models import AudioDenoiser, init_params
from ml_audio_restoration_torch.parallel import distributed as dist
from ml_audio_restoration_torch.train import trainer as T
from test_torch_artifacts import clean_batch
from test_torch_convnet_train import jax_draws_patch  # noqa: F401
from test_torch_models import jax_model, port_model

SR = 22050
CHUNK = 2048
FEATURES = (8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The steps here are small: run their intra-op work on one thread, as
    the gloo ranks do, so that they do not contend with the suite's other
    workers (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sine(i, n=CHUNK):
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t))[None].astype(
        np.float32)


class Toy:
    pairing = "degrade"

    def __init__(self, n=4):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"clean": _sine(i)}


def _trainer(tmp_path=None, **cfg):
    model = init_params(AudioDenoiser(features=FEATURES),
                        torch.Generator().manual_seed(0))
    tr = T.Trainer("denoiser", model, DataLoader(Toy(), 4, seed=0), None,
                   config=TrainConfig(model="denoiser", learning_rate=1e-3,
                                      **cfg),
                   device="cpu")
    if tmp_path is not None:
        tr.checkpoint_dir = tmp_path
    return tr


def _ranks(monkeypatch, rank, count=2):
    monkeypatch.setattr(dist, "process_index", lambda: rank)
    monkeypatch.setattr(dist, "process_count", lambda: count)


# ------------------------------------------------------ distributed.py
def test_process_index_sharding_disjoint_and_complete():
    idx = np.random.default_rng(0).permutation(101)
    shards = [dist.shard_indices_by_process(idx, index=k, count=4)
              for k in range(4)]
    assert len({len(s) for s in shards}) == 1
    assert len(shards[0]) == 101 // 4
    flat = np.concatenate(shards)
    assert len(np.unique(flat)) == len(flat)
    assert set(flat) <= set(idx)
    np.testing.assert_array_equal(
        dist.shard_indices_by_process(idx, index=0, count=1), idx)


def test_local_batch_size():
    assert dist.local_batch_size(16, count=4) == 4
    assert dist.local_batch_size(16, count=1) == 16
    with pytest.raises(ValueError):
        dist.local_batch_size(10, count=4)


def test_single_process_defaults():
    assert (dist.process_index(), dist.process_count(),
            dist.is_primary()) == (0, 1, True)
    assert dist.agree_flag(True) is True and dist.agree_flag(0) is False
    assert dist.broadcast_from_primary("ckpt é") == "ckpt é"
    with dist.global_batch():
        assert not dist.in_global_batch()


def test_initialize_is_a_no_op_without_a_job(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dist.initialize() is False
    # a launcher's world of 2 without its address is not a job either
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert dist.initialize() is False


def test_initialize_reads_a_launchers_environment(monkeypatch):
    seen = {}
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda backend, **kw: seen.update(kw, backend=backend))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29512")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert dist.initialize(device="cpu") is True
    assert seen["init_method"] == "tcp://127.0.0.1:29512"
    assert (seen["world_size"], seen["rank"], seen["backend"]) == (
        2, 1, "gloo")


@pytest.mark.parametrize("kw,error", [
    ({"coordinator_address": "127.0.0.1:1", "num_processes": 2},
     ValueError),                                    # no process id
    ({"num_processes": 2, "process_id": 0}, ValueError),  # no coordinator
    ({"coordinator_address": "127.0.0.1:1", "num_processes": 2,
      "process_id": 2}, ValueError),                 # rank out of range
    ({"coordinator_address": "127.0.0.1:1", "num_processes": 2,
      "process_id": 0, "device": "cuda"}, RuntimeError),  # no card here
])
def test_a_requested_job_that_cannot_form_raises(monkeypatch, kw, error):
    """Never a silent single-process run, never the CPU for "cuda"; all
    of these raise before any connection is tried."""
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda *a, **k: pytest.fail("tried to connect"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error):
        dist.initialize(**kw)


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist.backend_for("cpu", 1) == "gloo"
    assert dist.backend_for("cuda", 1) == "nccl"
    assert dist.backend_for("cuda", 2) == "gloo"   # two ranks, one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dist.backend_for("cuda", 4) == "nccl"


def test_device_for_rank(monkeypatch):
    assert dist.device_for_rank("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.device_for_rank("cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_one_rank_group_step_is_the_plain_step():
    """A one-rank group runs the step through every collective of the
    distributed route (global BN, draws, masked means, the gradient
    all-reduce) and equals the step without a group bit for bit: the
    CPU twin of chip_smoke.py's one-rank NCCL check."""
    def step():
        tr = _trainer()
        m = tr._train_step(next(iter(tr.train_loader)), tr._seeded(2, 0))
        return ({k: v.clone() for k, v in m.items()},
                {n: p.grad.clone() for n, p in tr.model.named_parameters()},
                {k: v.clone() for k, v in tr.model.state_dict().items()})

    plain = step()
    assert dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        calls = []
        real = dist._all_reduce
        dist._all_reduce = lambda t: calls.append(t.shape) or real(t)
        try:
            grouped = step()
        finally:
            dist._all_reduce = real
    finally:
        dist.shutdown()
    assert len(calls) >= 2 * 10 + 1  # BN forward + backward, gradients
    for a, b in zip(plain, grouped):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("group,count,cards,devices", [
    (False, 1, 0, 1),   # one process on the CPU
    (False, 1, 8, 8),   # one process over a host's cards (serving mesh)
    (True, 8, 8, 8),    # torchrun on an 8-card host: one card a rank
    (True, 2, 1, 2)])   # two ranks sharing one card: a replica each
def test_global_device_count(monkeypatch, group, count, cards, devices):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(dist, "_active", lambda: group)
    _ranks(monkeypatch, 0, count)
    assert dist.global_device_count() == devices


def test_global_device_count_in_a_one_rank_group(monkeypatch):
    """A real one-rank group on a host that shows 8 cards: one device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        assert dist.global_device_count() == 1
    finally:
        dist.shutdown()
    assert dist.global_device_count() == 8


# ------------------------------------------------------------ trainer
@pytest.mark.parametrize("data_parallel,count", [(2, 1), (1, 2), (4, 2)])
def test_data_parallel_must_equal_the_process_count(monkeypatch,
                                                    data_parallel, count):
    """The port trains on one device a process: data_parallel > 1 in one
    process (JAX would shard over local devices) and a mismatch both raise
    naming --num-processes."""
    _ranks(monkeypatch, 0, count)
    with pytest.raises(ValueError, match="--num-processes") as e:
        _trainer(data_parallel=data_parallel)
    assert f"data_parallel={data_parallel}" in str(e.value)
    assert f"{count} process" in str(e.value)


def test_only_primary_writes_checkpoints(tmp_path, monkeypatch):
    tr = _trainer(tmp_path)
    tr.train_epoch()
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    tr.save_checkpoint("best_model.pth")
    assert not (tmp_path / "best_model.pth").exists()
    monkeypatch.setattr(dist, "process_index", lambda: 0)
    tr.save_checkpoint("best_model.pth")
    assert (tmp_path / "best_model.pth").exists()


def _corpus(root, n):
    root.mkdir()
    for i in range(n):
        save_audio(root / f"f{i}.wav", _sine(i), SR)
    return root


def _capture_init(monkeypatch, seen):
    real_init = T.Trainer.__init__

    def capture(self, *a, **kw):
        real_init(self, *a, **kw)
        seen[dist.process_index()] = {
            "train_idx": set(self.train_loader.indices.tolist()),
            "val_idx": (None if self.val_loader is None
                        else tuple(self.val_loader.indices.tolist())),
            "val_bs": (None if self.val_loader is None
                       else self.val_loader.batch_size),
            "batch": self.train_loader.batch_size,
            "logger": self.logger is not None,
            "seed": self.train_loader._rng.bit_generator.state,
        }
        raise RuntimeError("stop-before-train")

    monkeypatch.setattr(T.Trainer, "__init__", capture)


def test_train_from_config_shards_loader_and_gates_writers(tmp_path,
                                                           monkeypatch):
    """Two simulated processes: disjoint train indices, identical val
    indices, the local batch, per-rank loader seeds, and only rank 0
    builds a logger."""
    data = _corpus(tmp_path / "raw", 40)
    seen = {}
    _capture_init(monkeypatch, seen)
    cfg = load_config(None, {
        "train": {"model": "denoiser", "batch_size": 4, "num_epochs": 1,
                  "data_parallel": 2,
                  "checkpoint_dir": str(tmp_path / "ck"),
                  "log_dir": str(tmp_path / "runs")},
        "data": {"data_dir": str(data), "chunk_duration": CHUNK / SR},
        "denoiser": {"features": list(FEATURES)}})
    for rank in (0, 1):
        _ranks(monkeypatch, rank)
        with pytest.raises(RuntimeError, match="stop-before-train"):
            T.train_from_config(cfg, device="cpu")
    assert seen[0]["train_idx"].isdisjoint(seen[1]["train_idx"])
    assert len(seen[0]["train_idx"]) == len(seen[1]["train_idx"]) == 18
    assert seen[0]["val_idx"] == seen[1]["val_idx"]
    assert seen[0]["batch"] == seen[1]["batch"] == 2  # 4 global / 2
    assert seen[0]["seed"] != seen[1]["seed"]
    assert seen[0]["logger"] and not seen[1]["logger"]


def test_val_batch_is_the_clamp_with_a_share_of_one(tmp_path, monkeypatch):
    """JAX rounds the clamped validation batch down to a multiple of this
    process's share of the mesh's data axis (data_parallel // processes
    devices). The port runs one device a process, so the share is 1 and
    the clamp stands: a split of 3 items and a local batch of 4 validate
    in one batch of 3 (JAX with 4 devices over 2 processes: 2)."""
    data = _corpus(tmp_path / "raw", 30)  # val split 0.1 -> 3 items
    seen = {}
    _capture_init(monkeypatch, seen)
    cfg = load_config(None, {
        "train": {"model": "denoiser", "batch_size": 8, "num_epochs": 1,
                  "data_parallel": 2,
                  "checkpoint_dir": str(tmp_path / "ck"),
                  "log_dir": str(tmp_path / "runs")},
        "data": {"data_dir": str(data), "chunk_duration": CHUNK / SR},
        "denoiser": {"features": list(FEATURES)}})
    _ranks(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="stop-before-train"):
        T.train_from_config(cfg, device="cpu")
    assert seen[0]["batch"] == 4
    assert seen[0]["val_bs"] == 3


def test_maybe_resume_multi_host_agreement(tmp_path, monkeypatch):
    """Non-primary ranks load exactly the checkpoint rank 0 broadcast,
    and raise (no silent divergence) when they cannot."""
    tr = _trainer(tmp_path)
    tr.epoch = 5
    tr.save_checkpoint("checkpoint_epoch_5.pth")

    sent = {}
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "is_primary", lambda: True)
    monkeypatch.setattr(dist, "broadcast_from_primary",
                        lambda s: sent.setdefault("name", s))
    tr2 = _trainer(tmp_path, data_parallel=2)
    assert tr2.maybe_resume() and tr2.epoch == 5
    assert sent["name"] == "checkpoint_epoch_5.pth"

    # non-primary: loads the broadcast name, ignoring its own walk
    monkeypatch.setattr(dist, "is_primary", lambda: False)
    monkeypatch.setattr(dist, "broadcast_from_primary",
                        lambda s: "checkpoint_epoch_5.pth")
    tr3 = _trainer(tmp_path, data_parallel=2)
    assert tr3.maybe_resume() and tr3.epoch == 5

    # a non-primary rank that cannot read the agreed file raises
    monkeypatch.setattr(dist, "broadcast_from_primary",
                        lambda s: "checkpoint_epoch_99.pth")
    tr4 = _trainer(tmp_path, data_parallel=2)
    with pytest.raises(Exception):
        tr4.maybe_resume()

    # nothing to resume: every rank starts fresh
    monkeypatch.setattr(dist, "broadcast_from_primary", lambda s: "")
    assert not _trainer(tmp_path, data_parallel=2).maybe_resume()


def test_interrupt_is_agreed_every_50_steps(monkeypatch):
    """Several processes: the loop asks the ranks at steps 0, 50, ...
    and stops only on an agreed flag, so no rank leaves a step's
    collectives early."""
    class Many(Toy):
        def __init__(self):
            super().__init__(n=4 * 51)

    votes = []
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "agree_flag",
                        lambda flag: votes.append(flag) or len(votes) == 2)
    tr = _trainer(data_parallel=2)
    tr.train_loader = DataLoader(Many(), 4, seed=0)
    steps = []
    monkeypatch.setattr(tr, "_train_step",
                        lambda batch, gen=None: steps.append(1) or
                        {"loss": torch.zeros(())})
    tr.train_epoch()
    assert votes == [False, False] and len(steps) == 50
    assert tr.interrupted
    # the epoch-end check is agreed too
    votes.clear()
    tr.interrupted = False
    monkeypatch.setattr(dist, "agree_flag", lambda flag: True)
    assert tr._interrupted_all() is True


# ------------------------------------------------------------ vs JAX
def test_jax_dp4_step_equals_the_ports_one_process_step(jax_draws_patch):
    """JAX's dp=4 sharded step (global-batch BN and all-reduced gradients
    by SPMD) on the virtual CPU mesh against the port's one-process step on
    the same batch of 4 with JAX's draws."""
    lr = 1e-3
    _, (params, state) = jax_model("denoiser", 0,
                                   np.random.default_rng(0),
                                   features=FEATURES)
    model = port_model("denoiser", params, state)
    tr = T.Trainer("denoiser", model, None, None,
                   config=TrainConfig(model="denoiser", learning_rate=lr),
                   pairing="degrade", device="cpu")
    jtr = JTrainer("denoiser", params, state,
                   JDataLoader(Toy(), 4, num_workers=1, seed=0), None,
                   config=JTrainConfig(model="denoiser", learning_rate=lr,
                                       data_parallel=4),
                   pairing="degrade")
    assert jtr.mesh.shape["data"] == 4
    batch = {"clean": clean_batch(4, 1, CHUNK, 3) * 4.0}
    key = jax.random.PRNGKey(1)
    new_state, jmetrics = jtr._train_step(
        jtr.state, shard_batch(jtr.mesh, batch), key)
    jax_draws_patch(jax.random.split(key)[0])  # the step's data key
    metrics = tr._train_step(batch)
    want_loss = float(jmetrics["loss"])
    assert abs(float(metrics["loss"]) - want_loss) < 1e-4 * max(
        1.0, abs(want_loss))
    want = state_dict_from_jax("denoiser", new_state["params"],
                               new_state["model_state"])
    for n, v in tr.model.state_dict().items():
        if n.endswith("num_batches_tracked"):
            continue
        bar = 1e-4 if n.endswith(("running_mean", "running_var")) else 2e-3
        np.testing.assert_allclose(v.numpy(), np.asarray(want[n]), atol=bar,
                                   err_msg=n)

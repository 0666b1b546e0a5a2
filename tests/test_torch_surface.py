"""The port covers the JAX package's surface: every name in the `__all__`
of each JAX subpackage has a counterpart in the port's subpackage of the
same name, every exported callable takes JAX's parameter names, and every
JAX CLI subcommand and option exists in the port's parser. The exceptions
are listed below, each with why."""
import argparse
import importlib
import inspect

import pytest

SUBPACKAGES = ("acquire", "audio", "compat", "data", "losses", "models",
               "ops", "parallel", "pipeline", "train", "utils")

# Deliberate non-ports (ROADMAP §1 "These are not port items"):
NON_PORTS = {
    # ops/packed.py beyond int8: the packed (space-to-depth) layouts undo
    # the TPU's 128-lane padding; the port computes the plain path, and
    # keeps ops/packed.py for the int8 forwards only
    "ops.batch_norm_train_packed",
    # compat/torch_loader.py and compat/torch_saver.py convert .pth files
    # into and out of JAX pytrees; the port loads .pth into its modules
    # (compat.load_pth) and has their mapping as state_dict_from_jax /
    # jax_from_state_dict
    "compat.load_state_dict", "compat.load_model", "compat.CONVERTERS",
    "compat.convert_denoiser", "compat.convert_super_resolution",
    "compat.convert_stereo_separator", "compat.EXPORTERS",
    "compat.export_denoiser", "compat.export_super_resolution",
    "compat.export_stereo_separator",
    # utils/profiling.py's StepTimer: rolling host-clock step times, which
    # nothing read; the program's spans (annotate, spans) replace it
    "utils.StepTimer",
}
# Names whose counterpart has another name: the JAX package's mesh
# shardings are NamedSharding objects XLA's partitioner reads; the port's
# mesh places tensors itself, so their counterparts are the functions that
# do the placing.
RENAMED = {
    "parallel.batch_sharding": "shard_batch",
    "parallel.replicated": "replicate",
    "parallel.time_sharding": "time_shards",
}
# Also not ported, with no name in any __all__: utils/cache.py (XLA's
# compile cache; the port's build cache is ops/_build.py) and the grouped
# int8 dual decoder (apply_packed(grouped=True), which no production route
# takes).
COMMANDS = ("restore", "stream", "serve", "train", "analyze", "evaluate",
            "export", "acquire")

# Parameters that differ by design, {key: (JAX's names the port lacks, the
# port's names JAX lacks)}. Every other exported callable takes JAX's
# parameter names, the positional ones in JAX's order, so a JAX call binds
# the same way in the port. Defaults are not compared: the port's are
# torch dtypes and its own config objects.
SIGNATURE_DIFFERENCES = {
    # torch.Generators in place of jax.random keys; the item function
    # passes its keywords on to simulate_batch through **kwargs, where
    # JAX's simulate_batch passes them the other way
    "data.simulate_vinyl_artifacts": (
        ("key", "filter_mode", "max_pops", "overrides"),
        ("generator", "kwargs")),
    "data.simulate_batch": (("key", "kwargs"),
                            ("generator", "filter_mode", "overrides",
                             "max_pops")),
    "ops.lstm_init": (("key",), ("generator",)),
    # a module where JAX has a pytree of parameters (and its state)
    "models.count_params": (("tree",), ("model",)),
    "compat.save_pth": (("params", "state"), ("sd",)),
    "parallel.replicate": (("tree",), ("module",)),
    "parallel.replicated": ((), ("module",)),
    # the port's mesh places tensors itself: the counterparts of JAX's
    # shardings take what they place (RENAMED above), and shard_batch,
    # which is also batch_sharding's counterpart, takes any tensor
    "parallel.batch_sharding": ((), ("x",)),
    "parallel.shard_batch": (("batch",), ("x",)),
    "parallel.time_sharding": ((), ("length", "grid")),
    # the global batch statistics go through torch.distributed, not a
    # named mesh axis (parallel/distributed.py)
    "ops.batch_norm_train": (("axis_name",), ()),
    # JAX picks the recurrence's Pallas kernel or lax.scan and its unroll;
    # the port's recurrence is picked by the tensor's device. The port's
    # ops.lstm is the submodule: the function is ops.lstm.lstm
    "ops.lstm": (("unroll", "impl"), ()),
    # entry points run on the card unless the caller asks for the CPU
    "ops.hann_window": ((), ("device",)),
    "ops.crossfade_window": ((), ("device",)),
    "parallel.initialize": ((), ("device",)),
    # ... and the port's restore path has a fourth stage, BS-RoFormer, that
    # the JAX package lacks (streaming refuses it)
    "pipeline.RestorationPipeline": ((), ("device", "enhancer")),
    "pipeline.restore_audio": ((), ("device",)),
    "pipeline.StreamingRestorer": ((), ("device", "enhancer")),
    # the time-sharded serving path upsamples a window of a recording
    # (parallel/seq.py); the trainer reads its metrics from moments
    # reduced across ranks
    "ops.upsample_linear": ((), ("offset", "total")),
    "losses.stereo_metrics": ((), ("moments",)),
    # the port's spans carry the counts of the work they cover, and time
    # the device where a reader takes device ms
    "utils.annotate": ((), ("device_ms", "counts")),
}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_exported_name_has_a_counterpart(sub):
    jax_pkg = importlib.import_module(f"ml_audio_restoration_tpu.{sub}")
    port = importlib.import_module(f"ml_audio_restoration_torch.{sub}")
    missing = []
    for name in jax_pkg.__all__:
        key = f"{sub}.{name}"
        if key in NON_PORTS:
            continue
        if not hasattr(port, RENAMED.get(key, name)):
            missing.append(name)
    assert not missing, f"{sub}: no counterpart for {missing}"


def test_exception_lists_name_real_jax_names():
    """Each listed exception is a JAX export the port still lacks under
    that name, so the lists cannot go stale silently."""
    for key in NON_PORTS | set(RENAMED):
        sub, name = key.split(".")
        assert name in importlib.import_module(
            f"ml_audio_restoration_tpu.{sub}").__all__, key
        assert not hasattr(importlib.import_module(
            f"ml_audio_restoration_torch.{sub}"), name), key


def _counterpart(key):
    sub, name = key.split(".")
    port = getattr(importlib.import_module(
        f"ml_audio_restoration_torch.{sub}"), RENAMED.get(key, name))
    if inspect.ismodule(port):   # ops.lstm (SIGNATURE_DIFFERENCES)
        port = getattr(port, name)
    return port


def _signature(fn, drop=()):
    """(positional names in order, the other names as a set) of fn's
    parameters, without the names in `drop`."""
    params = [p for p in inspect.signature(fn).parameters.values()
              if p.name not in drop]
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    return ([p.name for p in params if p.kind in positional],
            {p.name for p in params if p.kind not in positional})


def _exported_callables(sub):
    jax_pkg = importlib.import_module(f"ml_audio_restoration_tpu.{sub}")
    for name in jax_pkg.__all__:
        key = f"{sub}.{name}"
        if key not in NON_PORTS and callable(getattr(jax_pkg, name)):
            yield key, getattr(jax_pkg, name)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_exported_callable_takes_jax_parameter_names(sub):
    differ = {}
    for key, jax_fn in _exported_callables(sub):
        lacks, adds = SIGNATURE_DIFFERENCES.get(key, ((), ()))
        want = _signature(jax_fn, lacks)
        got = _signature(_counterpart(key), adds)
        if got != want:
            differ[key] = (want, got)
    assert not differ, differ


def test_signature_differences_name_real_differences():
    """Each listed difference is one: JAX's callable has each name the
    port is said to lack and the port's has not, and the other way round,
    so the list cannot go stale silently."""
    jax_fns = {key: fn for sub in SUBPACKAGES
               for key, fn in _exported_callables(sub)}
    for key, (lacks, adds) in SIGNATURE_DIFFERENCES.items():
        assert lacks or adds, key
        want = set(inspect.signature(jax_fns[key]).parameters)
        got = set(inspect.signature(_counterpart(key)).parameters)
        assert set(lacks) <= want - got, (key, lacks)
        assert set(adds) <= got - want, (key, adds)


def _options(cli):
    """{command: {option strings and positional dests}} of a CLI module's
    subcommand parsers."""
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command")
    out = {}
    for command in COMMANDS:
        p = getattr(cli, f"_add_{command}")(sub)
        out[command] = {s for a in p._actions
                        for s in (a.option_strings or [a.dest])}
    return out


def test_every_cli_command_and_option_exists_in_the_port():
    from ml_audio_restoration_tpu import cli as jcli
    from ml_audio_restoration_torch import cli

    want, got = _options(jcli), _options(cli)
    missing = {c: sorted(want[c] - got[c]) for c in COMMANDS
               if want[c] - got[c]}
    assert not missing, missing

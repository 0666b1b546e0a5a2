"""The port covers the JAX package's surface: every name in the `__all__`
of each JAX subpackage has a counterpart in the port's subpackage of the
same name, and every JAX CLI subcommand and option exists in the port's
parser. The exceptions are listed below, each with why."""
import argparse
import importlib

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

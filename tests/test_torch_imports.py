"""The port, chip_smoke.py and the port's scripts on the card (the kernel
ablation and the train-step A/B) import nothing of JAX or the JAX
package, nor flax or msgpack, which the card's machine lacks (the port
reads flax's msgpack files with its own compat/msgpack.py)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_audio_restoration_tpu", "flax", "msgpack")
FILES = sorted((ROOT / "ml_audio_restoration_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_lstm_ablation.py",
    ROOT / "scripts" / "torch_train_ab.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imports(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_package():
    assert len(FILES) > 15

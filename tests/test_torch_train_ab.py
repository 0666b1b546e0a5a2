"""scripts/torch_train_ab.py drives chip_smoke.py's train phase through a
`python -c` string in each checkout: the call it makes must bind to the
phase's signature in this one."""
import ast
import inspect
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_run_string_binds_to_the_train_phase(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    import torch_train_ab

    calls = [node for node in ast.walk(ast.parse(torch_train_ab.RUN))
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and isinstance(node.func.value, ast.Name)
             and node.func.value.id == "chip_smoke"]
    assert [c.func.attr for c in calls] == ["phase_train_full"]
    call = calls[0]
    phase = getattr(chip_smoke, call.func.attr)
    inspect.signature(phase).bind(*call.args, **{k.arg: k.value
                                                 for k in call.keywords})

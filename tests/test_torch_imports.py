"""Import guard: the port and its scripts for the card (chip_smoke.py,
kernels_ab.py) import torch, never JAX or the JAX package — the machine
with the card has neither, nor pandas, scikit-learn, flax, optax or
msgpack."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "pandas", "sklearn", "msgpack",
             "segmminterest_tpu")
FILES = sorted((ROOT / "segmminterest_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernels_ab.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_has_modules():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_segrec_modules_guarded():
    """SegRec's modules (and the optimizers they share) are among the
    guarded files."""
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for m in ("segrec/__init__", "segrec/corpus", "segrec/feeds",
              "segrec/layers", "segrec/runner", "segrec/main",
              "segrec/models/__init__", "segrec/models/cliprec",
              "segrec/models/din", "segrec/models/widedeep",
              "engine/optim"):
        assert f"segmminterest_tpu_torch/{m}.py" in names, m

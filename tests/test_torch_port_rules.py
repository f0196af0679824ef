"""The port stands alone: nothing under ``mx_rcnn_tpu_torch/`` and nothing
in ``chip_smoke.py`` imports jax, flax or the JAX package, nor cv2, which
the card's machine lacks (an AST scan of every import statement,
including imports inside functions)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mx_rcnn_tpu", "cv2")
PORT_FILES = sorted((ROOT / "mx_rcnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port_and_catches_a_violation(tmp_path):
    assert len(PORT_FILES) > 20
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from mx_rcnn_tpu.ops import nms\n    import jax.numpy\n"
                   "    import cv2\n")
    assert [m for m in _imported_modules(bad) if _forbidden(m)] == ["mx_rcnn_tpu.ops", "jax.numpy",
                                                                   "cv2"]
    assert not _forbidden("mx_rcnn_tpu_torch.ops")

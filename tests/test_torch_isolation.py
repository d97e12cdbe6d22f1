"""The port and chip_smoke.py import neither JAX nor the JAX package:
an AST scan of every import statement, at any depth."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vqa_project_tpu")
FILES = sorted((ROOT / "vqa_project_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "vqa_project_tpu_torch/serve.py" in names
    assert "vqa_project_tpu_torch/ops/edge_aggregate.py" in names
    assert "vqa_project_tpu_torch/ops/graph_block.py" in names
    assert "vqa_project_tpu_torch/cli/run.py" in names
    assert "vqa_project_tpu_torch/data/zarr_store.py" in names
    assert "vqa_project_tpu_torch/data/native/__init__.py" in names
    assert "vqa_project_tpu_torch/cli/serve.py" in names
    assert "vqa_project_tpu_torch/cli/export_torch.py" in names
    assert "vqa_project_tpu_torch/cli/validate_parity.py" in names
    assert "vqa_project_tpu_torch/ops/quant.py" in names
    for module in ("cli/medical.py", "cli/run_imageclef.py",
                   "cli/run_mimic.py", "data/synthetic_medical.py",
                   "data/preprocess/medical.py", "train/profiling.py",
                   "viz/plots.py", "viz/cv2_plots.py", "cli/plot.py",
                   "utils/__init__.py", "data/preprocess/text.py",
                   "data/preprocess/image_features.py",
                   "data/yolo/loaders.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/multihost.py",
                   "parallel/sharded_cache.py"):
        assert f"vqa_project_tpu_torch/{module}" in names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"

"""What the reference and the card path load, by whole top-level module name."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "lmms_owc_tpu"}


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_either_package():
    tops = _loaded("import sys; sys.path.insert(0, '.')\n"
                   "from owcbench.reference import qwen2_vl\nfrom owcbench import tokenizer, roofline, weights")
    assert not tops & (JAX | {"lmms_owc_tpu_torch"}), tops & (JAX | {"lmms_owc_tpu_torch"})


def test_the_card_path_loads_the_port_and_nothing_of_jax():
    tops = _loaded("import sys; sys.path.insert(0, '.')\n"
                   "from owcbench import harness, trace\nimport lmms_owc_tpu_torch.models\n"
                   "import lmms_owc_tpu_torch.nn.qwen2_vl, lmms_owc_tpu_torch.utils._hostprof\n"
                   "print(sorted(harness.excluded_modules()))")
    assert "lmms_owc_tpu_torch" in tops and not tops & JAX, tops & JAX


def test_whole_names_are_compared():
    from owcbench import harness

    sys.modules.setdefault("lmms_owc_tpu_torch_fake", type(sys)("lmms_owc_tpu_torch_fake"))
    try:
        assert "lmms_owc_tpu_torch_fake" not in harness.excluded_modules()
    finally:
        del sys.modules["lmms_owc_tpu_torch_fake"]


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in (REPO / "owcbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in JAX, f"{path}: imports {name}"
                if "reference" in path.parts:
                    assert name.split(".")[0] != "lmms_owc_tpu_torch", f"{path}: imports {name}"

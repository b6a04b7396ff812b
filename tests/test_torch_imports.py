"""The port imports nothing of the JAX package, and its copies of the JAX
package's host helpers behave as the originals on the same inputs.

The static test walks the AST of every module of ``lmms_owc_tpu_torch`` and of
``chip_smoke.py``; the parity tests (which may import ``lmms_owc_tpu``; the port
may not) hold ``lmms_owc_tpu_torch.utils``, ``.schema`` and ``.native`` to
``lmms_owc_tpu.utils``, ``.schema`` and ``.native``. A CLI run in a subprocess
loads neither ``jax`` nor ``lmms_owc_tpu``.
"""

import ast
import dataclasses
import random
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lmms_owc_tpu import schema as jax_schema
from lmms_owc_tpu import utils as jax_utils
from lmms_owc_tpu_torch import schema, utils

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO_ROOT / "lmms_owc_tpu_torch").rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]


# Packages the port may not depend on. The card's machine promises torch,
# triton, numpy, scipy, einops, pytest and hypothesis; its other packages vary:
# one check found no transformers, safetensors, tokenizers or regex, a later
# one found them (and PyYAML, jinja2, tqdm, dill, datasets, pyarrow) but no
# sklearn, sacrebleu or Levenshtein. So the port reads checkpoints and
# tokenizes with its own code (``nn/loader.py``, ``tokenizer.py``) and computes
# f1/mcc and edit distances with numpy and Python. The engine imports PyYAML,
# jinja2, tqdm, dill and datasets as the JAX package does, and the offline
# scoring CLIs pandas (a dependency of datasets).
ABSENT_ON_THE_CARD = ("jax", "transformers", "safetensors", "tokenizers", "regex", "sklearn", "Levenshtein")
# Packages the port imports only inside a ``try`` that handles ImportError
# (``huggingface_hub`` is not one of them: ``datasets`` depends on it). spaCy
# serves concept extraction when it and its model are installed.
OPTIONAL = ("sacrebleu", "wandb", "spacy")


def _optional(tree: ast.AST) -> set[int]:
    """ids of the import nodes inside a ``try`` with an ``ImportError`` or
    ``ModuleNotFoundError`` handler: optional imports, whose absence the code handles."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        names = []
        for h in node.handlers:
            types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
            names += [getattr(t, "id", None) for t in types if t is not None]
        if any(n in ("ImportError", "ModuleNotFoundError") for n in names):
            out |= {id(n) for stmt in node.body for n in ast.walk(stmt) if isinstance(n, (ast.Import, ast.ImportFrom))}
    return out


def _imports_of(path: Path, roots: tuple[str, ...], optional_ok: bool = False) -> list[str]:
    """Every import in the file that names one of ``roots`` or one of their
    modules (with ``optional_ok``, not those inside a ``try`` that handles ImportError)."""
    found = []
    tree = ast.parse(path.read_text(), filename=str(path))
    skip = _optional(tree) if optional_ok else set()
    for node in ast.walk(tree):
        if id(node) in skip:
            continue
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if any(n == root or n.startswith(root + ".") for root in roots)]
    return found


def _jax_package_imports(path: Path) -> list[str]:
    """Every import in the file that names ``lmms_owc_tpu`` or one of its modules."""
    return _imports_of(path, ("lmms_owc_tpu",))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_port_module_imports_no_jax_package(path):
    assert _jax_package_imports(path) == []
    assert _imports_of(path, ABSENT_ON_THE_CARD) == []
    assert _imports_of(path, OPTIONAL, optional_ok=True) == []


def test_static_check_sees_absent_packages(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import regex\nfrom safetensors import safe_open\nfrom transformers.models import x\n"
        "def f():\n    import tokenizers\nimport jax.numpy as jnp\nimport regexp, safetensors_x\n"
        "try:\n    import jax\nexcept ImportError:\n    jax = None\n"
        "try:\n    import wandb\nexcept ImportError:\n    wandb = None\n"
        "try:\n    import sacrebleu\nexcept Exception:\n    pass\n"
        "try:\n    from wandb import sdk\nexcept ValueError:\n    pass\n"
        "import sklearn.metrics\n"
        "import spacy\n"
        "def g():\n    try:\n        import spacy\n    except ImportError:\n        return None\n"
    )
    # A guarded import of a package the port may not depend on is still found.
    assert sorted(x.split()[-1] for x in _imports_of(src, ABSENT_ON_THE_CARD)) == [
        "jax", "jax.numpy", "regex", "safetensors", "sklearn.metrics", "tokenizers", "transformers.models"]
    # An optional package is allowed only under an ImportError handler.
    assert sorted(x.split()[-1] for x in _imports_of(src, OPTIONAL, optional_ok=True)) == [
        "sacrebleu", "spacy", "wandb"]


def test_static_check_sees_jax_package_imports(tmp_path):
    """The checker itself: it finds each import form, and not the port's own name."""
    src = tmp_path / "m.py"
    src.write_text(
        "import lmms_owc_tpu\nimport os, lmms_owc_tpu.native as n\n"
        "from lmms_owc_tpu.utils import Collator\nfrom lmms_owc_tpu import schema\n"
        "def f():\n    from lmms_owc_tpu.native import loader\n"
        "import lmms_owc_tpu_torch\nfrom lmms_owc_tpu_torch.utils import Collator\nfrom . import x\n"
    )
    assert len(_jax_package_imports(src)) == 5
    assert len(PORT_FILES) > 15


# ------------------------------------------------------------------ collation


def _requests(rng: random.Random, n: int) -> list:
    kwargs = [{"max_new_tokens": 16}, {"max_new_tokens": 64, "until": ["\n"]}, {"max_new_tokens": 16}]
    return [("x" * rng.randint(1, 60), kwargs[rng.randint(0, 2)], i) for i in range(n)]


@pytest.mark.parametrize("group_by", [None, "gen_kwargs"])
@pytest.mark.parametrize("n", [0, 1, 3, 8])
def test_collator_order_and_chunks_match_jax(group_by, n):
    rng = random.Random(n * 7 + (group_by is None))
    reqs = _requests(rng, 23)
    chunks = {}
    for name, cls in (("port", utils.Collator), ("jax", jax_utils.Collator)):
        col = cls(reqs, sort_fn=lambda x: -len(x[0]), group_fn=lambda x: x[1], group_by=group_by)
        batches = list(col.get_batched(n=n))
        flat = [r for b in batches for r in b]
        chunks[name] = (len(col), batches, col.get_original([r[2] for r in flat]))
    assert chunks["port"] == chunks["jax"]
    assert chunks["port"][2] == list(range(23))


def test_collator_batch_fn_matches_jax():
    """A token-budget ``batch_fn`` (as the adapter's) gives the same chunks."""
    reqs = _requests(random.Random(3), 30)

    def budget(done, item):
        return max(1, 120 // len(item[0]))

    out = {}
    for name, cls in (("port", utils.Collator), ("jax", jax_utils.Collator)):
        col = cls(reqs, sort_fn=lambda x: -len(x[0]), group_fn=lambda x: x[1], group_by="gen_kwargs")
        out[name] = list(col.get_batched(n=0, batch_fn=budget))
    assert out["port"] == out["jax"] and len(out["port"]) > 3


def test_pad_to_bucket_matches_jax():
    assert utils.DEFAULT_LENGTH_BUCKETS == jax_utils.DEFAULT_LENGTH_BUCKETS
    for length in range(0, 9000, 7):
        assert utils.pad_to_bucket(length) == jax_utils.pad_to_bucket(length)
    custom = (8, 16, 24, 64)
    for length in range(0, 80):
        assert utils.pad_to_bucket(length, custom) == jax_utils.pad_to_bucket(length, custom)


# ------------------------------------------------------------ chunk pipeline


@pytest.mark.parametrize("with_finish", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_foreach_chunk_pipelined_matches_jax(with_finish, depth):
    chunks = [list(range(i, i + 3)) for i in range(0, 15, 3)]

    def run_with(fn):
        log = []

        def prepare(chunk):
            return [x * 10 for x in chunk]

        def run(chunk, prepared):
            log.append(("run", chunk[0]))
            return [p + 1 for p in prepared]

        def finish(chunk, handle):
            log.append(("finish", chunk[0]))
            return [h * 2 for h in handle]

        out = fn(chunks, prepare, run, depth=depth, finish=finish if with_finish else None)
        return out, log

    got, want = run_with(utils.foreach_chunk_pipelined), run_with(jax_utils.foreach_chunk_pipelined)
    assert got == want
    assert utils.foreach_chunk_pipelined([], None, None) == jax_utils.foreach_chunk_pipelined([], None, None) == []


def test_get_logger_matches_jax():
    port, ref = utils.get_logger("owc.port.test"), jax_utils.get_logger("owc.jax.test")
    assert port.level == ref.level and port.propagate == ref.propagate is False
    assert [h.formatter._fmt for h in port.handlers] == [h.formatter._fmt for h in ref.handlers]
    assert utils.get_logger("owc.port.test") is port


# -------------------------------------------------------------------- schema


def test_model_info_fields_match_jax():
    jax_fields = jax_schema.ModelInfo.model_fields
    port_fields = {f.name: f for f in dataclasses.fields(schema.ModelInfo)}
    assert list(port_fields) == list(jax_fields)
    for name, f in port_fields.items():
        required = f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
        assert required == jax_fields[name].is_required(), name
        if not required:
            assert f.default == jax_fields[name].default, name
        assert f.repr == jax_fields[name].repr, name

    def build():
        """A builder."""

    port = schema.ModelInfo(name="m", model_cls=build, description="d")
    ref = jax_schema.ModelInfo(name="m", model_cls=build, description="d")
    assert (port.name, port.model_cls, port.description) == (ref.name, ref.model_cls, ref.description)
    assert schema.ModelInfo(name="m", model_cls=build).description == ""
    with pytest.raises(TypeError):
        schema.ModelInfo(name="m")


# -------------------------------------------------------------------- native


def _have_native_toolchain() -> str | None:
    if shutil.which("g++") is None:
        return "g++ is not installed"
    if not any(Path(d, "jpeglib.h").exists() for d in ("/usr/include", "/usr/local/include")):
        return "libjpeg headers are missing, so the JAX package's loader does not build"
    return None


@pytest.fixture(scope="module")
def resizers():
    reason = _have_native_toolchain()
    if reason:
        pytest.skip(reason)
    from lmms_owc_tpu.native import NativeImageLoader, native_loader_available
    from lmms_owc_tpu_torch.native import BUILD_DIR, native_resizer

    port = native_resizer()
    assert port is not None, "the port's resizer did not build"
    assert Path(port._lib._name).parent == BUILD_DIR
    if not native_loader_available():
        pytest.skip("the JAX package's native loader did not build")
    return port, NativeImageLoader(num_workers=1)


@pytest.mark.parametrize("in_hw,out_hw", [((100, 80), (56, 84)), ((300, 451), (224, 336)), ((57, 61), (112, 140))])
def test_native_resize_matches_jax(resizers, in_hw, out_hw):
    port, ref = resizers
    arr = np.random.RandomState(sum(in_hw)).randint(0, 255, (*in_hw, 3), dtype=np.uint8)
    np.testing.assert_array_equal(port.resize_u8(arr, *out_hw), ref.resize_u8(arr, *out_hw))


def test_resize_host_native_switch(monkeypatch):
    """``resize_host`` takes the port's resizer when it builds, and PIL under
    ``LMMS_OWC_NATIVE_LOADER=0`` or when it does not (the JAX package's rule)."""
    from PIL import Image

    from lmms_owc_tpu_torch.native import native_resizer
    from lmms_owc_tpu_torch.ops.image import resize_host

    arr = np.random.RandomState(9).randint(0, 255, (90, 130, 3), dtype=np.uint8)
    img = Image.fromarray(arr)
    got, hw = resize_host(img)
    assert got.shape == (3, *hw) and hw != (90, 130)
    pil = np.asarray(img.resize((hw[1], hw[0]), Image.BICUBIC)).transpose(2, 0, 1)
    native = native_resizer()
    np.testing.assert_array_equal(got, native.resize_u8(arr, *hw) if native is not None else pil)
    monkeypatch.setenv("LMMS_OWC_NATIVE_LOADER", "0")
    np.testing.assert_array_equal(resize_host(img)[0], pil)


# ------------------------------------------------------------ host helpers


def test_core_helpers_match_jax():
    rng = random.Random(11)
    for args in ["", "a=1,b=true,c=None,d=0.5,e=x y", "pretrained=/p/q,dtype=bfloat16,load_in_8bit=True", "k="]:
        assert utils.parse_string_args(args) == jax_utils.parse_string_args(args)
    names = ["toy", "toy_mc", "toy_multiround", "caltech101", "cub_200"]
    for pattern in (["toy*"], ["toy", "cub_*"], ["nothing"], "toy_m?"):
        assert utils.pattern_match(pattern, names) == jax_utils.pattern_match(pattern, names)
    for text in ["", "a", "pretrained=/x/y:z|w", "é" * 60, "name with spaces?*"]:
        for fn in ("hash_string", "sanitize_model_name", "sanitize_task_name", "sanitize_long_string"):
            assert getattr(utils, fn)(text) == getattr(jax_utils, fn)(text), fn
    docs = [{"i": i, "x": rng.random()} for i in range(20)]
    for rank, world, limit in [(0, 1, None), (1, 3, 10), (2, 4, 7)]:
        assert list(utils.create_iterator(iter(docs), rank, world, limit)) == list(
            jax_utils.create_iterator(iter(docs), rank, world, limit))
    value = {"a": np.float32(1.5), "b": np.arange(3), "c": {1, 2}, "d": object}
    assert utils.json_dumps_deterministic(value) == jax_utils.json_dumps_deterministic(value)
    progress = list(utils.get_progress_bar(iterable=iter(range(5)), total=5))
    assert progress == list(range(5))


def test_make_table_matches_jax():
    results = {
        "results": {"toy": {"alias": "toy", "exact_match,none": 0.25, "exact_match_stderr,none": 0.125,
                            "textual_inclusion,none": 1, "textual_inclusion_stderr,none": "N/A"},
                    "toy_mc": {"alias": "toy_mc", "acc,none": 0.5}},
        "versions": {"toy": "Yaml", "toy_mc": "Yaml"}, "n-shot": {"toy": 0, "toy_mc": 2},
        "higher_is_better": {"toy": {"exact_match": True}, "toy_mc": {"acc": False}},
    }
    for sort in (False, True):
        assert utils.make_table(results, sort_results=sort) == jax_utils.make_table(results, sort_results=sort)


def _named(value):
    """``value`` with each function replaced by its name (imported twice, they differ as objects)."""
    if callable(value):
        return ("fn", value.__module__.rsplit("_", 1)[-1], value.__name__)
    if isinstance(value, dict):
        return {k: _named(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_named(v) for v in value]
    return value


def test_load_yaml_config_matches_jax(toy_task_path):
    """``include:`` merges and ``!function`` tags, in both modes."""
    for path in sorted(Path(toy_task_path).rglob("*.yaml")):
        for mode in ("simple", "full"):
            got = utils.load_yaml_config(path, mode=mode)
            want = jax_utils.load_yaml_config(path, mode=mode)
            assert _named(got) == _named(want), path


YAML_FILES = sorted((REPO_ROOT / "tests" / "fixtures" / "tasks").rglob("*.yaml")) + sorted(
    (REPO_ROOT / "lmms_owc_tpu" / "tasks" / "configs").rglob("*.yaml"))


def test_load_yaml_config_matches_jax_on_every_task_config():
    """Every task config of both trees, ``!function`` tags left as their specs."""
    assert len(YAML_FILES) > 100
    for path in YAML_FILES:
        assert utils.load_yaml_config(path, mode="simple") == jax_utils.load_yaml_config(path, mode="simple"), path


def test_cli_run_loads_no_jax(tmp_path, toy_dataset):
    """A port CLI run of the fake model on ``toy``, and one with
    ``--check_integrity`` (which the port refuses), leave no ``jax`` or
    ``lmms_owc_tpu*`` module (other than the port) in ``sys.modules``."""
    code = (
        "import sys\n"
        "from lmms_owc_tpu_torch.eval_model import main\n"
        "try:\n"
        "    main(['--model', 'fake', '--tasks', 'toy', '--check_integrity',"
        f" '--include_path', {str(REPO_ROOT / 'tests' / 'fixtures' / 'tasks')!r}, '--limit', '2'])\n"
        "    raise SystemExit('--check_integrity did not raise')\n"
        "except NotImplementedError:\n"
        "    pass\n"
        f"main(['--model', 'fake', '--model_args', 'response_mode=target', '--tasks', 'toy,toy_mc,toy_multiround',"
        f" '--include_path', {str(REPO_ROOT / 'tests' / 'fixtures' / 'tasks')!r}, '--limit', '2', '--log_samples',"
        f" '--output_path', {str(tmp_path)!r}])\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib') or k.startswith(('jax.', 'jaxlib.'))\n"
        "             or (k.startswith('lmms_owc_tpu') and not k.startswith('lmms_owc_tpu_torch')))\n"
        "assert not bad, bad\n"
        f"absent = sorted(k for k in sys.modules if k.split('.')[0] in {ABSENT_ON_THE_CARD!r})\n"
        "assert not absent, absent\n"
        "print('CLI_NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLI_NO_JAX_OK" in proc.stdout
    assert len(list(tmp_path.rglob("*_results.json"))) == 1


def test_scoring_modules_load_no_jax(tmp_path):
    """Importing the scoring modules and scoring through their fallbacks (the
    aggregations and ``eval_metrics``) leave no ``jax``, ``lmms_owc_tpu`` or
    ``ABSENT_ON_THE_CARD`` module in ``sys.modules``."""
    (tmp_path / "toy" / "m").mkdir(parents=True)
    (tmp_path / "toy" / "m" / "x_samples_toy.jsonl").write_text(
        '{"doc_id": 0, "target": "cat", "filtered_resps": ["a cat"]}\n'
        '{"doc_id": 1, "target": "dog", "filtered_resps": ["a red dog"]}\n')
    code = (
        "import sys, os\n"
        "os.environ.pop('LMMS_OWC_SBERT_PATH', None); os.environ.pop('LMMS_OWC_JUDGE_PATH', None)\n"
        "import lmms_owc_tpu_torch.nn.sbert, lmms_owc_tpu_torch.nn.llama, lmms_owc_tpu_torch.nn.judge\n"
        "from lmms_owc_tpu_torch import eval_metrics, eval_ranking\n"
        "from lmms_owc_tpu_torch.metrics import get_aggregation_builder\n"
        "items = [('cat', ['a cat']), ('dog', ['red dog'])]\n"
        "for name in ('semantic_similarity', 'concept_semantic_similarity', 'mean_average_semantic_similarity',"
        " 'textual_inclusion_llama32'):\n"
        "    get_aggregation_builder(name)(items)\n"
        f"eval_metrics.main(['-i', {str(tmp_path)!r}, '-m', 'semantic_similarity,textual_inclusion_llama32'])\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib') or k.startswith(('jax.', 'jaxlib.'))\n"
        "             or (k.startswith('lmms_owc_tpu') and not k.startswith('lmms_owc_tpu_torch')))\n"
        "assert not bad, bad\n"
        f"absent = sorted(k for k in sys.modules if k.split('.')[0] in {ABSENT_ON_THE_CARD!r})\n"
        "assert not absent, absent\n"
        "print('SCORING_NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SCORING_NO_JAX_OK" in proc.stdout


def test_clip_and_llava_modules_load_no_jax():
    """The model registry (with the LLaVA adapter) and the CLIP pipeline load
    no ``jax``, ``lmms_owc_tpu`` or ``ABSENT_ON_THE_CARD`` module, and a tiny
    LLaVA answers on the CPU without them."""
    code = (
        "import sys\n"
        "import lmms_owc_tpu_torch.models, lmms_owc_tpu_torch.pipelines.image, lmms_owc_tpu_torch.nn.anyres\n"
        "from lmms_owc_tpu_torch.models import get_model\n"
        "m = get_model('llava-tiny', batch_size=2, dtype='float32', device='cpu')\n"
        "class R:\n    def __init__(self, a): self.args = a\n"
        "assert len(m.generate_until([R(('hi', {'max_new_tokens': 2}, None, 0, 't', 's'))])) == 1\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib') or k.startswith(('jax.', 'jaxlib.'))\n"
        "             or (k.startswith('lmms_owc_tpu') and not k.startswith('lmms_owc_tpu_torch')))\n"
        "assert not bad, bad\n"
        f"absent = sorted(k for k in sys.modules if k.split('.')[0] in {ABSENT_ON_THE_CARD!r})\n"
        "assert not absent, absent\n"
        "print('LLAVA_NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LLAVA_NO_JAX_OK" in proc.stdout

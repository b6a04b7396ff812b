"""The port's whole slice against the JAX package: ``generate_until`` end to end.

The JAX adapter ``qwen2-vl-tiny`` (float32, random init) and the port's
adapter loaded from the same parameters (as numpy) answer the same requests:
host resize, vision buckets (the 56x56 toy images pad 16 patches to the
64-patch bucket, so the masked vision path runs), prompt buckets, prefill and
greedy decode. Tokens and strings must be identical.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tests.test_torch_qwen2_vl import _redraw

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def adapters():
    from lmms_owc_tpu.models import get_model as jax_get_model
    from lmms_owc_tpu_torch.models import get_model

    jax_model = jax_get_model("qwen2-vl-tiny", batch_size=4, random_init=True, dtype="float32")
    # Re-draw the weights larger than the 0.02 init so greedy tokens vary.
    tree = _redraw(jax.tree_util.tree_map(np.asarray, jax_model.params), np.random.default_rng(1))
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = get_model("qwen2-vl-tiny", batch_size=4, dtype="float32", device="cpu", jax_params=tree)
    return jax_model, port


def _record_tokens(model, monkeypatch) -> list:
    seen = []
    detok = model._detokenize

    def spy(tokens):
        seen.append(np.asarray(tokens).copy())
        return detok(tokens)

    monkeypatch.setattr(model, "_detokenize", spy)
    return seen


def _generate_both(adapters, monkeypatch, task_name, task, requests):
    outs, tokens = [], []
    for model in adapters:
        model.task_dict[task_name] = task
        seen = _record_tokens(model, monkeypatch)
        outs.append(model.generate_until(requests))
        tokens.append(seen)
    return outs, tokens


class _Req:
    def __init__(self, args):
        self.args = args


def test_toy_task_generate_until_identical(adapters, monkeypatch, toy_task_path, toy_dataset):
    from lmms_owc_tpu.tasks import TaskManager, get_tasks_as_dict

    task = get_tasks_as_dict(["toy"], TaskManager(include_path=toy_task_path, model_name="qwen2-vl-tiny"))["toy"]
    gen_kwargs = {"max_new_tokens": 16, "do_sample": False, "until": None}
    n_docs = len(task.dataset["test"])
    requests = [
        _Req((task.doc_to_text(task.dataset["test"][i]), gen_kwargs, task.doc_to_visual, i, "toy", "test"))
        for i in range(n_docs)
    ]
    (out_jax, out_port), (tok_jax, tok_port) = _generate_both(adapters, monkeypatch, "toy", task, requests)
    assert len(out_port) == n_docs and all(isinstance(s, str) and s for s in out_port)
    assert out_port == out_jax
    assert len(tok_port) == len(tok_jax) > 0
    for got, want in zip(tok_port, tok_jax):
        np.testing.assert_array_equal(got, want)
    assert len({s for s in out_port}) > 1 or len(set(np.concatenate(tok_port).ravel())) > 2


def test_mixed_sizes_generate_until_identical(adapters, monkeypatch):
    """Several patch buckets in one chunk, rows replicated up to a row bucket
    (5 same-size images -> 6 rows), prompts of different lengths and stop strings."""
    rng = np.random.RandomState(5)
    sizes = [(56, 56)] * 5 + [(112, 84), (448, 448), (200, 150)]
    docs = [{"image": Image.fromarray(rng.randint(0, 255, (*hw, 3), dtype=np.uint8))} for hw in sizes]

    class _Task:
        dataset = {"test": docs}

    gen_kwargs = {"max_new_tokens": 12, "do_sample": False, "until": ["tok1234567"]}
    contexts = ["What type of object is in this photo?", "Name it.", "Describe the scene " * 6]
    requests = [
        _Req((contexts[i % 3], gen_kwargs, lambda d: [d["image"]], i, "mixed", "test"))
        for i in range(len(docs))
    ]
    (out_jax, out_port), (tok_jax, tok_port) = _generate_both(adapters, monkeypatch, "mixed", _Task(), requests)
    assert out_port == out_jax
    for got, want in zip(tok_port, tok_jax):
        np.testing.assert_array_equal(got, want)


def test_decode_pool_raises(adapters, monkeypatch):
    """The decode pool is ported: ``LMMS_OWC_DECODE_POOL=2`` no longer raises,
    and pooled serving gives the port's unpooled answers (the pattern of
    ``tests/test_decode_pool.py``): mixed prompt buckets, so the pool
    front-pads the shorter chunk, and an empty request list."""
    _, port = adapters
    rng = np.random.RandomState(11)
    docs = [{"image": Image.fromarray(rng.randint(0, 255, (56, 56, 3), dtype=np.uint8))} for _ in range(6)]

    class _Task:
        dataset = {"test": docs}

    port.task_dict["pool"] = _Task()
    gen_kwargs = {"max_new_tokens": 8, "do_sample": False, "until": None}
    contexts = ["Describe the scene in detail. " * 12] * 2 + ["What?", "Name it.", "What is shown?", "Say it."]
    requests = [_Req((contexts[i], gen_kwargs, lambda d: [d["image"]], i, "pool", "test")) for i in range(6)]
    monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")  # chunks of 4 and 2 rows, two buckets
    monkeypatch.delenv("LMMS_OWC_DECODE_POOL", raising=False)
    base = port.generate_until(requests)
    monkeypatch.setenv("LMMS_OWC_DECODE_POOL", "2")
    assert port.generate_until([]) == []
    pooled = port.generate_until(requests)
    assert pooled == base and len(pooled) == 6


def test_unported_surfaces_raise():
    from lmms_owc_tpu_torch.models import get_model

    with pytest.raises(ValueError, match="mutually exclusive"):
        get_model("qwen2-vl-tiny", device="cpu", load_in_8bit=True, load_in_4bit=True)
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        get_model("qwen2-vl-tiny", device="cpu", pretrained="/nonexistent")


def test_registry_and_distributed_identity(adapters):
    from lmms_owc_tpu_torch.models import MODELS

    assert {"qwen2-vl-7b", "qwen2-vl-2b", "qwen2-vl-tiny"} <= set(MODELS)
    _, port = adapters
    assert (port.rank, port.world_size) == (0, 1)
    assert port.device == torch.device("cpu") and port.model.dtype == torch.float32


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import lmms_owc_tpu_torch\n"
        "from lmms_owc_tpu_torch.models import get_model\n"
        "m = get_model('qwen2-vl-tiny', batch_size=2, dtype='float32', device='cpu')\n"
        "assert m.config.hidden_size == 64\n"
        "import os\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "q = get_model('qwen2-vl-tiny', batch_size=2, dtype='float32', device='cpu', load_in_8bit=True)\n"
        "class T:\n"
        "    dataset = {'test': [{'image': Image.fromarray(np.zeros((56, 56, 3), np.uint8))}] * 3}\n"
        "q.task_dict['t'] = T()\n"
        "class R:\n"
        "    def __init__(self, i):\n"
        "        self.args = ('What?', {'max_new_tokens': 3}, lambda d: [d['image']], i, 't', 'test')\n"
        "os.environ.update(LMMS_OWC_DECODE_POOL='2', LMMS_OWC_KV_INT8='force')\n"
        "assert len(q.generate_until([R(i) for i in range(3)])) == 3\n"
        "v25 = get_model('qwen2.5-vl-tiny', batch_size=2, dtype='float32', device='cpu')\n"
        "v25.task_dict['t'] = T()\n"
        "os.environ.update(LMMS_OWC_VISION_PACKED='force')\n"
        "assert len(v25.generate_until([R(i) for i in range(3)])) == 3\n"
        "assert len(m._encode_images_flat([T.dataset['test'][0]['image']])[1]) == 1\n"
        "odd = Image.fromarray(np.full((70, 90, 3), 7, np.uint8))\n"  # resized on the host
        "assert len(m._encode_images_flat([odd])[1]) == 1\n"
        "loaded = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib')))\n"
        "assert not loaded, loaded\n"
        "ours = sorted(k for k in sys.modules if k == 'lmms_owc_tpu' or k.startswith('lmms_owc_tpu.'))\n"
        "assert not ours, ours\n"
        "print('NO_JAX_OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX_OK" in proc.stdout

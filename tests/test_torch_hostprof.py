"""The host stage timers of the port (``LMMS_OWC_HOST_PROF``) change no output.

``foreach_chunk_pipelined`` times the wait for each prepared chunk and each
``run`` / ``finish`` call under the JAX package's names; the Qwen2-VL
adapter's host stages carry the JAX adapter's names, and its pooled
``generate_until`` prints their table. With the timers on, the tiny
Qwen2-VL adapter (float32, CPU) gives the tokens it gives with them off.
"""

import numpy as np
import pytest

from lmms_owc_tpu_torch import no_tf32, utils
from lmms_owc_tpu_torch.models import get_model
from lmms_owc_tpu_torch.utils import _hostprof
from tests.test_torch_onevision import _Req, _Task

GEN = {"max_new_tokens": 6, "do_sample": False, "until": None}
# The JAX adapter's stages on its pooled path (lmms_owc_tpu/models/qwen2_vl.py).
POOLED_STAGES = {"prep_fetch", "prep_vision", "prep_resize", "prep_stack", "prep_upload", "prep_patchify",
                 "prep_tower", "build_inputs", "prefill_dispatch", "decode_dispatch", "fetch", "detok",
                 "prep_wait", "run_total"}


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


@pytest.fixture
def timers_on(monkeypatch):
    monkeypatch.setenv("LMMS_OWC_HOST_PROF", "1")
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    _hostprof.hostprof_reset()
    yield
    _hostprof.hostprof_reset()


@pytest.mark.parametrize("with_finish", [False, True])
def test_pipeline_spans(timers_on, with_finish):
    chunks = [[1, 2], [3], [4, 5]]
    out = utils.foreach_chunk_pipelined(chunks, lambda c: [x * 2 for x in c], lambda c, p: p,
                                        finish=(lambda c, h: h) if with_finish else None)
    assert out == [2, 4, 6, 8, 10]
    counts = dict(_hostprof._counts)
    assert counts["prep_wait"] == counts["run_total"] == 3
    assert counts.get("finish_total", 0) == (3 if with_finish else 0)


def _tiny_qwen(seed=0):
    from PIL import Image

    model = get_model("qwen2-vl-tiny", batch_size=2, dtype="float32", device="cpu", torch_random_seed=seed)
    rng = np.random.RandomState(seed)
    docs = [{"images": [Image.fromarray(rng.randint(0, 255, (56 + 28 * i, 84, 3), dtype=np.uint8))]}
            for i in range(4)]
    model.task_dict["smoke"] = _Task(docs)
    return model, [_Req((f"What is {i}?", GEN, lambda d: d["images"], i, "smoke", "test")) for i in range(4)]


def _tokens(model, requests):
    """The strings and the token arrays ``generate_until`` detokenizes."""
    seen = []
    detok = model._detokenize
    model._detokenize = lambda t: seen.append(t.copy()) or detok(t)
    try:
        texts = model.generate_until(requests)
    finally:
        del model._detokenize
    return texts, np.concatenate(seen)


def test_pooled_qwen2_vl_timers_change_no_output(monkeypatch, capsys):
    """A pooled ``generate_until`` (``LMMS_OWC_DECODE_POOL=2``) with the
    timers off and on: the same strings and tokens; on, every stage of the
    JAX adapter's pooled path is timed and the table is printed."""
    model, requests = _tiny_qwen()
    monkeypatch.setenv("LMMS_OWC_DECODE_POOL", "2")
    want = _tokens(model, requests)
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    _hostprof.hostprof_reset()
    got = _tokens(model, requests)
    stages = set(_hostprof._acc)
    printed = capsys.readouterr().out
    _hostprof.hostprof_reset()
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert POOLED_STAGES <= stages
    assert "[hostprof generate_until n=4]" in printed and "decode_dispatch" in printed

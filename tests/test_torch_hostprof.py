"""The host stage timers of the port (``LMMS_OWC_HOST_PROF``) change no output.

``foreach_chunk_pipelined`` times the wait for each prepared chunk and each
``run`` / ``finish`` call under the JAX package's names; the Qwen2-VL
adapter's host stages carry the JAX adapter's names, and its pooled
``generate_until`` prints their table. With the timers on, the tiny
Qwen2-VL adapter (float32 and W8A8, CPU) gives the tokens it gives with them
off, and its counters (decode steps and rows, prompt tokens against prefill
slots, repeated W8A8 activation quantizations) equal what the calls show.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from lmms_owc_tpu_torch import no_tf32, utils
from lmms_owc_tpu_torch.models import get_model
from lmms_owc_tpu_torch.nn import layers as tl
from lmms_owc_tpu_torch.nn import qwen2_vl as tq
from lmms_owc_tpu_torch.ops import attention as tatt
from lmms_owc_tpu_torch.ops import int4_matmul as ti4
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


@pytest.fixture(autouse=True)
def _empty_counters():
    _hostprof.counters_reset()
    yield
    _hostprof.counters_reset()


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


def _tiny_qwen(seed=0, **kwargs):
    from PIL import Image

    model = get_model("qwen2-vl-tiny", batch_size=2, dtype="float32", device="cpu", torch_random_seed=seed,
                      **kwargs)
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


# (adapter keyword arguments, the adapter's decode row blocks)
POOLED_CASES = {
    "float32": ({}, None),
    "float32-rows3": ({}, 3),
    "w8a8": ({"load_in_8bit": True, "int8_activations": True}, None),
    "w8a8-rows3": ({"load_in_8bit": True, "int8_activations": True}, 3),
}


@pytest.mark.parametrize("case", list(POOLED_CASES))
def test_pooled_qwen2_vl_timers_change_no_output(monkeypatch, capsys, case):
    """A pooled ``generate_until`` (``LMMS_OWC_DECODE_POOL=2``) with the
    timers off and on: the same strings and tokens; off, the counter store
    stays empty; on, every stage of the JAX adapter's pooled path is timed,
    the table is printed, each decode step is split into ``decode_issue`` and
    ``decode_stop_check``, and the counters equal what the decode steps and
    prefills were called with. Under W8A8 each decoder layer repeats 3 of its
    7 activation quantizations in every forward (k and v take q's input, up
    takes gate's); the tower repeats none."""
    kwargs, rows = POOLED_CASES[case]
    w8a8 = bool(kwargs)
    try:
        model, requests = _tiny_qwen(**kwargs)
        model.decode_rows = rows
        monkeypatch.setenv("LMMS_OWC_DECODE_POOL", "2")
        monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")  # two chunks of 2 rows in one pool
        want = _tokens(model, requests)
        assert not _hostprof.counters
        step_rows, prefill_masks = [], []
        step, prefill = tq.decode_step, tq.prefill_logits
        monkeypatch.setattr(tq, "decode_step", lambda *a: step_rows.append(a[1].shape[0]) or step(*a))
        monkeypatch.setattr(tq, "prefill_logits", lambda *a: prefill_masks.append(a[3]) or prefill(*a))
        monkeypatch.setattr(_hostprof, "ENABLED", True)
        _hostprof.hostprof_reset()
        got = _tokens(model, requests)
        stages, counts, counters = set(_hostprof._acc), dict(_hostprof._counts), dict(_hostprof.counters)
        printed = capsys.readouterr().out
        _hostprof.hostprof_reset()
    finally:
        tl.set_int8_activations(False)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert POOLED_STAGES | {"decode_issue", "decode_stop_check"} <= stages
    assert "[hostprof generate_until n=4]" in printed and "decode_dispatch" in printed
    steps, forwards = len(step_rows), len(step_rows) + len(prefill_masks)
    assert step_rows == [4] * steps and steps >= 1  # one pool of the four requests
    assert counts["decode_issue"] == steps <= counts["decode_stop_check"] <= steps + 1
    if rows is None:
        computed = 4
    else:
        computed = max(4, tq.REDUCE_ROWS) if w8a8 else -(-4 // rows) * rows
    want_counters = {
        "decode_steps": steps,
        "decode_rows": 4 * steps,
        "decode_rows_computed": computed * steps,
        "prefill_tokens": sum(int(m.sum()) for m in prefill_masks),
        "prefill_slots": sum(m.numel() for m in prefill_masks),
        "decode_graph_steps": 0,  # the CPU runs the step's segments directly
    }
    assert len(prefill_masks) == 2 and want_counters["prefill_tokens"] < want_counters["prefill_slots"]
    if w8a8:
        layers = len(model.model.layers)
        want_counters["w8a8_requantize"] = 3 * layers * forwards
        assert counters["w8a8_quantize"] > 7 * layers * forwards  # and the tower's
        want_counters["w8a8_quantize"] = counters["w8a8_quantize"]
    assert counters == want_counters


@pytest.mark.parametrize("case", list(POOLED_CASES))
def test_graph_replays_add_the_counts_of_their_capture(monkeypatch, case):
    """The pooled run of the test above with the timers on, its decode steps
    replayed from stand-in CUDA graphs (captured at the second step of the
    pool, replayed from the third): every counter equals the direct run's,
    the quantizations a capture counted coming back at each replay and the
    tower's, counted on the prep worker's thread, never taken for the
    capture's; beside them, the replayed steps and the capture."""
    from tests.test_torch_decode_graphs import RecordingGraphs

    kwargs, rows = POOLED_CASES[case]
    try:
        model, requests = _tiny_qwen(**kwargs)
        model.decode_rows = rows
        monkeypatch.setenv("LMMS_OWC_DECODE_POOL", "2")
        monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")
        monkeypatch.setattr(_hostprof, "ENABLED", True)
        runs = []
        for graphs in (False, True):
            with monkeypatch.context() as m:
                if graphs:
                    RecordingGraphs.made = []
                    m.setattr(tq, "StepGraphs", RecordingGraphs)
                    m.setattr(tq._pool, "warm", set(), raising=False)
                _hostprof.counters_reset()
                runs.append((_tokens(model, requests), dict(_hostprof.counters)))
    finally:
        tl.set_int8_activations(False)
    ((want_texts, want_tokens), direct), ((texts, tokens), graphed) = runs
    assert texts == want_texts
    np.testing.assert_array_equal(tokens, want_tokens)
    steps = direct["decode_steps"]
    assert steps >= 3 and direct.pop("decode_graph_steps") == 0 and "decode_graph_captures" not in direct
    assert graphed.pop("decode_graph_steps") == steps - 2 and graphed.pop("decode_graph_captures") == 1
    assert graphed == direct
    (made,) = RecordingGraphs.made
    assert made.replays == (steps - 1) * (len(model.model.layers) + 1)


def test_counters_only_while_enabled(monkeypatch):
    _hostprof.count("decode_steps")
    assert not _hostprof.counters
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    _hostprof.count("decode_steps")
    _hostprof.count("decode_rows", 96)
    _hostprof.hostprof_reset()  # the spans' reset leaves the counters
    assert _hostprof.counters == {"decode_steps": 1, "decode_rows": 96}
    _hostprof.counters_reset()
    assert not _hostprof.counters


def test_counters_add_under_threads(monkeypatch):
    """No add is lost when more threads than cores count at once."""
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_hostprof.count("n") for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert _hostprof.counters["n"] == 16 * 2000


@pytest.mark.parametrize("inference", [False, True])
def test_requantize_counts_the_same_tensor_only(monkeypatch, inference):
    """A repeat is the tensor this thread quantized last, alive and unmodified:
    not a new tensor with equal values, not the same one changed in place
    (where torch tracks its version), not another thread's input."""
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    with torch.inference_mode(inference):
        x, y = torch.ones(4, 8), torch.ones(4, 8)
        tl._quantize_tokens(x)
        tl._quantize_tokens(x)  # repeat
        tl._quantize_tokens(y)  # equal values, another tensor
        tl._quantize_tokens(y)  # repeat
        y.mul_(2)
        tl._quantize_tokens(y)  # changed in place: a repeat only where no version is tracked
        other = threading.Thread(target=tl._quantize_tokens, args=(y,))
        other.start()
        other.join(timeout=60)
        tl._quantize_tokens(y)  # this thread's last input, unchanged since: repeat
    assert _hostprof.counters == {"w8a8_quantize": 7, "w8a8_requantize": 3 + inference}


def test_launch_counts_stay_apart_from_the_store(monkeypatch):
    """``launch_counts`` (always on, read by the smoke and the kernel tests)
    keeps its names and values: the timers' counters add nothing to it."""
    names = ({"flash_attention", "flash_attention_tensor_mask", "fused_qkv_attention", "vision_qkv_attention",
              "packed_vision_attention", "gqa_decode_attention", "gqa_decode_attention_int8"}, {"int4_matmul"})
    before = (dict(tatt.launch_counts), dict(ti4.launch_counts))
    assert tuple(set(d) for d in before) == names
    model, requests = _tiny_qwen()
    monkeypatch.setenv("LMMS_OWC_DECODE_POOL", "2")
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    _tokens(model, requests)
    _hostprof.hostprof_reset()
    assert (dict(tatt.launch_counts), dict(ti4.launch_counts)) == before  # the CPU launches no kernel
    assert _hostprof.counters["decode_steps"] > 0 and not set(_hostprof.counters) & (names[0] | names[1])

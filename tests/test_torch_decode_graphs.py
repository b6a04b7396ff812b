"""The decode step as segments between its K3 launches, and their CUDA graphs.

``decode_step`` runs the step's work between attention calls as the segments
of ``_step_segments``; inside ``_decode_loop`` on a CUDA device a pool's
``StepGraphs`` captures them once and replays them at every later step. On
the CPU the tests hold the segmented step bit for bit to the monolithic step
it replaced (``_monolithic_step`` below), directly and through a stand-in for
the graph object that runs a segment again on its static inputs at each
replay (``RecordingGraphs``), and check when graphs engage, replay or are
captured again, and that the counts a capture made come back at each
replay. The ``card`` tests run the real graphs on an NVIDIA GPU:
``python -m pytest --noconftest tests/test_torch_decode_graphs.py`` (this file
imports no JAX).
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from contextlib import nullcontext

import pytest
import torch

from lmms_owc_tpu_torch import _device, no_tf32
from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS
from lmms_owc_tpu_torch.nn import layers as tl
from lmms_owc_tpu_torch.nn import qwen2_vl as tq
from lmms_owc_tpu_torch.ops import attention as tatt
from lmms_owc_tpu_torch.ops import int4_matmul as ti4
from lmms_owc_tpu_torch.ops.quant import quantize_params_int8
from lmms_owc_tpu_torch.parallel.mesh import ModelGroup
from lmms_owc_tpu_torch.utils import _hostprof

GRAPH_COUNTERS = ("decode_graph_steps", "decode_graph_captures")
StepGraphs = tq.StepGraphs  # the tests put their stand-in in its place


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    no_tf32()
    _hostprof.counters_reset()
    monkeypatch.setattr(tq._pool, "warm", set(), raising=False)  # no step shape is warm yet
    yield
    tl.set_int8_activations(False)
    _hostprof.counters_reset()


# ------------------------------------------------------- the stand-in graphs


class _Replayed:
    """A captured segment of :class:`RecordingGraphs`: a replay runs it again
    on the inputs it was captured with and writes its outputs into the static
    ones, adding no count of its own (a real replay runs no Python). It holds
    the segment weakly, as a real graph holds nothing of the Python that was
    captured: a replay fails once ``StepGraphs`` has let the segment go, with
    the tensors its closure held that the graph still reads."""

    def __init__(self, fn, inputs, outputs, owner):
        self.fn, self.inputs, self.outputs, self.owner = weakref.ref(fn), inputs, outputs, owner

    def replay(self):
        self.owner.replays += 1
        fn = self.fn()
        assert fn is not None, "a graph replayed after its segment was let go"
        with _hostprof.tally() as made:
            fresh = fn(*self.inputs)
        for store, name, n in made:
            _hostprof.add(store, name, -n)
        for static, new in zip(self.outputs, fresh):
            static.copy_(new)


class RecordingGraphs(tq.StepGraphs):
    """``StepGraphs`` with a stand-in for torch's graph: capturing records the
    segment and runs it (as a capture's Python does), replaying runs it again.
    It engages on any device, a model group of more than one rank excepted."""

    made: list = []

    def __init__(self, device, steps=None):
        super().__init__(device, steps)
        self.captures, self.replays, self.warm_ups = [], 0, 0
        RecordingGraphs.made.append(self)

    @staticmethod
    def engages(model, device):
        return StepGraphs.engages(model, torch.device("cuda"))

    def _warm_up(self):
        self.warm_ups += 1
        return nullcontext()

    def _capture(self, fn, inputs):
        outputs = fn(*inputs)
        self.captures.append(fn.__qualname__)
        return _Replayed(fn, inputs, outputs, self), outputs


@pytest.fixture
def recording(monkeypatch):
    RecordingGraphs.made = []
    monkeypatch.setattr(tq, "StepGraphs", RecordingGraphs)
    return RecordingGraphs.made


# --------------------------------------------------- the step before segments


@torch.inference_mode()
def _monolithic_step(model, token_ids, position_ids, cache, cache_pos, kv_mask, rows=None):
    """``decode_step`` as it was before it ran as segments: one function, the
    cache written at a host position."""
    c = model.config
    cache_k, cache_v, *scales = cache
    b = token_ids.shape[0]
    layer_rows = head_rows = rows
    if rows is not None:
        layer0, head = model.layers[0], model.lm_head
        if all(tl.row_invariant(lin, b) for lin in (layer0.q, layer0.k, layer0.v, layer0.o,
                                                    layer0.gate, layer0.up, layer0.down)):
            layer_rows = max(b, tq.REDUCE_ROWS)
        if isinstance(head, tl.Int4Linear) and tl.row_invariant(head, b):
            head_rows = max(b, tq.REDUCE_ROWS)
    x = tq.embed_tokens(model, token_ids)[:, None, :]
    cos, sin = tq.mrope_cos_sin(position_ids, c)
    for i, layer in enumerate(model.layers):
        q, k, v = tq._row_blocks(lambda t: tq._qkv(layer, layer.input_ln(t), c), layer_rows, x)
        q = tl.apply_rope(q, cos, sin)
        k = tl.apply_rope(k, cos, sin)
        if scales:
            (kq, k_sc), (vq, v_sc) = tq._quantize_kv(k[:, :, 0]), tq._quantize_kv(v[:, :, 0])
            cache_k[i, :, :, cache_pos] = kq
            cache_v[i, :, :, cache_pos] = vq
            scales[0][i, :, :, cache_pos] = k_sc
            scales[1][i, :, :, cache_pos] = v_sc
        else:
            cache_k[i, :, :, cache_pos] = k[:, :, 0]
            cache_v[i, :, :, cache_pos] = v[:, :, 0]
        attn = tatt.gqa_decode_attention(q[:, :, 0], cache_k, cache_v, i, kv_mask, *scales)

        def post(t, a):
            t = t + layer.o(a)
            return t + layer.mlp(t)

        x = tq._row_blocks(post, layer_rows, x, attn.reshape(b, 1, -1))
    logits = tq._row_blocks(lambda t: tq._local_head_logits(model, model.final_norm(t)), head_rows, x[:, 0])
    return tq._gather_vocab(model, logits)


# ------------------------------------------------------------------ a pool


def _config(**changes):
    """The tiny preset with its own head (so W8A8 quantizes it too)."""
    return tq.Qwen2VLConfig.from_hf_dict({**PRESET_CONFIGS["qwen2-vl-tiny"], "tie_word_embeddings": False,
                                          **changes})


def _model(config, dtype, w8a8: bool, device="cpu", seed=0):
    model = tq.Qwen2VLModel(config, dtype, device, text_only=True)
    tq.init_params(model, torch.Generator(device).manual_seed(seed))
    if w8a8:
        quantize_params_int8(model)
        tl.set_int8_activations(True)
    return model


@dataclasses.dataclass
class Pool:
    """A decode pool's state after its prefill: left-padded prompts of
    ``prompt`` positions (row ``r`` starts at ``pads[r]``)."""

    logits: torch.Tensor
    cache: tuple
    kv_mask: torch.Tensor
    next_positions: torch.Tensor
    prompt: int

    def copy(self) -> "Pool":
        return Pool(self.logits.clone(), tuple(t.clone() for t in self.cache), self.kv_mask.clone(),
                    self.next_positions.clone(), self.prompt)


def _pool(model, rows: int, prompt: int, new: int, int8_cache: bool, seed=1) -> Pool:
    dev, c = model.device, model.config
    g = torch.Generator(dev).manual_seed(seed)
    pads = torch.randint(0, prompt // 2, (rows,), generator=g, device=dev)
    mask = (torch.arange(prompt, device=dev)[None] >= pads[:, None]).to(torch.int32)
    embeds = (torch.randn(rows, prompt, c.hidden_size, generator=g, device=dev) * 0.5).to(model.dtype)
    positions = (torch.cumsum(mask, 1) - 1).clamp(min=0)[None].expand(3, rows, prompt).contiguous()
    logits, cache = tq.prefill(model, embeds, positions, mask, prompt + new)
    if int8_cache:
        cache = tq.quantize_kv_cache(*cache)
    kv_mask = torch.zeros(rows, prompt + new, dtype=torch.int32, device=dev)
    kv_mask[:, :prompt] = mask
    return Pool(logits, cache, kv_mask, mask.sum(1).long(), prompt)


def _steps(step, model, pool: Pool, steps: int, rows=None, context=nullcontext, before=None):
    """``steps`` greedy decode steps of ``step`` on ``pool`` (updated in
    place; ``before[s](pool)`` runs before step ``s``): each step's logits,
    cloned."""
    token = pool.logits.argmax(-1)
    seen = []
    with context():
        for s in range(steps):
            if before and s in before:
                before[s](pool)
            pos = (pool.next_positions + s)[None, :, None].expand(3, token.shape[0], 1)
            pool.kv_mask[:, pool.prompt + s] = 1
            logits = step(model, token, pos, pool.cache, pool.prompt + s, pool.kv_mask, rows)
            seen.append(logits.clone())
            token = logits.argmax(-1)
    return seen


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g, w), f"item {i} of {len(want)} differs"


# (model dtype, W8A8, int8 cache)
STEP_CASES = {
    "f32": (torch.float32, False, False),
    "bf16": (torch.bfloat16, False, False),
    "int8-cache": (torch.float32, False, True),
    "w8a8-int8-cache": (torch.float32, True, True),
}


@pytest.mark.parametrize("rows", [None, 3], ids=["unblocked", "rows3"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_segmented_step_equals_the_monolithic_step(case, rows, recording):
    """Four steps of a 5-row pool: the segments called directly, and replayed
    from the stand-in graphs (a warm-up step, a capture, two replays), give
    the monolithic step's logits and cache contents bit for bit."""
    dtype, w8a8, int8_cache = STEP_CASES[case]
    model = _model(_config(), dtype, w8a8)
    pool = _pool(model, rows=5, prompt=12, new=6, int8_cache=int8_cache)
    want_pool, direct_pool, graph_pool = pool.copy(), pool.copy(), pool.copy()
    want = _steps(_monolithic_step, model, want_pool, 4, rows)
    direct = _steps(tq.decode_step, model, direct_pool, 4, rows)
    graphed = _steps(tq.decode_step, model, graph_pool, 4, rows,
                     lambda: tq._pool_graphs(model, model.device))
    (graphs,) = recording
    assert graphs.warm_ups == 1 and len(graphs.captures) == len(model.layers) + 1
    assert graphs.replays == 3 * (len(model.layers) + 1)  # the capture's own and two steps'
    for got in (direct, graphed):
        _assert_same(got, want)
    for p in (direct_pool, graph_pool):
        _assert_same(p.cache, want_pool.cache)
    assert not graphs.captured and graphs.inputs is None  # dropped with the pool


# A change of shape or switch warms up again; new tensors of warm shapes capture at once.
CHANGES = {"w8a8-switch": True, "new-cache": False, "new-mask": False, "timers": True}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_changed_key_captures_again(change, recording, monkeypatch):
    """A step whose key differs from the step before drops the graphs. The
    W8A8 switch or the host timers turned give shapes and switches this
    thread has not run yet: the step runs directly on the capture stream and
    the next captures. A new cache or mask tensor of the same shapes
    captures at once. The logits are the monolithic step's under the same
    change."""
    model = _model(_config(), torch.float32, w8a8=True)
    pool = _pool(model, rows=4, prompt=8, new=8, int8_cache=True)
    segments = len(model.layers) + 1

    def turn(p):
        if change == "w8a8-switch":
            tl.set_int8_activations(False)
        elif change == "new-cache":
            p.cache = tuple(t.clone() for t in p.cache)
        elif change == "new-mask":
            p.kv_mask = p.kv_mask.clone()
        else:
            monkeypatch.setattr(_hostprof, "ENABLED", True)

    want = _steps(_monolithic_step, model, pool.copy(), 6, before={3: turn})
    tl.set_int8_activations(True)
    monkeypatch.setattr(_hostprof, "ENABLED", False)
    _hostprof.counters_reset()
    seen = []

    def check(p):
        (graphs,) = recording
        seen.append((graphs.warm_ups, len(graphs.captures), graphs.replays))
        turn(p)

    got = _steps(tq.decode_step, model, pool, 6, context=lambda: tq._pool_graphs(model, model.device),
                 before={3: check})
    (graphs,) = recording
    assert seen == [(1, segments, 2 * segments)]
    if CHANGES[change]:  # steps 3-5: a warm-up, a capture, a replay
        assert (graphs.warm_ups, len(graphs.captures), graphs.replays) == (2, 2 * segments, 4 * segments)
    else:  # steps 3-5: a capture, two replays
        assert (graphs.warm_ups, len(graphs.captures), graphs.replays) == (1, 2 * segments, 5 * segments)
    _assert_same(got, want)
    if change == "timers":  # counted from the turn: a warm-up, a capture, a replay
        assert _hostprof.counters["decode_graph_steps"] == 1 and _hostprof.counters["decode_graph_captures"] == 1


def _decode(model, pool: Pool, new: int):
    return tq.decode_pool(model, pool.cache, pool.logits, pool.kv_mask, pool.next_positions, new, pool.prompt,
                          torch.tensor([-1]))


def test_a_later_pool_of_warm_shapes_captures_at_its_first_step(recording, monkeypatch):
    """Decode pools one after another on one thread: the first warms its
    shapes up at its first step and captures at its second; the next pool
    of the same shapes (new cache and mask tensors) captures at its first
    step and replays at every later one. Both give the monolithic step's
    tokens, and each pool's graphs are dropped as it ends."""
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    model = _model(_config(), torch.float32, w8a8=True)
    pool = _pool(model, rows=4, prompt=8, new=8, int8_cache=True)
    new = 7
    want = torch.stack([w.argmax(-1) for w in _steps(_monolithic_step, model, pool.copy(), new - 1)], 1)
    segments = len(model.layers) + 1
    for warm_ups, captured_at in ((1, 1), (0, 0)):
        _hostprof.counters_reset()
        tokens = _decode(model, pool.copy(), new)
        graphs = recording[-1]
        assert torch.equal(tokens[:, 1:], want)
        assert graphs.warm_ups == warm_ups and len(graphs.captures) == segments
        assert graphs.replays == (new - 1 - captured_at) * segments
        assert _hostprof.counters["decode_graph_steps"] == new - 2 - captured_at
        assert not graphs.captured and graphs.inputs is None
    assert len(recording) == 2


@pytest.mark.parametrize("warm", [False, True], ids=["first-pool", "warm-shapes"])
def test_a_pool_with_too_few_steps_left_does_not_capture(warm, recording, monkeypatch):
    """A capture pays only over ``GRAPH_MIN_STEPS`` steps: a pool whose
    budget leaves fewer steps at the step that would capture runs every step
    directly; one step more and it captures there (at its second step where
    its shapes are not warm yet, its first where they are). The tokens are
    the monolithic step's either way."""
    model = _model(_config(), torch.bfloat16, w8a8=False)
    pool = _pool(model, rows=3, prompt=8, new=8, int8_cache=False)
    segments = len(model.layers) + 1
    if warm:
        _decode(model, pool.copy(), 8)
    capture_at = 0 if warm else 1
    for steps, captures in ((tq.GRAPH_MIN_STEPS + capture_at - 1, 0), (tq.GRAPH_MIN_STEPS + capture_at, segments)):
        if not warm:
            monkeypatch.setattr(tq._pool, "warm", set())
        tokens = _decode(model, pool.copy(), steps + 1)
        want = _steps(_monolithic_step, model, pool.copy(), steps)
        assert torch.equal(tokens[:, 1:], torch.stack([w.argmax(-1) for w in want], 1))
        graphs = recording[-1]
        assert len(graphs.captures) == captures and graphs.warm_ups == capture_at
        assert graphs.replays == (steps - capture_at if captures else 0) * segments


def test_graphs_engage_on_a_whole_model_on_a_cuda_device():
    """The CPU never captures, nor a model group of two ranks (gloo's
    all-reduces cannot be captured); a whole model on a CUDA device does."""
    model = _model(_config(), torch.float32, False)
    cuda = torch.device("cuda")
    assert StepGraphs.engages(model, cuda)
    assert not StepGraphs.engages(model, torch.device("cpu"))
    model.tp = ModelGroup(None, 0, 2)
    assert not StepGraphs.engages(model, cuda)
    model.tp = ModelGroup(None, 0, 1)
    assert StepGraphs.engages(model, cuda)


@pytest.mark.parametrize("where", ["cpu", "model-group-of-two"])
def test_the_cpu_and_a_model_group_run_the_segments_directly(where, monkeypatch):
    """A decode pool on the CPU, and one whose model is a model group's rank
    (here a group of two that reduces nothing: the layers are whole), makes
    no graphs and gives the monolithic step's tokens."""
    made = []
    real = tq.StepGraphs
    if where == "cpu":
        monkeypatch.setattr(tq, "StepGraphs", type("Spy", (real,), {"__init__": lambda s, d: made.append(d)}))
        graphs_class = real
    else:
        RecordingGraphs.made = made
        graphs_class = RecordingGraphs
        monkeypatch.setattr(tq, "StepGraphs", RecordingGraphs)
    model = _model(_config(), torch.float32, False)
    if where != "cpu":
        model.tp = ModelGroup(None, 0, 2)
    pool = _pool(model, rows=3, prompt=8, new=6, int8_cache=False)
    want = _steps(_monolithic_step, model, pool.copy(), 5)
    tokens = tq.decode_pool(model, pool.cache, pool.logits, pool.kv_mask, pool.next_positions, 6, pool.prompt,
                            torch.tensor([-1]))
    assert not graphs_class.engages(model, model.device)
    assert made == []
    assert torch.equal(tokens[:, 1:], torch.stack([w.argmax(-1) for w in want], 1))


class _GraphPools:
    """PyTorch's rule for graph memory pools, as its allocators keep it: a
    pool's users are the graphs captured into it, counted at
    ``capture_begin`` and released as a graph is destroyed, and a capture into
    a pool whose graphs are all gone is refused."""

    def __init__(self):
        self.users: dict = {}
        self.handles = 0

    def handle(self):
        self.handles += 1
        return (0, self.handles)

    def graph(self):
        pools = self

        class Graph:
            pool = None

            def capture_begin(self, pool, capture_error_mode):
                assert capture_error_mode == "thread_local"
                if pools.users.get(pool) == 0:
                    raise RuntimeError("it->second->use_count > 0 INTERNAL ASSERT FAILED")
                pools.users[pool] = pools.users.get(pool, 0) + 1
                self.pool = pool

            def capture_end(self):
                pass

            def replay(self):
                pass

            def __del__(self):
                if self.pool is not None:
                    pools.users[self.pool] -= 1

        return Graph()


def test_decode_pools_hand_one_graph_memory_pool_on(monkeypatch):
    """Decode pools one after another capture into one graph memory pool: a
    pool ends handing it on with one of its graphs, so a capture never goes
    into a pool whose graphs are all gone (which PyTorch refuses), and the
    next pool's first capture drops that graph."""
    pools = _GraphPools()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", pools.graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", pools.handle)
    monkeypatch.setattr(tq, "_capture_stream", lambda device: None)
    monkeypatch.setattr(tq, "_FREE_MEMORY", {})
    device = torch.device("cpu")
    x = torch.ones(2)
    for _ in range(4):
        graphs = tq.StepGraphs(device)
        graphs.segments = [lambda t: (t + 1,)] * 3
        for k in range(3):
            (out,) = graphs._capture_and_run(k, x)
            assert torch.equal(out, x + 1)
            assert pools.users == {(0, 1): k + 1}  # the last pool's graph dropped after the first capture
        graphs.close()
        assert pools.users == {(0, 1): 1} and len(tq._FREE_MEMORY[device]) == 1
    assert pools.handles == 1
    tq.StepGraphs(device).close()  # a pool that captured nothing hands nothing on
    assert len(tq._FREE_MEMORY[device]) == 1


def test_a_tally_holds_this_threads_adds_only(monkeypatch):
    """``tally`` notes the adds of both stores (the timers' counters and the
    kernels' launch counts) made on its thread; another thread's adds reach
    the stores but not the tally."""
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    before = ti4.launch_counts["int4_matmul"]
    try:
        with _hostprof.tally() as made:
            _hostprof.count("w8a8_quantize", 3)
            _hostprof.add(ti4.launch_counts, "int4_matmul")
            other = threading.Thread(target=_hostprof.count, args=("w8a8_quantize", 5))
            other.start()
            other.join(timeout=60)
        _hostprof.count("w8a8_quantize")
    finally:
        ti4.launch_counts["int4_matmul"] = before
    assert made == [(_hostprof.counters, "w8a8_quantize", 3), (ti4.launch_counts, "int4_matmul", 1)]
    assert _hostprof.counters["w8a8_quantize"] == 9


def test_decode_attention_writes_into_out():
    """``gqa_decode_attention(..., out=)`` writes its result into ``out`` (a
    graph's static input) and returns it: the values of a new result."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 4, 16, generator=g)
    cache = torch.randn(2, 2, 3, 2, 10, 16, generator=g)
    mask = torch.ones(3, 10, dtype=torch.int32)
    out = torch.empty(3, 4, 16)
    got = tatt.gqa_decode_attention(q, cache[0], cache[1], 1, mask, out=out)
    assert got is out
    assert torch.equal(out, tatt.gqa_decode_attention(q, cache[0], cache[1], 1, mask))


# ------------------------------------------------------------------ the card


def _card_model(w8a8: bool, layers: int = 4):
    """The 7B decoder's widths and vocabulary at ``layers`` layers, bf16 weights
    drawn on the card (quantized for W8A8)."""
    config = tq.Qwen2VLConfig.from_hf_dict({**PRESET_CONFIGS["qwen2-vl-7b"], "num_hidden_layers": layers})
    return _model(config, torch.bfloat16, w8a8, device="cuda")


def _card_decode(model, pool: Pool, new: int, monkeypatch, graphs: bool, beside=None):
    """Greedy decode of ``pool`` through ``decode_pool`` (row blocks of 128,
    the adapter's on the card): (tokens, every step's logits, K3 launches,
    the counters), with or without graphs, and with ``beside`` running in
    another thread meanwhile."""
    seen = []
    real = tq.decode_step
    with monkeypatch.context() as m:
        m.setattr(tq, "decode_step", lambda *a: (lambda out: seen.append(out.clone()) or out)(real(*a)))
        if not graphs:
            m.setattr(tq.StepGraphs, "engages", staticmethod(lambda model, device: False))
        m.setattr(_hostprof, "ENABLED", True)
        _hostprof.counters_reset()
        launches = dict(tatt.launch_counts)
        stop = threading.Event()
        thread = threading.Thread(target=beside, args=(stop,)) if beside else None
        if thread:
            thread.start()
        try:
            tokens = tq.decode_pool(model, pool.cache, pool.logits, pool.kv_mask, pool.next_positions, new,
                                    pool.prompt, torch.tensor([-1], device="cuda"), decode_rows=128)
            torch.cuda.synchronize()
        finally:
            stop.set()
            if thread:
                thread.join(timeout=600)
        k3 = sum(tatt.launch_counts[k] - launches[k] for k in ("gqa_decode_attention", "gqa_decode_attention_int8"))
        counters = dict(_hostprof.counters)
    return tokens, seen, k3, counters


@pytest.mark.card
@pytest.mark.parametrize("case", ["w8a8-int8-cache", "bf16"])
def test_card_graph_replay_equals_the_direct_segments(card, case, monkeypatch):
    """A 96-row pool of the 7B decoder's widths (4 layers), 24 new tokens:
    replayed graphs give the direct segments' tokens and every step's logits
    bit for bit, K3 runs once a layer a step in both, and every step after
    the warm-up and the capture replays."""
    w8a8 = case.startswith("w8a8")
    model = _card_model(w8a8)
    pool = _pool(model, rows=96, prompt=128, new=64, int8_cache=w8a8)
    new = 24
    direct = _card_decode(model, pool.copy(), new, monkeypatch, graphs=False)
    graphed = _card_decode(model, pool.copy(), new, monkeypatch, graphs=True)
    steps = new - 1
    layers = len(model.layers)
    _assert_same(graphed[1], direct[1])
    assert torch.equal(graphed[0], direct[0])
    assert direct[2] == graphed[2] == steps * layers
    assert graphed[3]["decode_graph_steps"] == steps - 2 and graphed[3]["decode_graph_captures"] == 1
    assert direct[3]["decode_graph_steps"] == 0 and "decode_graph_captures" not in direct[3]
    assert {k: v for k, v in graphed[3].items() if k not in GRAPH_COUNTERS} == \
        {k: v for k, v in direct[3].items() if k not in GRAPH_COUNTERS}
    if w8a8:
        assert graphed[3]["w8a8_quantize"] == steps * 7 * layers


@pytest.mark.card
def test_card_capture_beside_a_busy_thread(card, monkeypatch):
    """Graphs captured while another thread keeps the default stream busy
    and synchronizes the device now and then (as the adapters' prep worker
    and phase timer do) give the direct run's tokens."""
    model = _card_model(w8a8=True)
    pool = _pool(model, rows=96, prompt=128, new=64, int8_cache=True)
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    busy = []

    def beside(stop):
        while not stop.is_set():
            for _ in range(8):
                torch.mm(a, a)
            _device.synchronize(a.device)
            busy.append(1)

    direct = _card_decode(model, pool.copy(), 24, monkeypatch, graphs=False)
    graphed = _card_decode(model, pool.copy(), 24, monkeypatch, graphs=True, beside=beside)
    assert busy and graphed[3]["decode_graph_captures"] == 1
    _assert_same(graphed[1], direct[1])
    assert torch.equal(graphed[0], direct[0])


@pytest.mark.card
def test_card_pools_reuse_one_graph_memory_pool(card, monkeypatch):
    """120 W8A8 decode pools one after another (96 rows of the 7B decoder's
    widths at 4 layers, the int8 cache, 8 new tokens, the int8 head's bf16
    copy of the vocabulary inside every capture): every pool captures and
    gives the direct run's tokens, the device memory reserved after the
    120th pool is what it was after the 10th, and one graph memory pool
    serves them all."""
    model = _card_model(w8a8=True)
    pool = _pool(model, rows=96, prompt=128, new=64, int8_cache=True)
    new, pools = 8, 120
    want = _card_decode(model, pool.copy(), new, monkeypatch, graphs=False)[0]
    monkeypatch.setattr(_hostprof, "ENABLED", True)
    _hostprof.counters_reset()
    reserved = {}
    for i in range(pools):
        p = pool.copy()
        tokens = tq.decode_pool(model, p.cache, p.logits, p.kv_mask, p.next_positions, new, p.prompt,
                                torch.tensor([-1], device="cuda"), decode_rows=128)
        assert torch.equal(tokens, want), f"pool {i}"
        if i + 1 in (10, pools):
            del p
            torch.cuda.synchronize()
            reserved[i + 1] = torch.cuda.memory_reserved()
    steps = new - 1
    # The first pool warms its shapes up and captures at its second step, the others at their first.
    assert _hostprof.counters["decode_graph_captures"] == pools
    assert _hostprof.counters["decode_graph_steps"] == (steps - 2) + (pools - 1) * (steps - 1)
    assert reserved[pools] == reserved[10], f"reserved bytes grew: {reserved}"
    assert sum(len(free) for free in tq._FREE_MEMORY.values()) == 1


@pytest.mark.card
def test_card_int4_launch_counts_under_graphs_are_the_kernels_that_ran(card, monkeypatch):
    """K4 (``int4_matmul``) runs inside the graph segments, so its launch
    count grows at each replay by the counts of the capture. Over an int4
    pool (96 rows of the 7B decoder's widths at 4 layers, 12 new tokens)
    the profiler's ``int4_kernel`` launches equal that count, which equals
    the direct run's per step, and the tokens are the direct run's."""
    from torch.profiler import ProfilerActivity, profile

    from lmms_owc_tpu_torch.ops.quant import quantize_params_int4

    model = _card_model(w8a8=False)
    quantize_params_int4(model)
    pool = _pool(model, rows=96, prompt=128, new=64, int8_cache=False)
    new = 12
    before = ti4.launch_counts["int4_matmul"]
    direct = _card_decode(model, pool.copy(), new, monkeypatch, graphs=False)
    per_run = ti4.launch_counts["int4_matmul"] - before
    assert per_run > 0 and per_run % (new - 1) == 0
    before = ti4.launch_counts["int4_matmul"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graphed = _card_decode(model, pool.copy(), new, monkeypatch, graphs=True)
    counted = ti4.launch_counts["int4_matmul"] - before
    ran = sum(e.count for e in prof.key_averages() if "int4_kernel" in e.key)
    assert graphed[3]["decode_graph_steps"] == new - 3 and graphed[3]["decode_graph_captures"] == 1
    assert counted == per_run and ran == counted, f"counted {counted}, profiler {ran}, direct {per_run}"
    assert torch.equal(graphed[0], direct[0])

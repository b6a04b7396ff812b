"""The harness: finds a cell's files by name and drives the port through one run.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); its limits are ``limits/<cell>.json`` and each
per-layer metric is read by ``metrics/<metric>.py``. What belongs to a model
family sits behind the plain reference its configuration names
(``reference/<name>.py``: sizes, checkpoint layout, each request's shape and
work, the reference's logits), how to read a decode step's arguments in the
configuration (``program.decode_step``), and how to read an attention entry's
shapes in ``attention/<entry>.py``. Nothing here names a cell, a
configuration, a family, a mix or a metric: a later one is a new file.

The program is the PyTorch/CUDA port, ``lmms_owc_tpu_torch``, entered where
the evaluator enters it: the registered adapter's ``generate_until``. It loads
the benchmark's weights through its normal checkpoint path: a directory with
the configuration's ``config.json`` and the benchmark's tokenizer, whose
tensors the checkpoint reader named by the configuration serves from the
card (:mod:`owcbench.weights`), so no checkpoint is written to disk.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager, redirect_stdout
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from owcbench import roofline, trace, traffic, weights

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
PROGRAM = "lmms_owc_tpu_torch"
# Modules that must not be loaded where the port is measured, by whole top-level name.
EXCLUDED_MODULES = ("jax", "jaxlib", "flax", "lmms_owc_tpu")


class HarnessError(RuntimeError):
    """A run that cannot give a result."""


# ------------------------------------------------------------------ the files


def manifest() -> dict:
    path = REPO / "BENCHMARK.json"
    if not path.is_file():
        raise HarnessError(f"{path} not found")
    return json.loads(path.read_text())


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` of the benchmark (a configuration, a mix, a cell's limits)."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise HarnessError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    return json.loads(path.read_text())


_MODULES: dict = {}


def module_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded once."""
    path = HERE / kind / f"{name}.py"
    if path not in _MODULES:
        if not path.is_file():
            raise HarnessError(f"no {kind} module named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(f"owcbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    return module_file("metrics", metric).read


def reference(config: dict):
    """The plain reference of the configuration's family, ``reference/<name>.py``."""
    return module_file("reference", config["reference"])


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict | None
    end_to_end: list
    per_layer: list


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else manifest()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise HarnessError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    limits_path = HERE / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else None

    def applies(metric):
        return name in metric.get("workloads", [name])

    return Cell(name, w, load("configs", w["config"]), load("traffic", w["traffic"]), limits,
                [m for m in bench["end_to_end"] if applies(m)], [m for m in bench["per_layer"] if applies(m)])


def excluded_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``EXCLUDED_MODULES``, compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in EXCLUDED_MODULES)


def set_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port's
    own ``build/kernels`` and ``build/native`` already are)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(REPO / "build" / sub)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return {"nvidia_smi": f"unavailable: {err}"}
    return {"nvidia_smi": out.splitlines()}


# ----------------------------------------------------------------- the program


@contextmanager
def route(module, name: str, fn):
    """Point ``module.name`` at ``fn`` for the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _attr(path: str):
    module, name = path.split(":")
    return importlib.import_module(module), name


class _Request:
    """The evaluator's request: ``args`` = (context, gen_kwargs, doc_to_visual, doc_id, task, split)."""

    __slots__ = ("args",)

    def __init__(self, args: tuple) -> None:
        self.args = args


def _visual(doc) -> list:
    return [doc["image"]]


def _stop(text: str):
    """(row, text) of an answer the capture marked: ``\\0<row>\\0<text>``."""
    if not text.startswith("\0"):
        return None, text
    _, row, rest = text.split("\0", 2)
    return int(row), rest


class Program:
    """The port with the benchmark's weights, its served tokens captured.

    ``trace`` turns on what the traced run reads: the adapter's phase timer,
    the host stage timers, and counters around decode steps and attention
    calls (:class:`Probes`)."""

    def __init__(self, cell: Cell, seed: int, trace: bool = False, device: str = "cuda") -> None:
        import torch

        cfg, prog = cell.config, cell.config["program"]
        os.environ.update(prog.get("env", {}))
        program = importlib.import_module(PROGRAM)
        where = Path(program.__file__).resolve().parents[1]
        if where != REPO:
            raise HarnessError(f"{PROGRAM} was imported from {where}, not from this checkout ({REPO})")
        from lmms_owc_tpu_torch.models import get_model

        ref = reference(cfg)
        self.arch = ref.arch(cfg["hf_config"])
        dtype = getattr(torch, prog["kwargs"].get("dtype", "bfloat16"))
        state = weights.draw(ref.hf_layout(cfg["hf_config"]), seed, dtype, device)
        ckpt = Path(tempfile.mkdtemp(prefix="owcbench-checkpoint-"))
        try:
            ref.checkpoint_dir(ckpt, cfg)
            module, name = _attr(prog["checkpoint_reader"])
            with route(module, name, lambda _path: state):
                self.model = get_model(prog["model"], pretrained=str(ckpt), device=device, time_phases=trace,
                                       **prog["kwargs"])
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        del state
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        self.device = device
        self.rows: list[np.ndarray] = []
        self.stop_ids = set(self.model.eos_token_ids) | {int(self.model.pad_token_id)}
        detok = self.model._detokenize

        def capture(tokens):
            texts = detok(tokens)
            base = len(self.rows)
            self.rows.extend(np.asarray(tokens)[i].copy() for i in range(len(texts)))
            return [f"\0{base + i}\0{t}" for i, t in enumerate(texts)]

        self.model._detokenize = capture

    def requests(self, reqs: list[traffic.Request], task: str) -> list[_Request]:
        """The evaluator's requests for ``reqs``, their documents under ``task``:
        the layout of ``chip_smoke.py``'s request builder ``_requests`` (lines
        1959-1981), one image a document."""
        self.model.task_dict[task] = SimpleNamespace(dataset={"test": [{"image": r.image} for r in reqs]})
        return [_Request((r.prompt, r.generation_kwargs, _visual, i, task, "test")) for i, r in enumerate(reqs)]

    def serve(self, requests: list[_Request]) -> list:
        """One ``generate_until`` call: per request, its served tokens (up to
        and with the first stop token) or None where no answer came."""
        self.rows = []
        with redirect_stdout(sys.stderr):  # the pooled path prints its host timers' table
            texts = self.model.generate_until(requests)
        served = []
        for text in texts:
            row, _ = _stop(text) if isinstance(text, str) else (None, None)
            served.append(None if row is None else self._served(self.rows[row]))
        return served

    def _served(self, tokens: np.ndarray) -> list[int]:
        out = []
        for t in tokens.tolist():
            out.append(int(t))
            if int(t) in self.stop_ids:
                break
        return out

    def close(self) -> None:
        import torch

        del self.model
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


# ------------------------------------------------------------ the traced run


@dataclass
class Probes:
    """Spans and counters around the program's calls for the traced run."""

    spans: trace.Spans = field(default_factory=trace.Spans)
    decode_steps: int = 0
    decode_calls: int = 0
    steps: list = field(default_factory=list)  # (mask key, cache position, batch, seq, kv heads, head dim, int8)
    masks: dict = field(default_factory=dict)  # mask key -> (mask, snapshot, first cache position)
    flash: list = field(default_factory=list)  # (batch, heads, kv heads, lq, lk, d, causal, mask, elt)
    hostprof: dict = field(default_factory=dict)

    def add_hostprof(self) -> None:
        """Fold the host stage timers of the call just made into the window's sums."""
        from lmms_owc_tpu_torch.utils import _hostprof

        for name, seconds in _hostprof._acc.items():
            self.hostprof[name] = self.hostprof.get(name, 0.0) + seconds
        _hostprof.hostprof_reset()

    @contextmanager
    def attached(self, program: Program, cfg: dict):
        from lmms_owc_tpu_torch.utils import _hostprof

        prog = cfg["program"]
        model = program.model
        spans = self.spans
        with ExitStack() as stack:
            _hostprof.ENABLED = True
            stack.callback(setattr, _hostprof, "ENABLED", False)

            @contextmanager
            def timed(name):
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    t1 = time.perf_counter()
                    _hostprof._acc[name] += t1 - t0
                    _hostprof._counts[name] += 1
                    spans.add(name, t0, t1)

            stack.enter_context(route(_hostprof, "_timed", timed))
            phase = model._phase

            @contextmanager
            def timed_phase(name):
                t0 = time.perf_counter()
                with phase(name):
                    yield
                spans.add(name, t0, time.perf_counter())

            model._phase = timed_phase
            stack.callback(delattr, model, "_phase")
            step = prog["decode_step"]
            module, name = _attr(step["entry"])
            stack.enter_context(route(module, name, self._step(getattr(module, name), step)))
            module, name = _attr(prog["decode_attention"])
            stack.enter_context(route(module, name, self._decode_attention(getattr(module, name))))
            for path in prog["attention"]:
                module, name = _attr(path)
                shape = module_file("attention", name).shape
                stack.enter_context(route(module, name, self._attention(shape, getattr(module, name))))
            yield self

    def _step(self, real, spec: dict):
        """``real`` counted and timed; its cache, cache position and key mask
        read from the arguments the configuration names (``spec``), the
        cache's first tensor laid out as ``spec["cache_dims"]`` says."""
        signature = inspect.signature(real)
        dims = {d: i for i, d in enumerate(spec["cache_dims"])}

        def step(*args, **kw):
            bound = signature.bind(*args, **kw).arguments
            cache, pos, kv_mask = bound[spec["cache"]], int(bound[spec["cache_pos"]]), bound[spec["kv_mask"]]
            key = id(kv_mask)
            if key not in self.masks:
                self.masks[key] = (kv_mask, kv_mask.clone(), pos)
            k = cache[0]
            self.steps.append((key, pos) + tuple(k.shape[dims[d]] for d in ("batch", "seq", "kv_heads", "head_dim"))
                              + (k.dtype.itemsize == 1,))
            t0 = time.perf_counter()
            out = real(*args, **kw)
            self.spans.add("decode_step", t0, time.perf_counter())
            self.decode_steps += 1
            return out

        return step

    def _decode_attention(self, real):
        def call(*args, **kw):
            self.decode_calls += 1
            return real(*args, **kw)

        return call

    def _attention(self, shape, real):
        def call(*args, **kw):
            self.flash.append(shape(args, kw))
            return real(*args, **kw)

        return call

    def bounds(self, arch: dict) -> tuple[float | None, float | None]:
        """Summed bound seconds of the flash calls and of the decode calls."""
        import torch

        cache: dict = {}
        flash_s = 0.0
        for b, h, kvh, lq, lk, d, causal, mask, elt in self.flash:
            key = (b, h, kvh, lq, lk, d, causal, elt, None if mask is None else (mask.data_ptr(), mask.stride()))
            if key not in cache:
                keys = torch.ones(b, lk, dtype=torch.bool) if mask is None else mask.reshape(b, lk)
                peak = roofline.PEAK_BF16_FLOPS if elt == 2 else roofline.PEAK_3XTF32_FLOPS
                cache[key] = roofline.attention_bound(keys, h, kvh, lq, d, causal=causal, elt=elt,
                                                      peak_flops=peak)["bound_s"]
            flash_s += cache[key]
        decode_s = 0.0
        valid0 = {key: (int(snap.sum()), c0) for key, (_, snap, c0) in self.masks.items()}
        for key, pos, b, seq, kvh, d, int8 in self.steps:
            base, c0 = valid0[key]
            valid = base + b * (pos - c0)
            decode_s += arch["layers"] * roofline.decode_bound(b, arch["heads"], kvh, d, seq, valid,
                                                               int8=int8)["bound_s"]
        if self.decode_calls != self.decode_steps * arch["layers"]:
            decode_s = None  # some decode attention ran off K3's entry: no share to report
        return (flash_s or None), (decode_s or None)


# --------------------------------------------------------------------- a run


@dataclass
class Record:
    """What one run measured: the readers' input."""

    cell: Cell
    images: int
    calls: int
    window_s: float
    setup_s: float
    peak_bytes: int
    served: list
    call_s: list
    work: roofline.Work
    phase_seconds: dict = field(default_factory=dict)
    hostprof: dict = field(default_factory=dict)
    decode_steps: int = 0
    flash_bound_s: float | None = None
    decode_bound_s: float | None = None
    timeline: trace.Timeline | None = None


def window_work(cell: Cell, arch: dict, reqs: list[traffic.Request], served_calls: list[list]) -> roofline.Work:
    """The model's operations over the window's answered requests (real patches and tokens)."""
    ref, cfg = reference(cell.config), cell.config
    work = roofline.Work()
    shapes = [ref.request_shape(arch, cfg, r) for r in reqs]
    for served in served_calls:
        for shape, tokens in zip(shapes, served):
            if tokens is not None:
                ref.count_work(arch, cfg, work, shape, len(tokens))
    return work


def sample(reqs: list[traffic.Request], served: list, seed: int, n: int, arch: dict, cfg: dict) -> list[int]:
    """Indices of the requests the check compares: the longest prompt, then
    others drawn from the seed."""
    ref = reference(cfg)
    prompts = [ref.request_shape(arch, cfg, r)["prompt_tokens"] for r in reqs]
    answered = [i for i, s in enumerate(served) if s]
    longest = max(answered, key=lambda i: (prompts[i], len(served[i])))
    rest = [i for i in answered if i != longest]
    rng = np.random.default_rng(traffic.seed_sequence(seed, 2))
    return [longest] + sorted(rng.choice(rest, size=min(n - 1, len(rest)), replace=False).tolist())


def gap_numbers(gaps: list) -> dict:
    """The numbers the check compares, from each sampled request's gaps (one
    per served token, by how much that token's reference logit lies below the
    reference's best): ``max_logit_gap``, the widest; ``mean_logit_gap``, the
    mean over every compared token; ``top1_miss_share``, the share of them
    that are not the reference's best."""
    import torch

    every = torch.cat(gaps)
    return dict(max_logit_gap=float(every.max()), mean_logit_gap=float(every.mean()),
                top1_miss_share=float((every > 0).double().mean()), per_request=[float(g.max()) for g in gaps],
                tokens=int(every.numel()))


def compare(cell: Cell, seed: int, reqs: list[traffic.Request], served: list, idx: list[int],
            controls: dict | None = None, device: str = "cuda") -> dict:
    """The reference's logits at every sampled served token, from the weights
    drawn again from ``seed``, and :func:`gap_numbers` of the served tokens.
    Under ``controls`` (name -> precision) each control's numbers too: the
    gaps of the tokens that the reference in that precision puts first at the
    same positions."""
    import torch

    cfg, ref = cell.config, reference(cell.config)
    arch = ref.arch(cfg["hf_config"])
    dtype = getattr(torch, cfg["program"]["kwargs"].get("dtype", "bfloat16"))
    state = weights.draw(ref.hf_layout(cfg["hf_config"]), seed, dtype, device)
    items = [dict(image=reqs[i].image, prompt=reqs[i].prompt, served=served[i]) for i in idx]
    want = ref.served_logits(arch, cfg, state, cfg["precision"], items, device)
    best = [logits.max(-1).values for logits in want]

    def gaps(tokens):
        return [b - logits.gather(-1, t[:, None])[:, 0] for b, logits, t in zip(best, want, tokens)]

    out = gap_numbers(gaps([torch.tensor(item["served"], device=want[0].device) for item in items]))
    for name, precision in (controls or {}).items():
        other = ref.served_logits(arch, cfg, state, precision, items, device)
        out[name] = gap_numbers(gaps([logits.argmax(-1) for logits in other]))
        del other
    del state, want, best
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell: Cell, seed: int, seconds: float, traced: bool, t0: float, device: str = "cuda",
        program_hook=None) -> dict:
    """One run: set-up (weights, load, a warm-up call of the cell's own mix on
    another stream of the seed), then calls of the mix back to back until
    ``seconds`` have passed, then the check. ``program_hook(program)`` may
    alter the program before the warm-up (the tests' planted faults)."""
    import torch

    cuda = device == "cuda"
    warm_reqs = traffic.make_requests(cell.traffic, seed, stream=1)
    reqs = traffic.make_requests(cell.traffic, seed, stream=0)
    program = Program(cell, seed, trace=traced, device=device)
    if program_hook is not None:
        program_hook(program)
    arch = program.arch
    program.serve(program.requests(warm_reqs, "owcbench_warmup"))
    window_requests = program.requests(reqs, "owcbench_window")
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    program.model.phase_seconds.clear()
    probes, timeline, served_calls, call_s = Probes(), None, [], []
    with ExitStack() as stack:
        prof = marker = None
        if traced:
            stack.enter_context(probes.attached(program, cell.config))
            if cuda:
                from torch.profiler import ProfilerActivity, profile

                prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
                marker = trace.marker_kernel()
        w0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            served_calls.append(program.serve(window_requests))
            if traced:
                probes.add_hostprof()
            if cuda:
                torch.cuda.synchronize()
            call_s.append(time.perf_counter() - c0)
            if time.perf_counter() - w0 >= seconds:
                break
        w1 = time.perf_counter()
    if prof is not None:
        events = trace.device_events(prof)
        if not events:
            raise HarnessError("the profiler's trace holds no device operation")
        timeline = trace.analyse(events, probes.spans, (w0, w1), (marker, trace.first_event_start(events)))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = Record(cell, images=sum(len(s) for s in served_calls), calls=len(served_calls), window_s=w1 - w0,
                    setup_s=setup_s, peak_bytes=peak, served=served_calls, call_s=call_s,
                    work=window_work(cell, arch, reqs, served_calls),
                    phase_seconds=dict(program.model.phase_seconds), timeline=timeline)
    if traced:
        record.hostprof, record.decode_steps = probes.hostprof, probes.decode_steps
        record.flash_bound_s, record.decode_bound_s = probes.bounds(arch)
    program.close()
    del program, probes
    last = served_calls[-1]
    failed = sum(1 for s in served_calls for x in s if not x)
    idx = sample(reqs, last, seed, int(cell.config["check"]["requests"]), arch, cell.config)
    check = compare(cell, seed, reqs, last, idx, device=device)
    return dict(record=record, failed=failed, check=check)

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lmms_owc_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: needs CUDA; prints the card's name and power limit; turns TF32
   off; builds the hand-written kernels (``lmms_owc_tpu_torch/csrc/*.cu``)
   into ``build/kernels/``.
2. Kernel parity: each kernel against its plain PyTorch version on the card,
   in bf16 at the main path's shapes, within ``atol = rtol = 2e-2``, with the
   kernel's and the plain version's times: the median per call between CUDA
   events (launch overhead included) and the device time the profiler records.
   The kernels' f32 forms are checked at small ragged shapes.
3. Main path: the ``qwen2-vl-7b`` adapter with random bf16 weights drawn on
   the card answers 8 image requests (64 greedy tokens) through
   ``generate_until``; the launch counts show every kernel ran.
4. Whole model: on one chunk, the prefill's last-position logits through the
   kernels against the same chunk through the plain versions (relative L2),
   in bf16 (held to the plain path's own distance from f32 attention) and
   with the weights in f32 (held to ``LOGITS_REL_L2``).

The second-to-last line is a JSON object with each kernel's launches, error
and times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

TOL = 2e-2  # bf16 kernel-vs-plain tolerance (the JAX kernel tests' bf16 bound)
LOGITS_REL_L2 = 2e-2
NUM_REQUESTS = 8
MAX_NEW_TOKENS = 64
PROMPT = "What type of object is in this photo?"
MIN_LAUNCHES = {"vision_qkv_attention": 32, "flash_attention": 28, "gqa_decode_attention": 28}
KERNELS = {
    "vision_qkv_attention": ("lmms_owc_tpu_torch/csrc/flash_attn.cu", "lmms_owc_tpu/ops/attention.py:1025"),
    "flash_attention": ("lmms_owc_tpu_torch/csrc/flash_attn.cu", "lmms_owc_tpu/ops/attention.py:139"),
    "gqa_decode_attention": ("lmms_owc_tpu_torch/csrc/decode_attn.cu", "lmms_owc_tpu/ops/attention.py:838"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, iters: int = 20) -> float | None:
    """Device time per call, summed over the kernels ``torch.profiler`` records
    (launch overhead excluded); None when the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        for e in prof.key_averages()
    )
    return total_us / 1000 / iters if total_us > 0 else None


def _timings(kernel, plain) -> dict[str, float | None]:
    return dict(
        ms=_median_ms(kernel), plain_ms=_median_ms(plain),
        device_ms=_device_ms(kernel), plain_device_ms=_device_ms(plain),
    )


def _compare(name: str, got, want, rows=None) -> float:
    """Max abs error over ``rows`` (a bool mask broadcast over the output); raises past TOL."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > TOL + TOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside atol=rtol={TOL}, "
            f"max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def check_kernels(dev) -> dict[str, dict]:
    """Phase 2: every kernel against its plain version at the main path's shapes."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLVisionConfig, vision_rope_cos_sin
    from lmms_owc_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    results = {}

    # Vision (K1): [8, 16, 1024, 80], rope from a 32x32 patch grid, the last
    # four rows masked to their first 768 patches (a 336x448 image's run).
    n, p, h, d = 8, 1024, 16, 80
    vcfg = Qwen2VLVisionConfig()
    qkv = randn(n, p, 3 * h * d)
    freqs = torch.from_numpy(vision_rope_cos_sin([(1, 32, 32)], vcfg)).to(dev)
    cos, sin = torch.cos(freqs)[None].expand(n, p, d // 2), torch.sin(freqs)[None].expand(n, p, d // 2)
    vmask = torch.ones((n, p), dtype=torch.int32, device=dev)
    vmask[n // 2 :, 768:] = 0
    kw = dict(kv_mask=vmask, rope_cos=cos, rope_sin=sin)
    got = att.vision_qkv_attention(qkv, h, d, **kw)
    want = att.vision_qkv_attention_plain(qkv, h, d, **kw)
    err = _compare("vision_qkv_attention", got, want)
    results["vision_qkv_attention"] = dict(
        shape=f"qkv [{n}, {p}, {3 * h * d}] bf16, rope, mask (0, 768) on {n // 2} rows",
        max_abs_err=err,
        **_timings(lambda: att.vision_qkv_attention(qkv, h, d, **kw),
                   lambda: att.vision_qkv_attention_plain(qkv, h, d, **kw)),
    )

    # Prefill (K2): q [8, 28, 320, 128], k/v [8, 4, 320, 128], causal, left padding.
    b, nh, kvh, l, hd = 8, 28, 4, 320, 128
    q, k, v = randn(b, nh, l, hd), randn(b, kvh, l, hd), randn(b, kvh, l, hd)
    starts = torch.tensor([0, 3, 17, 40, 64, 100, 191, 250], device=dev)
    pos = torch.arange(l, device=dev)
    pmask = (pos[None, :] >= starts[:, None]).to(torch.int32)
    kw = dict(causal=True, kv_mask=pmask)
    got = att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw)
    want = att.flash_attention_plain(q, k, v, **kw)
    valid_rows = (pos[None, :] >= starts[:, None])[:, None, :].expand(b, nh, l)  # rows with a key
    err = _compare("flash_attention", got, want, valid_rows)
    results["flash_attention"] = dict(
        shape=f"q [{b}, {nh}, {l}, {hd}], k/v [{b}, {kvh}, {l}, {hd}] bf16, causal, left-padded",
        max_abs_err=err,
        **_timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                   lambda: att.flash_attention_plain(q, k, v, **kw)),
    )

    # Decode (K3): q [8, 28, 128] against cache [28, 8, 4, 384, 128] at two layers.
    layers, s = 28, 384
    qd = randn(b, nh, hd)
    ck, cv = randn(layers, b, kvh, s, hd), randn(layers, b, kvh, s, hd)
    spos = torch.arange(s, device=dev)
    dmask = ((spos[None, :] >= starts[:, None]) & (spos[None, :] < l + 5)).to(torch.int32)
    errs = []
    for layer in (0, layers - 1):
        got = att.gqa_decode_attention(qd, ck, cv, layer, dmask)
        want = att.gqa_decode_attention_plain(qd, ck, cv, layer, dmask)
        errs.append(_compare(f"gqa_decode_attention[layer {layer}]", got, want))
    results["gqa_decode_attention"] = dict(
        shape=f"q [{b}, {nh}, {hd}], cache [{layers}, {b}, {kvh}, {s}, {hd}] bf16, layers 0 and {layers - 1}",
        max_abs_err=max(errs),
        **_timings(lambda: att.gqa_decode_attention(qd, ck, cv, layers - 1, dmask),
                   lambda: att.gqa_decode_attention_plain(qd, ck, cv, layers - 1, dmask)),
    )
    for name, r in results.items():
        log(f"parity {name}: {r['shape']}: max abs err {r['max_abs_err']:.3e}; per call "
            f"(median of 20, CUDA events) kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
            f"device time (profiler) kernel {r['device_ms']} ms, plain {r['plain_device_ms']} ms")
    check_f32_kernels(dev, gen)
    return results


def check_f32_kernels(dev, gen) -> None:
    """The kernels' f32 forms at small, ragged shapes (not on the bf16 main path)."""
    import torch

    from lmms_owc_tpu_torch.ops import attention as att

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    tol = 1e-4  # f32 in, f32 out: summation order only
    qkv = randn(2, 200, 3 * 4 * 80)
    cos, sin = torch.cos(randn(2, 200, 40)), torch.sin(randn(2, 200, 40))
    vmask = torch.ones((2, 200), dtype=torch.int32, device=dev)
    vmask[1, 150:] = 0
    kw = dict(kv_mask=vmask, rope_cos=cos, rope_sin=sin)
    errs = [(att.vision_qkv_attention(qkv, 4, 80, **kw) - att.vision_qkv_attention_plain(qkv, 4, 80, **kw)).abs().max()]
    q, k, v = randn(2, 4, 130, 64), randn(2, 2, 130, 64), randn(2, 2, 130, 64)
    pmask = torch.ones((2, 130), dtype=torch.int32, device=dev)
    pmask[1, :70] = 0
    got = att.flash_attention(q, k, v, causal=True, kv_mask=pmask, kv_mask_contiguous=True)
    want = att.flash_attention_plain(q, k, v, causal=True, kv_mask=pmask)
    errs.append(torch.cat([(got - want)[0].flatten(), (got - want)[1, :, 70:].flatten()]).abs().max())
    qd, ck, cv = randn(2, 8, 64), randn(3, 2, 2, 100, 64), randn(3, 2, 2, 100, 64)
    dmask = torch.ones((2, 100), dtype=torch.int32, device=dev)
    dmask[0, :30] = 0
    errs.append((att.gqa_decode_attention(qd, ck, cv, 1, dmask) - att.gqa_decode_attention_plain(qd, ck, cv, 1, dmask)).abs().max())
    errs = [float(e) for e in errs]
    log(f"f32 forms (vision D=80, prefill D=64 L=130, decode D=64): max abs errs {errs}")
    if not all(e <= tol for e in errs):
        raise AssertionError(f"f32 kernel forms disagree with their plain versions beyond {tol}: {errs}")


def _requests(model):
    """8 requests as the JAX bench builds them: six 448x448 and two 336x448 images."""
    from PIL import Image

    rng = np.random.RandomState(0)
    sizes = [(448, 448)] * 6 + [(336, 448)] * 2
    docs = [
        {"image": Image.fromarray(rng.randint(0, 255, (hh, ww, 3), dtype=np.uint8))}
        for hh, ww in sizes
    ]

    class _Task:
        dataset = {"test": docs}

    model.task_dict["smoke"] = _Task()
    gen_kwargs = {"max_new_tokens": MAX_NEW_TOKENS, "do_sample": False, "until": None}

    class _Req:
        def __init__(self, doc_id):
            self.args = (PROMPT, gen_kwargs, lambda doc: [doc["image"]], doc_id, "smoke", "test")

    return [_Req(i) for i in range(len(docs))]


def run_main_path(dev) -> tuple[object, list, dict[str, int]]:
    """Phase 3: Qwen2-VL-7B random bf16 weights, 8 requests through generate_until."""
    import torch

    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.ops import attention as att

    t0 = time.perf_counter()
    model = get_model(
        "qwen2-vl-7b", random_init=True, dtype="bfloat16", batch_size=NUM_REQUESTS,
        device=str(dev), time_phases=True,
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.model.parameters())
    log(f"qwen2-vl-7b: {n_params / 1e9:.3f} B parameters drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = _requests(model)
    model.generate_until(requests)  # warm-up: cuBLAS handles, allocator, kernel library

    model.phase_seconds.clear()
    att.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs = model.generate_until(requests)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(att.launch_counts)

    if len(outputs) != NUM_REQUESTS or not all(isinstance(o, str) and o for o in outputs):
        raise AssertionError(f"expected {NUM_REQUESTS} non-empty strings, got {outputs!r}")
    for name, least in MIN_LAUNCHES.items():
        if counts[name] < least:
            raise AssertionError(f"{name} launched {counts[name]} times in the main path, expected >= {least}")
    phases = {k: round(v, 4) for k, v in model.phase_seconds.items()}
    log(f"generate_until: {NUM_REQUESTS} images in {seconds:.3f} s = "
        f"{NUM_REQUESTS / seconds:.3f} images/s; phase seconds {phases}; launches {counts}")
    log(f"sample output: {outputs[0][:80]!r}")
    return model, requests, counts


def _exact_flash(q, k, v, **kw):
    """Plain attention in f32 on the given (bf16) operands, rounded once on the way out."""
    return _plain_flash(q.float(), k.float(), v.float(), **kw).to(q.dtype)


def _exact_vision(qkv, num_heads, head_dim, **kw):
    from lmms_owc_tpu_torch.ops import attention as att

    return att.vision_qkv_attention_plain(qkv.float(), num_heads, head_dim, **kw).to(qkv.dtype)


def _plain_flash(*args, kv_mask_contiguous=False, **kw):
    from lmms_owc_tpu_torch.ops import attention as att

    return att.flash_attention_plain(*args, **kw)


@contextmanager
def _attention(flash, vision):
    """Route the model's prefill and vision attention through other functions."""
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    saved = nnq.flash_attention, nnq.vision_qkv_attention
    nnq.flash_attention, nnq.vision_qkv_attention = flash, vision
    try:
        yield
    finally:
        nnq.flash_attention, nnq.vision_qkv_attention = saved


def _rel_l2(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def check_whole_model(model, requests) -> dict[str, float]:
    """Phase 4: last-position prefill logits of one chunk (vision tower, then
    prefill), through the kernels and through the plain versions.

    In bf16 the two paths differ by bf16 rounding amplified through 60 random
    layers, and so does the plain path from the same model with its attention
    computed in f32 ("exact"); the kernel path must be no farther from exact
    than the plain path is (with 25% headroom). Then the same weights in f32:
    kernel path against plain path within LOGITS_REL_L2.
    """
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import prefill
    from lmms_owc_tpu_torch.ops import attention as att

    chunk = [r.args for r in requests]

    def logits():
        rows, vision_flat = model._prepare_requests_batch(chunk)
        embeds, pos, mask, _, bucket = model._build_batch_inputs(rows, vision_flat)
        out, _ = prefill(
            model.model, embeds, torch.from_numpy(pos).to(model.device),
            torch.from_numpy(mask.astype(np.int32)).to(model.device), bucket,
        )
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("prefill logits have non-finite values")
        return out

    got = logits()
    with _attention(_plain_flash, att.vision_qkv_attention_plain):
        plain = logits()
    with _attention(_exact_flash, _exact_vision):
        exact = logits()
    rel = {
        "kernel_vs_plain": _rel_l2(got, plain),
        "kernel_vs_exact": _rel_l2(got, exact),
        "plain_vs_exact": _rel_l2(plain, exact),
    }
    log(f"whole model bf16: prefill logits {tuple(got.shape)} relative L2 {rel}")
    if rel["kernel_vs_exact"] > max(LOGITS_REL_L2, 1.25 * rel["plain_vs_exact"]):
        raise AssertionError(f"kernel path farther from f32 attention than the plain path: {rel}")

    model.model.float()
    got = logits()
    with _attention(_plain_flash, att.vision_qkv_attention_plain):
        plain = logits()
    rel["f32_kernel_vs_plain"] = _rel_l2(got, plain)
    log(f"whole model f32: relative L2 kernel vs plain {rel['f32_kernel_vs_plain']:.3e} "
        f"(bound {LOGITS_REL_L2}), argmax agreement {float((got.argmax(-1) == plain.argmax(-1)).float().mean()):.3f}")
    if rel["f32_kernel_vs_plain"] > LOGITS_REL_L2:
        raise AssertionError(f"f32 prefill logits relative L2 {rel['f32_kernel_vs_plain']:.3e} > {LOGITS_REL_L2}")
    return rel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from lmms_owc_tpu_torch import get_device, no_tf32
    from lmms_owc_tpu_torch.ops import _build

    dev = get_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    no_tf32()
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")

    parity = check_kernels(dev)
    model, requests, counts = run_main_path(dev)
    check_whole_model(model, requests)

    kernels = [
        dict(
            name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
            launches=counts[name], max_abs_err=parity[name]["max_abs_err"],
            ms=parity[name]["ms"], plain_ms=parity[name]["plain_ms"],
            device_ms=parity[name]["device_ms"], plain_device_ms=parity[name]["plain_device_ms"],
        )
        for name in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

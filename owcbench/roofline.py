"""Bounds and operation counts: the yardstick of the rooflines and of ``mfu``.

``bound``, ``attention_bound`` and ``decode_bound`` are frozen copies of
``chip_smoke.py``'s ``_bound`` (lines 782-788), ``_attention_bound`` (lines
791-806) and the K3 byte count of ``_decode_rows`` (lines 905-909), with the
published H100 SXM peaks they use (lines 560-570). The product counts of
:func:`model_work` follow the per-stage pattern of ``tools/mfu_table.py``
(analytic operations per stage from the configuration's sizes), counted from
real patches and tokens, not padding.
"""

from __future__ import annotations

from dataclasses import dataclass

# Published H100 SXM peaks (NVIDIA data sheet; dense tensor-core rates, HBM3),
# at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# The f32 flash kernel runs three TF32 tensor-core products per product
# (3xTF32): a third of the 494.7 TFLOP/s TF32 rate (chip_smoke.py lines 565-566).
PEAK_3XTF32_FLOPS = 494.7e12 / 3


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations over the
    peak of their type (bf16 tensor cores unless given) and the bytes over the
    memory rate."""
    ops_s, bytes_s = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return dict(bound_s=max(ops_s, bytes_s), bound_by="operations" if ops_s >= bytes_s else "bytes",
                work_flops=flops, work_bytes=nbytes)


def attention_bound(keys, heads: int, kv_heads: int, lq: int, d: int, *, causal: bool,
                    extra_bytes: float = 0, elt: int = 2, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """Bound of attention whose rows attend to the valid keys ``keys`` [B, Lk]
    (bool), causal or not: 4*d flops per (query head, valid key) pair that the
    masks leave; q read and the output written once, and each valid key's k and
    v rows read once (a masked key need not be read)."""
    import torch

    b, lk = keys.shape
    keys = keys.bool()
    if causal:  # query i (aligned to the end) sees the valid keys at or before i + lk - lq
        pairs = int(torch.cumsum(keys.int(), 1)[:, torch.arange(lq, device=keys.device) + lk - lq].sum())
    else:
        pairs = int(keys.sum()) * lq
    nbytes = elt * (2 * b * heads * lq * d + 2 * kv_heads * d * int(keys.sum())) + extra_bytes
    return bound(4.0 * d * heads * pairs, nbytes, peak_flops)


def decode_bound(batch: int, heads: int, kv_heads: int, d: int, seq: int, valid: int, *, int8: bool,
                 elt: int = 2) -> dict:
    """Bound of one K3 call: q [B, H, D] against one layer of a cache of ``seq``
    positions of which ``valid`` (summed over rows) are attended. bf16: q and
    the output, each valid key's k and v rows, the int32 mask; int8: q and the
    output in bf16, each valid key's int8 k and v rows and their two f32
    scales, the mask."""
    if int8:
        nbytes = 2 * 2 * batch * heads * d + kv_heads * valid * (2 * d + 2 * 4) + 4 * batch * seq
    else:
        nbytes = elt * (2 * batch * heads * d + 2 * kv_heads * d * valid) + 4 * batch * seq
    return bound(4.0 * d * heads * valid, nbytes)


# ------------------------------------------------------------------ model work


@dataclass
class Work:
    """Operations of a stretch of serving, by the precision their products run in."""

    bf16: float = 0.0
    int8: float = 0.0

    def add(self, flops: float, int8: bool = False) -> None:
        if int8:
            self.int8 += flops
        else:
            self.bf16 += flops

    def least_seconds(self) -> float:
        """Each product at the peak of the type it runs in."""
        return self.bf16 / PEAK_BF16_FLOPS + self.int8 / PEAK_INT8_OPS


def _linear(rows: float, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def tower_work(work: Work, arch: dict, patches: int, windows: list[int] | None, int8: bool) -> None:
    """One image's vision tower: ``patches`` real patches; ``windows`` the real
    patch count of each attention window (Qwen2.5-VL), or None (every layer
    attends over the whole image). Products other than the patch embedding run
    in int8 under W8A8; attention in bf16."""
    e, heads, depth = arch["embed_dim"], arch["num_heads"], arch["depth"]
    d, merge = e // heads, arch["spatial_merge_size"] ** 2
    work.add(_linear(patches, arch["patch_dim"], e))  # patch_embed stays in the compute dtype
    full = set(arch.get("fullatt_block_indexes") or range(depth))
    for layer in range(depth):
        if arch["mlp"] == "gated":
            mlp = 3 * _linear(patches, e, arch["intermediate_size"])
        else:
            mlp = 2 * _linear(patches, e, arch["intermediate_size"])
        work.add(_linear(patches, e, 3 * e) + _linear(patches, e, e) + mlp, int8)
        if windows is None or layer in full:
            work.add(4.0 * d * heads * patches * patches)
        else:
            work.add(sum(4.0 * d * heads * s * s for s in windows))
    units = patches / merge
    work.add(_linear(units, e * merge, e * merge) + _linear(units, e * merge, arch["out_hidden"]), int8)


def decoder_layer_flops(arch: dict, tokens: float) -> float:
    h, kvh, d, inter = arch["hidden"], arch["kv_heads"], arch["head_dim"], arch["intermediate"]
    return _linear(tokens, h, h) * 2 + _linear(tokens, h, kvh * d) * 2 + 3 * _linear(tokens, h, inter)


def prefill_work(work: Work, arch: dict, tokens: int, int8: bool) -> None:
    """One prompt of ``tokens`` real tokens: every layer's products over each
    token, causal attention over the pairs it leaves, the head at the last
    position (the only one the serving path projects)."""
    layers, heads, d = arch["layers"], arch["heads"], arch["head_dim"]
    work.add(layers * decoder_layer_flops(arch, tokens), int8)
    work.add(layers * 4.0 * d * heads * tokens * (tokens + 1) / 2)
    work.add(_linear(1, arch["hidden"], arch["vocab"]))


def decode_work(work: Work, arch: dict, prompt: int, generated: int, int8: bool) -> None:
    """The decode steps of one row that served ``generated`` tokens: the first
    comes from the prefill's logits, each later one from a step over the token
    before it, attending to the prompt and the tokens so far."""
    layers, heads, d = arch["layers"], arch["heads"], arch["head_dim"]
    steps = max(generated - 1, 0)
    if not steps:
        return
    work.add(layers * decoder_layer_flops(arch, steps), int8)
    keys = sum(prompt + s + 1 for s in range(steps))
    work.add(layers * 4.0 * d * heads * keys)
    work.add(_linear(steps, arch["hidden"], arch["vocab"]))

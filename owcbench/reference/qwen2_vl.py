"""Plain reference of Qwen2-VL and Qwen2.5-VL: preprocessing, tower and decoder in f32.

Written from the published description (the HF ``Qwen2VLForConditionalGeneration``
and ``Qwen2_5_VLForConditionalGeneration`` forward passes and the
``Qwen2VLImageProcessor``), with no kernel, cache or batching: each sampled
request runs alone over its prompt and the tokens it was served, unpadded,
with dense causal attention. Matrix products run in f32 with TF32 off.

It works out again everything the serving path derives from its inputs: the
smart resize and its antialiased bicubic (PIL's kernel and support, a float
intermediate, one rounding at the end: the JAX package's native resizer's
semantics) and the patches, the chat template and its
tokens (:class:`~owcbench.tokenizer.ByteLevelBPE`), the M-RoPE positions,
the Qwen2.5-VL tower's 112-pixel windows (as a block mask, the same
attention as HF's window reordering), and, where a precision asks for them,
int8 or int4 weights (per output row; int4 in groups of 128 input columns),
per-token int8 activations and the per-vector int8 KV cache. Departures:
none in the arithmetic; the one ``image_pad`` per image and the single
still-image frame repeated over ``temporal_patch_size`` are what the
classification traffic sends.

A precision is a dict: ``weights`` ("bf16": the drawn values; "int8";
"int4"; "fp8": e4m3 per output row), ``activations`` (None, "int8" or
"fp8", per token) and ``kv`` (None or "int8"). The
linear layers other than the patch embedding take the weight precision; the
activation precision applies to all of them but the LM head, whose product
stays in the compute dtype; the KV precision applies to the keys and values
that decode steps read, so the last prompt position (the prefill) attends to
unquantized ones.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from owcbench.tokenizer import QWEN2_SPECIAL_IDS, ByteLevelBPE, tokenizer_spec, write_checkpoint_dir

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
INT4_GROUP = 128


# ------------------------------------------------------------------- sizes


def arch(hf: dict) -> dict:
    """The sizes of a Qwen2-VL / Qwen2.5-VL ``config.json``."""
    v = hf["vision_config"]
    v25 = hf.get("model_type") == "qwen2_5_vl"
    hidden, heads = hf["hidden_size"], hf["num_attention_heads"]
    patch, temporal, merge = v.get("patch_size", 14), v.get("temporal_patch_size", 2), v.get("spatial_merge_size", 2)
    if v25:
        tower = dict(embed_dim=v["hidden_size"], intermediate_size=v["intermediate_size"], mlp="gated", norm="rms",
                     out_hidden=v["out_hidden_size"], window_size=v["window_size"],
                     fullatt_block_indexes=tuple(v["fullatt_block_indexes"]))
    else:
        e = v["embed_dim"]
        tower = dict(embed_dim=e, intermediate_size=int(e * v["mlp_ratio"]), mlp="plain", norm="layer",
                     out_hidden=hidden, window_size=None, fullatt_block_indexes=None)
    tower.update(num_heads=v["num_heads"], depth=v["depth"], patch=patch, temporal=temporal,
                 spatial_merge_size=merge, patch_dim=3 * temporal * patch * patch)
    return dict(
        v25=v25, hidden=hidden, heads=heads, kv_heads=hf["num_key_value_heads"], head_dim=hidden // heads,
        intermediate=hf["intermediate_size"], layers=hf["num_hidden_layers"], vocab=hf["vocab_size"],
        rms_eps=hf.get("rms_norm_eps", 1e-6), rope_theta=hf.get("rope_theta", 1000000.0),
        mrope_section=tuple(hf["rope_scaling"]["mrope_section"]), tie=hf.get("tie_word_embeddings", False),
        image_token_id=hf["image_token_id"], vision_start_token_id=hf["vision_start_token_id"], tower=tower,
    )


def hf_layout(hf: dict) -> list[tuple[str, tuple, str]]:
    """(checkpoint name, shape, kind) of every tensor of the released layout;
    kind is how the benchmark draws it: "normal" (N(0, 0.02)), "bias"
    (N(0, 0.02)) or "norm" (1 + N(0, 0.1))."""
    a, t = arch(hf), arch(hf)["tower"]
    out: list[tuple[str, tuple, str]] = []

    def lin(name, d_out, d_in, bias):
        out.append((f"{name}.weight", (d_out, d_in), "normal"))
        if bias:
            out.append((f"{name}.bias", (d_out,), "bias"))

    def norm(name, d, bias):
        out.append((f"{name}.weight", (d,), "norm"))
        if bias:
            out.append((f"{name}.bias", (d,), "bias"))

    h, kv, inter = a["hidden"], a["kv_heads"] * a["head_dim"], a["intermediate"]
    out.append(("model.embed_tokens.weight", (a["vocab"], h), "normal"))
    for i in range(a["layers"]):
        p = f"model.layers.{i}."
        norm(p + "input_layernorm", h, False)
        lin(p + "self_attn.q_proj", h, h, True)
        lin(p + "self_attn.k_proj", kv, h, True)
        lin(p + "self_attn.v_proj", kv, h, True)
        lin(p + "self_attn.o_proj", h, h, False)
        norm(p + "post_attention_layernorm", h, False)
        lin(p + "mlp.gate_proj", inter, h, False)
        lin(p + "mlp.up_proj", inter, h, False)
        lin(p + "mlp.down_proj", h, inter, False)
    norm("model.norm", h, False)
    if not a["tie"]:
        lin("lm_head", a["vocab"], h, False)
    e, ti, ln = t["embed_dim"], t["intermediate_size"], t["norm"] == "layer"
    out.append(("visual.patch_embed.proj.weight", (e, 3, t["temporal"], t["patch"], t["patch"]), "normal"))
    for i in range(t["depth"]):
        p = f"visual.blocks.{i}."
        norm(p + "norm1", e, ln)
        norm(p + "norm2", e, ln)
        lin(p + "attn.qkv", 3 * e, e, True)
        lin(p + "attn.proj", e, e, True)
        if t["mlp"] == "gated":
            lin(p + "mlp.gate_proj", ti, e, True)
            lin(p + "mlp.up_proj", ti, e, True)
            lin(p + "mlp.down_proj", e, ti, True)
        else:
            lin(p + "mlp.fc1", ti, e, True)
            lin(p + "mlp.fc2", e, ti, True)
    m = e * t["spatial_merge_size"] ** 2
    norm("visual.merger.ln_q", e, ln)
    lin("visual.merger.mlp.0", m, m, True)
    lin("visual.merger.mlp.2", t["out_hidden"], m, True)
    return out


# ---------------------------------------------------------------- the inputs


@functools.cache
def tokenizer() -> ByteLevelBPE:
    """The reference's encoder of the pinned tokenizer that both sides read."""
    return ByteLevelBPE(tokenizer_spec())


def checkpoint_dir(path, cfg: dict) -> None:
    """Everything of the configuration's checkpoint but its tensors."""
    write_checkpoint_dir(path, cfg["hf_config"])


def request_shape(a: dict, cfg: dict, request) -> dict:
    """What a request's work depends on: its image's patch grid and its prompt's token count."""
    kw = cfg["program"]["kwargs"]
    grid = image_grid(a, request.width, request.height, kw["min_pixels"], kw["max_pixels"])
    return dict(grid=grid, prompt_tokens=len(prompt_ids(a, tokenizer(), kw["system_prompt"], request.prompt, grid)))


def smart_resize(height: int, width: int, factor: int, min_pixels: int, max_pixels: int) -> tuple[int, int]:
    """The Qwen2-VL image processor's sizing rule: sides multiples of ``factor``,
    the pixel count inside [min_pixels, max_pixels]."""
    h_bar, w_bar = round(height / factor) * factor, round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt(height * width / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar, w_bar = math.ceil(height * beta / factor) * factor, math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def image_grid(a: dict, width: int, height: int, min_pixels: int, max_pixels: int) -> tuple[int, int, int]:
    """(t, h, w) patch grid of an image of ``width`` x ``height`` pixels."""
    t = a["tower"]
    rh, rw = smart_resize(height, width, t["patch"] * t["spatial_merge_size"], min_pixels, max_pixels)
    return 1, rh // t["patch"], rw // t["patch"]


def _bicubic_taps(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] weights of the antialiased bicubic (a = -0.5; the support
    widened by the downscale factor; each output's weights summing to one)."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    w = torch.zeros(n_out, n_in, dtype=torch.float64)
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo, hi = max(0, math.floor(center - support)), min(n_in, math.ceil(center + support))
        x = (torch.arange(lo, hi, dtype=torch.float64) + 0.5 - center).abs() / fscale
        k = torch.where(x < 1, (1.5 * x - 2.5) * x * x + 1, torch.where(x < 2, -0.5 * (((x - 5) * x + 8) * x - 4), 0.0))
        w[o, lo:hi] = k / k.sum() if float(k.sum()) != 0 else k
    return w


def resize(pixels: np.ndarray, out_h: int, out_w: int) -> torch.Tensor:
    """uint8 [H, W, 3] -> uint8 [3, out_h, out_w]: rows, then columns, the
    first pass kept in float, rounded and clipped once."""
    x = torch.from_numpy(pixels.astype(np.float64)).permute(2, 0, 1)  # [3, H, W]
    if (out_h, out_w) == tuple(x.shape[1:]):
        return torch.from_numpy(pixels.copy()).permute(2, 0, 1)
    tmp = torch.matmul(x, _bicubic_taps(x.shape[2], out_w).t()).float().double()  # [3, H, out_w]
    out = torch.matmul(_bicubic_taps(x.shape[1], out_h), tmp)
    return out.round().clamp(0, 255).to(torch.uint8)


def patches(a: dict, image, min_pixels: int, max_pixels: int, device) -> tuple[torch.Tensor, tuple]:
    """Resized, normalised patches [P, 3*t*p*p] f32 in merge-window order, and the grid."""
    t = a["tower"]
    pixels = np.asarray(image.convert("RGB"))
    grid = image_grid(a, pixels.shape[1], pixels.shape[0], min_pixels, max_pixels)
    rh, rw = grid[1] * t["patch"], grid[2] * t["patch"]
    px = resize(pixels, rh, rw).to(device).float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=device).view(3, 1, 1)
    std = torch.tensor(CLIP_STD, device=device).view(3, 1, 1)
    px = ((px - mean) / std)[None].expand(t["temporal"], 3, rh, rw)
    m, p = t["spatial_merge_size"], t["patch"]
    gh, gw = grid[1], grid[2]
    x = px.reshape(t["temporal"], 3, gh // m, m, p, gw // m, m, p).permute(2, 5, 3, 6, 1, 0, 4, 7)
    return x.reshape(gh * gw, 3 * t["temporal"] * p * p), grid


def prompt_ids(a: dict, tokenizer: ByteLevelBPE, system: str, prompt: str, grid: tuple) -> list[int]:
    """The chat template for one image and a question, tokenized, with the
    image's one pad token expanded to its merged token count."""
    text = (f"<|im_start|>system\n{system}<|im_end|>\n<|im_start|>user\n"
            f"<|vision_start|><|image_pad|><|vision_end|>{prompt}<|im_end|>\n<|im_start|>assistant\n")
    merged = grid[0] * grid[1] * grid[2] // a["tower"]["spatial_merge_size"] ** 2
    ids: list[int] = []
    for tok in tokenizer.encode(text):
        ids.extend([tok] * merged if tok == QWEN2_SPECIAL_IDS["<|image_pad|>"] else [tok])
    return ids


def mrope_positions(a: dict, ids: list[int], grid: tuple, extra: int) -> torch.Tensor:
    """[3, len(ids) + extra] M-RoPE positions: text advances t, h and w
    together; the image's tokens take (0, row, column) of its merged grid after
    the text before it; text after the image resumes at the largest position
    plus one, and ``extra`` generated tokens continue from there."""
    m = a["tower"]["spatial_merge_size"]
    start = ids.index(a["image_token_id"])
    gh, gw = grid[1] // m, grid[2] // m
    pos = [np.tile(np.arange(start), (3, 1))]
    pos.append(np.stack([np.zeros(gh * gw, np.int64), np.repeat(np.arange(gh), gw), np.tile(np.arange(gw), gh)])
               + start)
    nxt = int(pos[-1].max()) + 1
    tail = len(ids) - start - gh * gw + extra
    pos.append(np.tile(np.arange(tail), (3, 1)) + nxt)
    return torch.from_numpy(np.concatenate(pos, axis=1))


# ----------------------------------------------------------------- arithmetic


def quantize_rows(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric weight quantization, dequantized in f32: int8 per output row
    (scale amax / 127, floored at 1e-12), int4 per group of 128 input columns
    (amax / 7; one group where 128 does not divide the input width)."""
    if bits == 8:
        scale = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
        return torch.clamp(torch.round(w / scale), -127, 127) * scale
    d_out, d_in = w.shape
    group = INT4_GROUP if d_in % INT4_GROUP == 0 else d_in
    g = w.reshape(d_out, d_in // group, group)
    scale = torch.clamp(g.abs().amax(dim=-1, keepdim=True) / 7.0, min=1e-12)
    return (torch.clamp(torch.round(g / scale), -7, 7) * scale).reshape(d_out, d_in)


def quantize_vectors(x: torch.Tensor) -> torch.Tensor:
    """Per-vector int8 over the last axis (scale max(amax, 1e-6) / 127), dequantized."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    return torch.round(x / scale) * scale


def quantize_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-vector fp8 (e4m3) over the last axis: scaled so that the largest
    magnitude is e4m3's 448, rounded to e4m3, dequantized."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 448.0, min=1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, halves convention: x [..., L, D], cos/sin [L, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, mask=None):
    """softmax(q k^T / sqrt(d) + mask) v over [H, L, D] (k, v already at H heads)."""
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v)


class Weights:
    """The checkpoint's tensors as the reference reads them, in f32, each
    quantized as the precision says."""

    def __init__(self, state, precision: dict) -> None:
        self.state = state
        self.precision = precision

    def raw(self, name: str) -> torch.Tensor:
        return self.state[name].float()

    def linear(self, name: str, head: bool = False):
        """(weight [out, in], bias or None, the activations' precision or None)."""
        w = self.raw(f"{name}.weight")
        kind = self.precision["weights"]
        if kind == "fp8":
            w = quantize_fp8(w)
        elif kind in ("int8", "int4"):
            w = quantize_rows(w, 8 if kind == "int8" else 4)
        bias = self.raw(f"{name}.bias") if f"{name}.bias" in self.state else None
        return w, bias, None if head else self.precision.get("activations")


def dense(x: torch.Tensor, lin) -> torch.Tensor:
    w, b, acts = lin
    if acts == "int8":
        x = quantize_vectors(x)
    elif acts == "fp8":
        x = quantize_fp8(x)
    out = torch.matmul(x, w.t())
    return out if b is None else out + b


# ----------------------------------------------------------------- the tower


def vision_rope(a: dict, grid: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [P, head_dim/2] of the 2D rotary embedding, in patch order:
    each patch's row then column, over frequencies of half the head width."""
    t = a["tower"]
    m, d = t["spatial_merge_size"], t["embed_dim"] // t["num_heads"]
    _, gh, gw = grid
    rows = torch.arange(gh).view(gh // m, m, 1, 1).expand(gh // m, m, gw // m, m).permute(0, 2, 1, 3).reshape(-1)
    cols = torch.arange(gw).view(1, 1, gw // m, m).expand(gh // m, m, gw // m, m).permute(0, 2, 1, 3).reshape(-1)
    dim = d // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freqs = torch.cat([rows[:, None].float() * inv, cols[:, None].float() * inv], dim=-1).to(device)
    return freqs.cos(), freqs.sin()


def window_mask(a: dict, grid: tuple, device) -> torch.Tensor:
    """[P, P] bool: the patches of one ``window_size``-pixel window attend to
    each other (Qwen2.5-VL's window layers)."""
    t = a["tower"]
    m = t["spatial_merge_size"]
    win = t["window_size"] // m // t["patch"]  # merge units per window side
    _, gh, gw = grid
    unit_r = torch.arange(gh // m).view(-1, 1).expand(gh // m, gw // m).reshape(-1)
    unit_c = torch.arange(gw // m).view(1, -1).expand(gh // m, gw // m).reshape(-1)
    window = ((unit_r // win) * (-(-(gw // m) // win)) + unit_c // win).repeat_interleave(m * m).to(device)
    return window[:, None] == window[None, :]


def towers(a: dict, weights: Weights, images: list[tuple[torch.Tensor, tuple]]) -> list[torch.Tensor]:
    """Merged embeddings [P / merge^2, hidden] of each (patches, grid), block by block."""
    t = a["tower"]
    e, nh = t["embed_dim"], t["num_heads"]
    d, rms = e // nh, t["norm"] == "rms"
    dev = images[0][0].device
    pe = weights.raw("visual.patch_embed.proj.weight").reshape(e, -1)
    xs = [torch.matmul(p, pe.t()) for p, _ in images]
    ropes = [vision_rope(a, g, dev) for _, g in images]
    full = set(t["fullatt_block_indexes"] or range(t["depth"]))
    masks = [None if t["window_size"] is None else window_mask(a, g, dev) for _, g in images]

    def norm(x, name):
        w = weights.raw(f"{name}.weight")
        return rms_norm(x, w, 1e-6) if rms else layer_norm(x, w, weights.raw(f"{name}.bias"))

    for i in range(t["depth"]):
        p = f"visual.blocks.{i}."
        qkv, proj = weights.linear(p + "attn.qkv"), weights.linear(p + "attn.proj")
        if t["mlp"] == "gated":
            mlp = [weights.linear(p + f"mlp.{r}_proj") for r in ("gate", "up", "down")]
        else:
            mlp = [weights.linear(p + "mlp.fc1"), weights.linear(p + "mlp.fc2")]
        for j, x in enumerate(xs):
            n = x.shape[0]
            q, k, v = dense(norm(x, p + "norm1"), qkv).view(n, 3, nh, d).permute(1, 2, 0, 3)
            cos, sin = ropes[j]
            mask = None if i in full else masks[j]
            o = attend(rotate(q, cos, sin), rotate(k, cos, sin), v, mask).transpose(0, 1).reshape(n, e)
            x = x + dense(o, proj)
            h = norm(x, p + "norm2")
            if t["mlp"] == "gated":
                x = x + dense(F.silu(dense(h, mlp[0])) * dense(h, mlp[1]), mlp[2])
            else:
                up = dense(h, mlp[0])
                x = x + dense(up * torch.sigmoid(1.702 * up), mlp[1])  # quick GELU
            xs[j] = x
    fc1, fc2 = weights.linear("visual.merger.mlp.0"), weights.linear("visual.merger.mlp.2")
    m2 = t["spatial_merge_size"] ** 2
    return [dense(F.gelu(dense(norm(x, "visual.merger.ln_q").reshape(-1, e * m2), fc1)), fc2) for x in xs]


# --------------------------------------------------------------- the decoder


def mrope_cos_sin(a: dict, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [L, head_dim/2]: the t, h and w frequencies, each on its section."""
    hd2 = a["head_dim"] // 2
    inv = 1.0 / (a["rope_theta"] ** (torch.arange(0, hd2, dtype=torch.float32, device=positions.device) / hd2))
    freqs = positions[..., None].float() * inv  # [3, L, hd2]
    parts = torch.split(freqs, list(a["mrope_section"]), dim=-1)
    f = torch.cat([part[i % 3] for i, part in enumerate(parts)], dim=-1)
    return f.cos(), f.sin()


def served_logits(a: dict, cfg: dict, state, precision: dict, requests: list[dict], device) -> list[torch.Tensor]:
    """For each request (``image``, ``prompt``, ``served`` token ids), the
    logits [len(served), vocab] f32 at the position that predicts each served
    token: the prompt's last position (the prefill) for the first, the step
    that reads the token before it for each later one. ``cfg`` is the
    configuration (its system prompt and pixel budget)."""
    kw = cfg["program"]["kwargs"]
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            return _served_logits(a, Weights(state, precision), precision, requests, tokenizer(),
                                  kw["system_prompt"], kw["min_pixels"], kw["max_pixels"], device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _served_logits(a, weights, precision, requests, tokenizer, system, min_pixels, max_pixels, device):
    images = [patches(a, r["image"], min_pixels, max_pixels, device) for r in requests]
    vision = towers(a, weights, images)
    table = weights.raw("model.embed_tokens.weight")
    xs, ropes, starts = [], [], []
    for r, (_, grid), emb in zip(requests, images, vision):
        ids = prompt_ids(a, tokenizer, system, r["prompt"], grid)
        seq = torch.tensor(ids + list(r["served"][:-1]), device=device)
        x = table[seq]
        img = (seq[: len(ids)] == a["image_token_id"]).nonzero()[:, 0]  # a served token of that id is text
        x[img] = emb
        xs.append(x)
        ropes.append(mrope_cos_sin(a, mrope_positions(a, ids, grid, len(r["served"]) - 1).to(device)))
        starts.append(len(ids))
    del vision, table
    nh, kvh, d, eps = a["heads"], a["kv_heads"], a["head_dim"], a["rms_eps"]
    kv_int8 = precision.get("kv") == "int8"
    for i in range(a["layers"]):
        p = f"model.layers.{i}."
        ln1, ln2 = weights.raw(p + "input_layernorm.weight"), weights.raw(p + "post_attention_layernorm.weight")
        qp, kp, vp, op = (weights.linear(p + f"self_attn.{r}_proj") for r in "qkvo")
        gate, up, down = (weights.linear(p + f"mlp.{r}_proj") for r in ("gate", "up", "down"))
        for j, x in enumerate(xs):
            n = x.shape[0]
            h = rms_norm(x, ln1, eps)
            q = dense(h, qp).view(n, nh, d).transpose(0, 1)
            k = dense(h, kp).view(n, kvh, d).transpose(0, 1)
            v = dense(h, vp).view(n, kvh, d).transpose(0, 1)
            cos, sin = ropes[j]
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
            k, v = (t.repeat_interleave(nh // kvh, dim=0) for t in (k, v))
            causal = torch.ones(n, n, dtype=torch.bool, device=device).tril()
            o = attend(q, k, v, causal)
            if kv_int8:  # decode steps read the int8 cache: every position from the first served token on
                start = starts[j]
                o[:, start:] = attend(q[:, start:], quantize_vectors(k), quantize_vectors(v), causal[start:])
            x = x + dense(o.transpose(0, 1).reshape(n, nh * d), op)
            h = rms_norm(x, ln2, eps)
            xs[j] = x + dense(F.silu(dense(h, gate)) * dense(h, up), down)
    final = weights.raw("model.norm.weight")
    head = weights.linear("lm_head", head=True) if not a["tie"] else (weights.raw("model.embed_tokens.weight"),
                                                                       None, False)
    return [dense(rms_norm(x[s - 1:], final, eps), head) for x, s in zip(xs, starts)]


# ---------------------------------------------------------------------- work


def window_patches(a: dict, grid: tuple) -> list[int] | None:
    """Real patches in each attention window (Qwen2.5-VL), or None (whole image)."""
    t = a["tower"]
    if t["window_size"] is None:
        return None
    m = t["spatial_merge_size"]
    win = t["window_size"] // m // t["patch"]
    uh, uw = grid[1] // m, grid[2] // m
    return [min(win, uh - r) * min(win, uw - c) * m * m for r in range(0, uh, win) for c in range(0, uw, win)]


def count_work(a: dict, cfg: dict, work, shape: dict, served: int) -> None:
    """One answered request's operations (``shape`` from :func:`request_shape`):
    its tower, its prefill, its decode steps; int8 products under W8A8."""
    from owcbench import roofline

    int8 = cfg["precision"]["weights"] == "int8" and cfg["precision"].get("activations") == "int8"
    grid, prompt_tokens = shape["grid"], shape["prompt_tokens"]
    roofline.tower_work(work, a["tower"], grid[0] * grid[1] * grid[2], window_patches(a, grid), int8)
    roofline.prefill_work(work, a, prompt_tokens, int8)
    roofline.decode_work(work, a, prompt_tokens, served, int8)

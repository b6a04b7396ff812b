"""Plain reference of Kimi-VL (Kimi-VL-A3B-Instruct): preprocessing, MoonViT and the MLA/MoE decoder in f32.

Written from the published description (the released ``modeling_kimi_vl.py``
with its MoonViT tower and projector, the DeepSeek-V3 decoder layer it uses,
and the Kimi-VL technical report, arXiv:2504.07491), with no kernel, cache
or padding: each sampled request's prompt and the tokens it was served
attend within themselves alone, unpadded, in the expanded MLA form (k and v
of every head from the latent), with dense causal attention; the products
run over the rows of every request at once, and the mixture of experts
expert by expert (each expert over the rows that chose it). Matrix products
run in f32 with TF32 off. The drawn bf16 tensors are kept and upcast one
layer at a time, which is exact (they are bf16 values) and keeps f32 weights
(4 bytes a parameter, 66 GB) off the card.

It works out again everything the serving path derives from its inputs: the
resize (the antialiased bicubic of :mod:`owcbench.reference.qwen2_vl`, the
native resizer's semantics) and the patches in row-major order, the 2D rope
on interleaved pairs as complex products, the learned position grid
resized by torch's bicubic, the 2 x 2 merge of row-major patches, the chat
template's tokens (its own byte-level BPE of the pinned tokenizer), the
text positions, the router's choice and weights.

Departures from the published model, each set by the configuration's
``assumed``: images are resized to multiples of 28 px under the processor's
token limit (4096 patches: the Qwen2-VL rule with factor 28, min_pixels
3136) instead of the released processor's resize-then-pad; the tokenizer is
the benchmark's pinned fixture with Kimi-VL's special ids. A precision (``weights``: "bf16", "int8" or "fp8";
``activations``: None, "int8" or "fp8") quantizes every linear layer but
the patch embedding, the router and the LM head, as
:mod:`owcbench.reference.qwen2_vl` does, the experts each as its own matrix.

What a served token is held to. With the benchmark's random weights this
decoder is chaotic in bf16: the sigmoid router's 6th and 7th choices of 64
lie a few thousandths apart, a rounding of the residual stream flips such a
near-tie, the flipped expert moves the stream by a large share of its norm,
and the flips compound over the 26 MoE layers, so that at the last one most
positions of a bf16 run route apart from the f32 run. The f32 trajectory is
then one of many that a correct bf16 model follows, and a token's gap to it
alone mixes that spread with any fault. So in the configuration's own
precision the reference also runs ``TRAJECTORIES`` trajectories that hold
the residual stream in bf16, as the released model does, each rounding it
stochastically with a generator of its own (:func:`round_bf16`), and a
served token's gap is its least over the f32 trajectory and those
(:func:`decoder_logits`). A control is one trajectory in its own precision,
its tokens held to the same rule.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from owcbench.reference.qwen2_vl import Weights, dense, layer_norm, resize, rms_norm, smart_resize
from owcbench.tokenizer import BASE_TOKENIZER, ByteLevelBPE, pinned_tokenizer

MEAN = STD = 0.5
# Trajectories that hold the residual stream in bf16, beside the f32 one, in
# the configuration's own precision (:func:`decoder_logits`).
TRAJECTORIES = 16


# ------------------------------------------------------------------- sizes


def arch(hf: dict) -> dict:
    """The sizes of a Kimi-VL configuration (the catalog's text config plus ``vision_config``)."""
    v = hf["vision_config"]
    merge = v.get("merge_kernel_size", [2, 2])[0]
    e = v["hidden_size"]
    tower = dict(embed_dim=e, num_heads=v["num_attention_heads"], depth=v["num_hidden_layers"],
                 intermediate_size=v["intermediate_size"], mlp="plain", patch=v["patch_size"],
                 patch_dim=3 * v["patch_size"] ** 2, spatial_merge_size=merge, out_hidden=hf["hidden_size"],
                 fullatt_block_indexes=None, pos_grid=(v["init_pos_emb_height"], v["init_pos_emb_width"]))
    return dict(
        hidden=hf["hidden_size"], heads=hf["num_attention_heads"], layers=hf["num_hidden_layers"],
        vocab=hf["vocab_size"], intermediate=hf["intermediate_size"], moe_intermediate=hf["moe_intermediate_size"],
        experts=hf["n_routed_experts"], shared=hf["n_shared_experts"], top_k=hf["num_experts_per_tok"],
        dense_layers=hf["first_k_dense_replace"], scale=hf["routed_scaling_factor"],
        norm_topk=hf["norm_topk_prob"], rank=hf["kv_lora_rank"], nope=hf["qk_nope_head_dim"],
        rope=hf["qk_rope_head_dim"], vdim=hf["v_head_dim"], rms_eps=hf["rms_norm_eps"],
        rope_theta=float(hf["rope_theta"]), tie=hf["tie_word_embeddings"], tower=tower,
    )


def hf_layout(hf: dict) -> list[tuple[str, tuple, str]]:
    """(checkpoint name, shape, kind) of every tensor of the released layout;
    kind is how the benchmark draws it: "normal" (N(0, 0.02)), "bias"
    (N(0, 0.02); the router's ``e_score_correction_bias`` too) or "norm"
    (1 + N(0, 0.1))."""
    a, t = arch(hf), arch(hf)["tower"]
    out: list[tuple[str, tuple, str]] = []

    def lin(name, d_out, d_in, bias=False):
        out.append((f"{name}.weight", (d_out, d_in), "normal"))
        if bias:
            out.append((f"{name}.bias", (d_out,), "bias"))

    def norm(name, d, bias=False):
        out.append((f"{name}.weight", (d,), "norm"))
        if bias:
            out.append((f"{name}.bias", (d,), "bias"))

    def mlp(p, inter):
        lin(p + "gate_proj", inter, h)
        lin(p + "up_proj", inter, h)
        lin(p + "down_proj", h, inter)

    h, nh = a["hidden"], a["heads"]
    out.append(("language_model.model.embed_tokens.weight", (a["vocab"], h), "normal"))
    for i in range(a["layers"]):
        p = f"language_model.model.layers.{i}."
        norm(p + "input_layernorm", h)
        lin(p + "self_attn.q_proj", nh * (a["nope"] + a["rope"]), h)
        lin(p + "self_attn.kv_a_proj_with_mqa", a["rank"] + a["rope"], h)
        norm(p + "self_attn.kv_a_layernorm", a["rank"])
        lin(p + "self_attn.kv_b_proj", nh * (a["nope"] + a["vdim"]), a["rank"])
        lin(p + "self_attn.o_proj", h, nh * a["vdim"])
        norm(p + "post_attention_layernorm", h)
        if i < a["dense_layers"]:
            mlp(p + "mlp.", a["intermediate"])
            continue
        lin(p + "mlp.gate", a["experts"], h)
        out.append((p + "mlp.gate.e_score_correction_bias", (a["experts"],), "bias"))
        for e in range(a["experts"]):
            mlp(p + f"mlp.experts.{e}.", a["moe_intermediate"])
        if a["shared"]:
            mlp(p + "mlp.shared_experts.", a["moe_intermediate"] * a["shared"])
    norm("language_model.model.norm", h)
    if not a["tie"]:
        lin("language_model.lm_head", a["vocab"], h)
    e, ti = t["embed_dim"], t["intermediate_size"]
    out.append(("vision_tower.patch_embed.proj.weight", (e, 3, t["patch"], t["patch"]), "normal"))
    out.append(("vision_tower.patch_embed.proj.bias", (e,), "bias"))
    out.append(("vision_tower.patch_embed.pos_emb.weight", (*t["pos_grid"], e), "normal"))
    for i in range(t["depth"]):
        p = f"vision_tower.encoder.blocks.{i}."
        norm(p + "norm0", e, True)
        lin(p + "wqkv", 3 * e, e, True)
        lin(p + "wo", e, e, True)
        norm(p + "norm1", e, True)
        lin(p + "mlp.fc0", ti, e, True)
        lin(p + "mlp.fc1", e, ti, True)
    norm("vision_tower.encoder.final_layernorm", e, True)
    m = e * t["spatial_merge_size"] ** 2
    norm("multi_modal_projector.pre_norm", e, True)
    lin("multi_modal_projector.linear_1", m, m, True)
    lin("multi_modal_projector.linear_2", h, m, True)
    return out


# ---------------------------------------------------------------- the inputs


@functools.cache
def _tokenizer_spec(ids: tuple) -> dict:
    return pinned_tokenizer(json.loads(BASE_TOKENIZER.read_text()), dict(ids))


def tokenizer_spec(cfg: dict) -> dict:
    """The fixture tokenizer with the configuration's special tokens (``tokens.special``) pinned."""
    return _tokenizer_spec(tuple(sorted(cfg["tokens"]["special"].items())))


@functools.cache
def _encoder(ids: tuple) -> ByteLevelBPE:
    return ByteLevelBPE(_tokenizer_spec(ids))


def tokenizer(cfg: dict) -> ByteLevelBPE:
    return _encoder(tuple(sorted(cfg["tokens"]["special"].items())))


def checkpoint_dir(path, cfg: dict) -> None:
    """Everything of the checkpoint but its tensors: the released config.json
    layout (``text_config`` with the token ids, ``vision_config``,
    ``media_placeholder_token_id``) and the pinned tokenizer."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    hf, tok = cfg["hf_config"], cfg["tokens"]
    special = tok["special"]
    text = {k: val for k, val in hf.items() if k != "vision_config"}
    text.update(model_type="deepseek_v3", bos_token_id=special["[BOS]"], eos_token_id=special[tok["eos"]],
                pad_token_id=special[tok["pad"]])
    config = dict(model_type="kimi_vl", architectures=["KimiVLForConditionalGeneration"], text_config=text,
                  vision_config=hf["vision_config"], media_placeholder_token_id=special[tok["image"]])
    (path / "config.json").write_text(json.dumps(config))
    (path / "tokenizer.json").write_text(json.dumps(tokenizer_spec(cfg)))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": tok["eos"], "pad_token": tok["pad"], "clean_up_tokenization_spaces": False}))


def image_grid(a: dict, width: int, height: int, min_pixels: int, max_pixels: int) -> tuple[int, int, int]:
    t = a["tower"]
    rh, rw = smart_resize(height, width, t["patch"] * t["spatial_merge_size"], min_pixels, max_pixels)
    return 1, rh // t["patch"], rw // t["patch"]


def request_shape(a: dict, cfg: dict, request) -> dict:
    kw = cfg["program"]["kwargs"]
    grid = image_grid(a, request.width, request.height, kw["min_pixels"], kw["max_pixels"])
    return dict(grid=grid, prompt_tokens=len(prompt_ids(a, cfg, kw["system_prompt"], request.prompt, grid)))


def prompt_ids(a: dict, cfg: dict, system: str, prompt: str, grid: tuple) -> list[int]:
    """Kimi-VL's chat template for one image and a question, tokenized, the
    image's one placeholder expanded to its merged token count."""
    text = (f"<|im_system|>system<|im_middle|>{system}<|im_end|><|im_user|>user<|im_middle|>"
            f"<|media_start|>image<|media_content|><|media_pad|><|media_end|>{prompt}<|im_end|>"
            f"<|im_assistant|>assistant<|im_middle|>")
    pad = cfg["tokens"]["special"][cfg["tokens"]["image"]]
    merged = grid[1] * grid[2] // a["tower"]["spatial_merge_size"] ** 2
    ids: list[int] = []
    for tok in tokenizer(cfg).encode(text):
        ids.extend([tok] * merged if tok == pad else [tok])
    return ids


def patches(a: dict, image, min_pixels: int, max_pixels: int, device) -> tuple[torch.Tensor, tuple]:
    """Resized, normalised patches [h * w, 3 * 14 * 14] f32 in row-major order
    (each patch channel-major, the Conv2d kernel's layout), and the grid."""
    t = a["tower"]
    pixels = np.asarray(image.convert("RGB"))
    grid = image_grid(a, pixels.shape[1], pixels.shape[0], min_pixels, max_pixels)
    p, gh, gw = t["patch"], grid[1], grid[2]
    px = (resize(pixels, gh * p, gw * p).to(device).float() / 255.0 - MEAN) / STD  # [3, H, W]
    x = px.reshape(3, gh, p, gw, p).permute(1, 3, 0, 2, 4)
    return x.reshape(gh * gw, 3 * p * p), grid


# ----------------------------------------------------------------- the tower


def rope_2d(a: dict, gh: int, gw: int, device) -> torch.Tensor:
    """[h * w, head_dim / 2] complex: MoonViT's ``Rope2DPosEmb`` for a grid,
    row-major: pair 2m turns by column x freq m, pair 2m + 1 by row x freq m,
    freq m = 10000^(-4m / head_dim)."""
    d = a["tower"]["embed_dim"] // a["tower"]["num_heads"]
    freqs = 1.0 / (10000.0 ** (torch.arange(0, d, 4, device=device)[: d // 4].float() / d))
    pos = torch.arange(gh * gw, device=device)
    x, y = (pos % gw).float(), (pos // gw).float()
    xc = torch.polar(torch.ones(gh * gw, d // 4, device=device), torch.outer(x, freqs))
    yc = torch.polar(torch.ones(gh * gw, d // 4, device=device), torch.outer(y, freqs))
    return torch.stack([xc, yc], dim=-1).reshape(gh * gw, d // 2)


def rotate_pairs(x: torch.Tensor, cis: torch.Tensor) -> torch.Tensor:
    """x [P, H, D] with interleaved pairs as complex numbers, times cis [P, D/2]."""
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    return torch.view_as_real(xc * cis[:, None]).flatten(-2)


def towers(a: dict, weights: Weights, images: list[tuple[torch.Tensor, tuple]]) -> list[torch.Tensor]:
    """Merged and projected embeddings [P / 4, hidden] of each (patches, grid), block by block."""
    t = a["tower"]
    e, nh = t["embed_dim"], t["num_heads"]
    d, m = e // nh, t["spatial_merge_size"]
    dev = images[0][0].device
    pe = weights.raw("vision_tower.patch_embed.proj.weight").reshape(e, -1)
    pe_b = weights.raw("vision_tower.patch_embed.proj.bias")
    grid_emb = weights.raw("vision_tower.patch_embed.pos_emb.weight")
    xs, ropes = [], []
    for p, (_, gh, gw) in images:
        pos = grid_emb if (gh, gw) == tuple(grid_emb.shape[:2]) else F.interpolate(
            grid_emb.permute(2, 0, 1)[None], size=(gh, gw), mode="bicubic", align_corners=False)[0].permute(1, 2, 0)
        xs.append(torch.matmul(p, pe.t()) + pe_b + pos.reshape(gh * gw, e))
        ropes.append(rope_2d(a, gh, gw, dev))

    def norm(x, name):
        return layer_norm(x, weights.raw(f"{name}.weight"), weights.raw(f"{name}.bias"), 1e-5)

    for i in range(t["depth"]):
        p = f"vision_tower.encoder.blocks.{i}."
        qkv, wo = weights.linear(p + "wqkv"), weights.linear(p + "wo")
        fc0, fc1 = weights.linear(p + "mlp.fc0"), weights.linear(p + "mlp.fc1")
        for j, x in enumerate(xs):
            n = x.shape[0]
            q, k, v = dense(norm(x, p + "norm0"), qkv).view(n, 3, nh, d).unbind(1)
            q, k = rotate_pairs(q, ropes[j]), rotate_pairs(k, ropes[j])
            s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
            o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v).reshape(n, e)
            x = x + dense(o, wo)
            x = x + dense(F.gelu(dense(norm(x, p + "norm1"), fc0), approximate="tanh"), fc1)
            xs[j] = x
    lin1, lin2 = weights.linear("multi_modal_projector.linear_1"), weights.linear("multi_modal_projector.linear_2")
    out = []
    for x, (_, (_, gh, gw)) in zip(xs, images):
        x = norm(x, "vision_tower.encoder.final_layernorm")
        units = x.view(gh // m, m, gw // m, m, e).permute(0, 2, 1, 3, 4).reshape(-1, m * m, e)
        merged = norm(units, "multi_modal_projector.pre_norm").reshape(-1, m * m * e)
        out.append(dense(F.gelu(dense(merged, lin1)), lin2))
    return out


# --------------------------------------------------------------- the decoder


def rope_halves(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's ``apply_rotary_pos_emb``: interleaved pairs regrouped
    into halves, then the halves convention; x [H, L, D], cos/sin [L, D]."""
    h, l, d = x.shape
    x = x.view(h, l, d // 2, 2).transpose(-1, -2).reshape(h, l, d)
    rot = torch.cat([-x[..., d // 2 :], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def route(a: dict, x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids [n, k], weights [n, k]) of the noaux_tc router (one group): sigmoid
    scores; the top k of scores plus the bias chosen; the chosen scores
    normalised, times the scaling factor."""
    scores = torch.sigmoid(torch.matmul(x, gate.t()))
    idx = torch.topk(scores + bias, a["top_k"], dim=-1).indices
    w = scores.gather(1, idx)
    if a["norm_topk"] and a["top_k"] > 1:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * a["scale"]


def swiglu(x, gate, up, down):
    return dense(F.silu(dense(x, gate)) * dense(x, up), down)


def moe(a: dict, x: torch.Tensor, router: tuple, experts: list, shared) -> tuple[torch.Tensor, torch.Tensor]:
    """(the layer's MoE output, the chosen ids): each expert over the rows that chose it."""
    idx, w = route(a, x, *router)
    out = torch.zeros_like(x)
    for e, (gate, up, down) in enumerate(experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out.index_add_(0, rows, swiglu(x[rows], gate, up, down) * w[rows, slot, None])
    if shared is not None:
        out = out + swiglu(x, *shared)
    return out, idx


def served_logits(a: dict, cfg: dict, state, precision: dict, requests: list[dict], device,
                  choices: list | None = None) -> list[torch.Tensor]:
    """For each request (``image``, ``prompt``, ``served`` token ids), the
    logits [len(served), vocab] f32 at the position that predicts each
    served token (the prompt's last position for the first). In the
    configuration's own precision they are the trajectories' rows of
    :func:`decoder_logits` over ``TRAJECTORIES`` held trajectories besides the
    f32 one (the module's docstring says why); in another precision (a
    control) the one trajectory's logits. ``choices``, where given,
    receives per request and MoE layer the experts that the f32 trajectory
    chose at those positions ([len(served), k])."""
    kw = cfg["program"]["kwargs"]
    held = TRAJECTORIES if precision == cfg["precision"] else 0
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            return _served_logits(a, cfg, Weights(state, precision), requests, kw["system_prompt"],
                                  kw["min_pixels"], kw["max_pixels"], device, choices, held)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _served_logits(a, cfg, weights, requests, system, min_pixels, max_pixels, device, choices, held):
    images = [patches(a, r["image"], min_pixels, max_pixels, device) for r in requests]
    vision = towers(a, weights, images)
    table = weights.raw("language_model.model.embed_tokens.weight")
    pad = cfg["tokens"]["special"][cfg["tokens"]["image"]]
    xs, starts = [], []
    for r, (_, grid), emb in zip(requests, images, vision):
        ids = prompt_ids(a, cfg, system, r["prompt"], grid)
        seq = torch.tensor(ids + list(r["served"][:-1]), device=device)
        x = table[seq]
        img = (seq[: len(ids)] == pad).nonzero()[:, 0]  # a served token of that id is text
        x[img] = emb
        xs.append(x)
        starts.append(len(ids))
    del vision, table
    return decoder_logits(a, weights, xs, starts, choices, held)


def round_bf16(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """f32 ``x`` rounded to bf16 values stochastically: to the next bf16 away
    from zero with the probability of its distance from the one toward zero
    (a uniform 16-bit draw added to the low half of each f32's bits, which
    is then cut)."""
    bits = x.contiguous().view(torch.int32)
    draw = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device, dtype=torch.int32)
    return ((bits + draw) & -(1 << 16)).view(torch.float32)


def decoder_logits(a: dict, weights: Weights, xs: list[torch.Tensor], starts: list[int],
                   choices: list | None = None, held: int = 0) -> list[torch.Tensor]:
    """The decoder over each sequence's input embeddings ``xs[j]`` [n, hidden]
    f32 (positions 0 .. n - 1): the logits [n - starts[j] + 1, vocab] f32 from
    position ``starts[j] - 1`` on; ``choices`` as :func:`served_logits`'.

    With ``held`` > 0 the decoder also runs ``held`` trajectories of every
    sequence that hold the residual stream in bf16, as the released model
    does: the input and the stream after each attention and each MLP or MoE
    are rounded by :func:`round_bf16`, trajectory ``m`` drawing from a
    generator seeded ``m``. Each sequence's rows are then ``-G``, where
    ``G[t, v]`` is the least, over the f32 trajectory and the held ones, of
    how far token ``v``'s logit at position ``t`` lies below that
    trajectory's best: the gap of a token at a row is its least gap over the
    trajectories. Matrix products run over the rows of every sequence and
    trajectory at once, attention per sequence."""
    device = xs[0].device
    nh, nope, rope, vdim, rank, eps = a["heads"], a["nope"], a["rope"], a["vdim"], a["rank"], a["rms_eps"]
    scale = (nope + rope) ** -0.5
    inv = 1.0 / (a["rope_theta"] ** (torch.arange(0, rope, 2, device=device).float() / rope))
    gens = [None] + [torch.Generator(device).manual_seed(m) for m in range(1, held + 1)]
    runs = [(j, m) for m in range(held + 1) for j in range(len(xs))]  # (sequence, trajectory)

    def hold(k: int, x: torch.Tensor) -> torch.Tensor:
        m = runs[k][1]
        return x if m == 0 else round_bf16(x, gens[m])

    hs = [hold(k, xs[j].clone()) for k, (j, _) in enumerate(runs)]
    lengths = [h.shape[0] for h in hs]
    tables = []
    for x in xs:
        f = torch.arange(x.shape[0], device=device).float()[:, None] * inv
        emb = torch.cat([f, f], dim=-1)
        tables.append((emb.cos(), emb.sin()))
    if choices is not None:
        choices.extend([] for _ in xs)
    for i in range(a["layers"]):
        p = f"language_model.model.layers.{i}."
        ln1, ln2 = weights.raw(p + "input_layernorm.weight"), weights.raw(p + "post_attention_layernorm.weight")
        qp, ka, kb, op = (weights.linear(p + f"self_attn.{r}") for r in
                          ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"))
        ka_ln = weights.raw(p + "self_attn.kv_a_layernorm.weight")
        h = rms_norm(torch.cat(hs), ln1, eps)
        q_all, ckv_all = dense(h, qp), dense(h, ka)
        latent_all = rms_norm(ckv_all[:, :rank], ka_ln, 1e-6)
        kv_all = dense(latent_all, kb)
        outs = []
        for k, (j, _) in enumerate(runs):
            rows = slice(sum(lengths[:k]), sum(lengths[: k + 1]))
            n = lengths[k]
            q = q_all[rows].view(n, nh, nope + rope).transpose(0, 1)
            cos, sin = tables[j]
            k_pe = rope_halves(ckv_all[rows][None, :, rank:], cos, sin)  # [1, n, rope]
            kv = kv_all[rows].view(n, nh, nope + vdim).transpose(0, 1)
            q = torch.cat([q[..., :nope], rope_halves(q[..., nope:], cos, sin)], dim=-1)
            key = torch.cat([kv[..., :nope], k_pe.expand(nh, n, rope)], dim=-1)
            s = torch.matmul(q, key.transpose(-1, -2)) * scale
            causal = torch.ones(n, n, dtype=torch.bool, device=device).tril()
            o = torch.matmul(torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1), kv[..., nope:])
            outs.append(o.transpose(0, 1).reshape(n, nh * vdim))
        attn = dense(torch.cat(outs), op).split(lengths)
        hs = [hold(k, x + o) for k, (x, o) in enumerate(zip(hs, attn))]
        del q_all, ckv_all, latent_all, kv_all, outs, attn, qp, ka, kb, op
        h = rms_norm(torch.cat(hs), ln2, eps)
        if i < a["dense_layers"]:
            out = swiglu(h, *(weights.linear(p + f"mlp.{r}_proj") for r in ("gate", "up", "down")))
        else:
            router = (weights.raw(p + "mlp.gate.weight"), weights.raw(p + "mlp.gate.e_score_correction_bias"))
            experts = [[weights.linear(p + f"mlp.experts.{e}.{r}_proj") for r in ("gate", "up", "down")]
                       for e in range(a["experts"])]
            shared = ([weights.linear(p + f"mlp.shared_experts.{r}_proj") for r in ("gate", "up", "down")]
                      if a["shared"] else None)
            out, idx = moe(a, h, router, experts, shared)
            del experts, shared, router
            if choices is not None:
                for k, part in enumerate(idx.split(lengths)[: len(xs)]):  # the f32 trajectory's
                    choices[k].append(part[starts[k] - 1 :])
        hs = [hold(k, x + o) for k, (x, o) in enumerate(zip(hs, out.split(lengths)))]
        del h, out
    final = weights.raw("language_model.model.norm.weight")
    head = weights.linear("language_model.lm_head", head=True)
    logits = []
    for j, s in enumerate(starts):
        least = None
        for m in range(held + 1):
            rows = dense(rms_norm(hs[m * len(xs) + j][s - 1 :], final, eps), head)
            if not held:
                least = rows
                break
            gap = rows.max(-1, keepdim=True).values - rows
            least = gap if least is None else torch.minimum(least, gap)
            del rows, gap
        logits.append(least if not held else -least)
    return logits


# ---------------------------------------------------------------------- work


def token_flops(a: dict, keys: float, absorbed: bool) -> float:
    """One token's decoder operations over every layer, its attention over
    ``keys`` keys: the MLA projections, the dense MLP of the leading layers,
    and in a MoE layer the router, ``top_k`` routed experts and the shared
    ones; the attention in the expanded form (q.k at 192, p.v at 128 per
    head) or, in a decode step, the absorbed one (q.k and p.v at the 576-wide
    cache entry, plus each head's key and value expansion)."""
    h, nh, nope, rope, vdim, rank = a["hidden"], a["heads"], a["nope"], a["rope"], a["vdim"], a["rank"]
    proj = 2 * h * nh * (nope + rope) + 2 * h * (rank + rope) + 2 * nh * vdim * h
    if absorbed:
        proj += 2 * nh * nope * rank + 2 * nh * rank * vdim  # the query's and output's expansions
        attn = 2 * nh * ((rank + rope) + rank) * keys
    else:
        proj += 2 * rank * nh * (nope + vdim)  # kv_b
        attn = 2 * nh * ((nope + rope) + vdim) * keys
    expert = 3 * 2 * h * a["moe_intermediate"]
    moe = 2 * h * a["experts"] + a["top_k"] * expert + a["shared"] * expert
    dense_mlp = 3 * 2 * h * a["intermediate"]
    mlps = a["dense_layers"] * dense_mlp + (a["layers"] - a["dense_layers"]) * moe
    return a["layers"] * (proj + attn) + mlps


def count_work(a: dict, cfg: dict, work, shape: dict, served: int) -> None:
    """One answered request's operations (``shape`` from :func:`request_shape`),
    all in bf16: its tower (MoonViT and the projector), its prefill (every
    prompt token, causal attention, the head at the last position) and its
    decode steps (each over the token before it, the absorbed attention over
    the prompt and the tokens so far, the head)."""
    from owcbench import roofline

    grid, n, steps = shape["grid"], shape["prompt_tokens"], max(served - 1, 0)
    roofline.tower_work(work, a["tower"], grid[0] * grid[1] * grid[2], None, False)
    head = 2 * a["hidden"] * a["vocab"]

    def over(first: int, count: int, absorbed: bool) -> float:
        """token_flops summed over ``count`` tokens attending to first, first + 1, ... keys (linear in keys)."""
        base, per_key = token_flops(a, 0, absorbed), token_flops(a, 1, absorbed) - token_flops(a, 0, absorbed)
        return count * base + per_key * (count * first + count * (count - 1) / 2)

    work.add(over(1, n, False) + head)
    work.add(over(n + 1, steps, True) + steps * head)

"""Kimi-VL (Kimi-VL-A3B-Instruct) in PyTorch: MoonViT tower, MLA + MoE decoder.

The decoder follows DeepSeek-V3's layer equations, which Kimi-VL's language
model uses (the ``deepseek_v3`` text config of the released checkpoint):

- multi-head latent attention (MLA) without a query low rank: ``q_proj``
  gives each head a 128-wide "nope" part and a 64-wide rope part;
  ``kv_a_proj_with_mqa`` gives one 512-wide latent, RMS-normed by
  ``kv_a_layernorm``, and one 64-wide rope key that every head shares;
  ``kv_b_proj`` expands the latent to each head's 128-wide key and value.
  Rope runs on interleaved pairs (kept here, as in DeepSeek-V3's code, in
  the de-interleaved halves layout on both q and k: the products are the
  same). The softmax scale is 1/sqrt(128 + 64).
- the prefill runs the expanded form (``mla_prefill_attention``, SDPA);
  a decode step the absorbed form over the latent cache
  (``mla_decode_attention``): each head's nope query times its key
  expansion gives a 512-wide query against the latent, so 16 query heads
  share one 576-wide key (latent and rope key), whose first 512 columns are
  the value; each head's output then takes its value expansion.
- layer 0 is a dense SwiGLU MLP; the others a mixture of experts
  (:class:`MoE`): a sigmoid router in f32, the top 6 of its scores plus
  ``e_score_correction_bias`` chosen (the bias chooses, it does not
  weight), the chosen scores normalised and scaled by
  ``routed_scaling_factor``, each expert ``down(silu(gate(x)) * up(x))``,
  and the shared experts as one SwiGLU MLP added to the routed sum.

The routed product (:func:`routed_experts`) computes each row's chosen
experts only: rows sorted by expert, the experts' stacked weights
([E, 2 * I, H] gate and up, [E, H, I] down) multiplied group by group with
``torch._grouped_mm`` over device offsets, so a decode step holds no host
synchronisation and a CUDA graph captures it whole.

MoonViT (:class:`MoonViT`) is a SigLIP-SO400M-wide ViT at native
resolution: a patch-14 embedding plus the 64 x 64 learned position grid,
bicubically interpolated to each image's patch grid; 2D rope (theta 10000)
on the heads' interleaved pairs, alternating column and row frequencies;
attention within each image through K2 (``flash_attention`` at head_dim 72,
a padded batch with a prefix key mask); GELU-tanh MLPs and a final
LayerNorm; then the 2 x 2 patch merge and the projector (LayerNorm 1152,
4608 -> 4608, GELU, 4608 -> hidden). Patches travel in merge-window order
(each 2 x 2 group contiguous), so the merge is a reshape; the position
grid and the rope angles follow the same order.

The decode pool holds one latent tensor [L, B, 1, S, 576] (``cache_shapes``),
one shared key head, which ``nn/qwen2_vl.py``'s pool and decode machinery
read as a cache of one KV head; the layer supplies its own query and cache
write, attention and post-attention work (``step_query``,
``step_attention``, ``step_post``). As K3 is for the Qwen2 layer, the MLA
decode attention is launched once a layer a step between the step's CUDA
graph segments, into the static buffer that the next segment reads.

Tracing (:mod:`~lmms_owc_tpu_torch.utils._hostprof`, on only while its
switch is): host spans ``mla_attention`` and ``moe_experts`` around the
prefill's attention and routed product, counters ``moe_calls`` and
``moe_routed_rows`` (rows times experts per token; a decode graph's come
back at each replay), and device tallies per routed product (:func:`moe_tallies`).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lmms_owc_tpu_torch.nn.layers import LayerNorm, Linear, RMSNorm, apply_rope, gelu
from lmms_owc_tpu_torch.nn.loader import find_tensor, load_hf_tensors
from lmms_owc_tpu_torch.nn.qwen2_vl import _row_blocks
from lmms_owc_tpu_torch.ops.attention import flash_attention
from lmms_owc_tpu_torch.ops.quant import materialize_on_device
from lmms_owc_tpu_torch.utils import _hostprof
from lmms_owc_tpu_torch.utils._hostprof import hostprof

__all__ = [
    "KimiDecoderLayer",
    "KimiVLConfig",
    "KimiVLModel",
    "MoE",
    "MoonViT",
    "MoonViTConfig",
    "grouped_mm",
    "init_params",
    "load_hf_weights",
    "mla_decode_attention",
    "mla_prefill_attention",
    "moe_tallies",
    "moe_tallies_reset",
    "position_embedding",
    "route",
    "routed_experts",
    "vision_rope_angles",
]


@dataclass(frozen=True)
class MoonViTConfig:
    hidden_size: int = 1152
    num_heads: int = 16
    intermediate_size: int = 4304
    depth: int = 27
    patch_size: int = 14
    pos_emb_height: int = 64
    pos_emb_width: int = 64
    spatial_merge_size: int = 2
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size**2

    @classmethod
    def from_hf_dict(cls, v: dict) -> "MoonViTConfig":
        merge = v.get("merge_kernel_size", [2, 2])
        return cls(
            hidden_size=v.get("hidden_size", 1152),
            num_heads=v.get("num_attention_heads", 16),
            intermediate_size=v.get("intermediate_size", 4304),
            depth=v.get("num_hidden_layers", 27),
            patch_size=v.get("patch_size", 14),
            pos_emb_height=v.get("init_pos_emb_height", 64),
            pos_emb_width=v.get("init_pos_emb_width", 64),
            spatial_merge_size=merge[0] if isinstance(merge, (list, tuple)) else int(merge),
        )


@dataclass(frozen=True)
class KimiVLConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    tie_word_embeddings: bool = False
    # Token ids (tokenizer_config.json of the released checkpoint): the image
    # placeholder, the media start that opens an image block, EOS and padding.
    image_token_id: int = 163605
    vision_start_token_id: int = 163602
    eos_token_id: int = 163586
    pad_token_id: int = 163839
    vision: MoonViTConfig = field(default_factory=MoonViTConfig)

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_dim(self) -> int:
        """One cached position: the latent and the shared rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @classmethod
    def from_hf_dict(cls, cfg: dict) -> "KimiVLConfig":
        """From a Kimi-VL ``config.json``: the released layout (``text_config``
        and ``vision_config`` beside ``media_placeholder_token_id``) or one
        flat text config with a ``vision_config``."""
        text = cfg.get("text_config", cfg)
        rope = text.get("rope_scaling")
        if rope:
            raise ValueError(f"rope scaling {rope!r} is not supported (Kimi-VL-A3B has none)")
        if text.get("n_group", 1) != 1 or text.get("topk_group", 1) != 1:
            raise ValueError("only n_group = topk_group = 1 routing is supported")
        if text.get("q_lora_rank") is not None:
            raise ValueError("only q_lora_rank null (Kimi-VL-A3B's) is supported")
        eos = text.get("eos_token_id", cfg.get("eos_token_id", 163586))
        return cls(
            vocab_size=text["vocab_size"],
            hidden_size=text["hidden_size"],
            num_layers=text["num_hidden_layers"],
            num_heads=text["num_attention_heads"],
            intermediate_size=text["intermediate_size"],
            moe_intermediate_size=text["moe_intermediate_size"],
            n_routed_experts=text["n_routed_experts"],
            n_shared_experts=text.get("n_shared_experts", 0) or 0,
            num_experts_per_tok=text["num_experts_per_tok"],
            first_k_dense_replace=text.get("first_k_dense_replace", 0),
            routed_scaling_factor=float(text.get("routed_scaling_factor", 1.0)),
            norm_topk_prob=bool(text.get("norm_topk_prob", True)),
            kv_lora_rank=text["kv_lora_rank"],
            qk_nope_head_dim=text["qk_nope_head_dim"],
            qk_rope_head_dim=text["qk_rope_head_dim"],
            v_head_dim=text["v_head_dim"],
            rms_norm_eps=text.get("rms_norm_eps", 1e-5),
            rope_theta=float(text.get("rope_theta", 800000.0)),
            tie_word_embeddings=bool(text.get("tie_word_embeddings", False)),
            image_token_id=cfg.get("media_placeholder_token_id", text.get("media_placeholder_token_id", 163605)),
            vision_start_token_id=cfg.get("media_start_token_id", 163602),
            eos_token_id=eos[0] if isinstance(eos, list) else eos,
            pad_token_id=text.get("pad_token_id", 163839),
            vision=MoonViTConfig.from_hf_dict(cfg.get("vision_config", {})),
        )


# ======================================================================= MoonViT


def vision_rope_angles(grid: tuple[int, int], v: MoonViTConfig) -> np.ndarray:
    """[h * w, head_dim / 2] rope angles of a patch grid (rows, columns) in
    merge-window order, on the head's pairs de-interleaved: pair ``j`` of
    the head turns by column x freq ``j // 2`` where ``j`` is even and by
    row x freq ``j // 2`` where it is odd, freq ``m`` = theta^(-4m / head_dim)."""
    h, w = grid
    m = v.spatial_merge_size
    d = v.head_dim
    inv = 1.0 / (v.rope_theta ** (np.arange(0, d, 4, dtype=np.float32)[: d // 4] / d))
    rows = np.arange(h)[:, None].repeat(w, 1)
    cols = np.arange(w)[None, :].repeat(h, 0)

    def merged(a):
        return a.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)

    x = merged(cols).astype(np.float32)[:, None] * inv  # [P, d/4]
    y = merged(rows).astype(np.float32)[:, None] * inv
    return np.stack([x, y], axis=-1).reshape(h * w, d // 2)  # pair j: x if even, y if odd


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[..., D] with pairs (x[2j], x[2j+1]) -> [..., D] halves (evens, then odds)."""
    return x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2).flatten(-2)


def _bicubic_rows(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] f32: torch's bicubic resize of a length (corners not
    aligned, no antialias) as a matrix, read off by resizing the identity."""
    eye = torch.eye(n_in, dtype=torch.float32, device=device)[None, None]
    return F.interpolate(eye, size=(n_out, n_in), mode="bicubic", align_corners=False)[0, 0]


def position_embedding(table: torch.Tensor, grid: tuple[int, int], merge: int) -> torch.Tensor:
    """The learned position grid [H0, W0, C] resized to ``grid`` (torch's
    bicubic, corners not aligned, in f32: one product per axis, the
    separable form of the 2D resize), [h * w, C] in merge-window order."""
    h, w = grid
    h0, w0, c = table.shape
    grid_emb = table.float()
    if (h, w) != (h0, w0):
        rows, cols = _bicubic_rows(h0, h, table.device), _bicubic_rows(w0, w, table.device)
        grid_emb = torch.matmul(rows, grid_emb.reshape(h0, w0 * c)).reshape(h, w0, c)
        grid_emb = torch.matmul(cols, grid_emb)  # [h, w, C]
    return grid_emb.reshape(h // merge, merge, w // merge, merge, c).permute(0, 2, 1, 3, 4).reshape(h * w, c)


class MoonViTBlock(nn.Module):
    def __init__(self, v: MoonViTConfig, dtype, device) -> None:
        super().__init__()
        e = v.hidden_size
        self.norm0 = LayerNorm(e, 1e-5, dtype, device)
        self.wqkv = Linear(e, 3 * e, True, dtype, device)
        self.wo = Linear(e, e, True, dtype, device)
        self.norm1 = LayerNorm(e, 1e-5, dtype, device)
        self.fc0 = Linear(e, v.intermediate_size, True, dtype, device)
        self.fc1 = Linear(v.intermediate_size, e, True, dtype, device)


class MoonViT(nn.Module):
    """The MoonViT tower and the Kimi-VL projector."""

    def __init__(self, v: MoonViTConfig, out_hidden: int, dtype, device) -> None:
        super().__init__()
        self.config = v
        e, m2 = v.hidden_size, v.spatial_merge_size**2
        self.patch_embed = Linear(v.patch_dim, e, True, dtype, device)
        self.pos_emb = nn.Parameter(torch.empty(v.pos_emb_height, v.pos_emb_width, e, dtype=dtype, device=device),
                                    requires_grad=False)
        self.blocks = nn.ModuleList(MoonViTBlock(v, dtype, device) for _ in range(v.depth))
        self.final_ln = LayerNorm(e, 1e-5, dtype, device)
        self.pre_norm = LayerNorm(e, 1e-5, dtype, device)
        self.linear_1 = Linear(e * m2, e * m2, True, dtype, device)
        self.linear_2 = Linear(e * m2, out_hidden, True, dtype, device)

    @torch.inference_mode()
    def forward(self, patches: torch.Tensor, pos: torch.Tensor, angles: torch.Tensor,
                patch_mask: torch.Tensor | None) -> torch.Tensor:
        """A batch of images' patches [N, P, 3*14*14] (merge-window order, P
        padded to a bucket), their position embeddings [N, P, C] and rope
        angles [N, P, head_dim/2] -> merged embeddings [N, P/4, out_hidden]
        (rows of padding garbage). ``patch_mask`` [N, P] marks real patches
        (a prefix run), None where all are."""
        v = self.config
        n, p, _ = patches.shape
        nh, d, e = v.num_heads, v.head_dim, v.hidden_size
        x = self.patch_embed(patches.to(self.patch_embed.weight.dtype)) + pos.to(self.patch_embed.weight.dtype)
        cos, sin = torch.cos(angles.float()), torch.sin(angles.float())
        for blk in self.blocks:
            qkv = blk.wqkv(blk.norm0(x)).view(n, p, 3, nh, d)
            q, k, vv = (t.transpose(1, 2) for t in qkv.unbind(2))  # [N, nh, P, d]
            q = apply_rope(_deinterleave(q), cos, sin)
            k = apply_rope(_deinterleave(k), cos, sin)
            attn = flash_attention(q, k, vv, kv_mask=patch_mask, kv_mask_contiguous=patch_mask is not None)
            x = x + blk.wo(attn.transpose(1, 2).reshape(n, p, e))
            x = x + blk.fc1(F.gelu(blk.fc0(blk.norm1(x)), approximate="tanh"))
        x = self.final_ln(x)
        merged = self.pre_norm(x).reshape(n, p // v.spatial_merge_size**2, -1)
        return self.linear_2(gelu(self.linear_1(merged)))


# ======================================================================= experts


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [M, K], sorted by group, times their group's ``w`` [G, N, K]
    transposed: ``offs`` [G] int32 holds each group's end row. On CUDA in
    bf16 one ``torch._grouped_mm`` (no host read); elsewhere the same call
    where torch has it, else a loop over the groups (the CPU may read the
    offsets)."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    if not x.is_cuda and hasattr(torch, "_grouped_mm"):
        try:
            return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
        except (RuntimeError, NotImplementedError):
            pass
    out = x.new_empty(x.shape[0], w.shape[1])
    start = 0
    for g, end in enumerate(offs.tolist()):
        out[start:end] = x[start:end] @ w[g].t()
        start = end
    return out


def route(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor, top_k: int, scale: float,
          norm: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(expert ids [T, top_k], weights [T, top_k] f32) of rows x [T, H]: the
    sigmoid of the router's logits in f32; the top ``top_k`` of the scores
    plus ``bias`` chosen; their scores (without the bias) normalised to sum
    one and times ``scale``."""
    scores = torch.sigmoid(torch.matmul(x.float(), gate.float().t()))
    idx = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    weights = scores.gather(1, idx)
    if norm and top_k > 1:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, weights * scale


# Device tallies of the routed products while the host timers are on: per
# (routed rows a call, experts E, device), a float64 tensor [E + 3]: calls by the number
# of experts they touched (0..E), then the sums of the busiest expert's rows
# and of the mean rows per touched expert. A captured decode step adds into
# them at every replay; :func:`moe_tallies` reads them once, after the window.
_TALLIES: dict = {}


def _tally(rows: int, counts: torch.Tensor) -> None:
    experts = counts.shape[0]
    key = (rows, experts, counts.device)
    t = _TALLIES.get(key)
    if t is None:
        t = _TALLIES[key] = torch.zeros(experts + 3, dtype=torch.float64, device=counts.device)
    touched = (counts > 0).sum()
    t.index_add_(0, touched.reshape(1), torch.ones(1, dtype=torch.float64, device=counts.device))
    t[experts + 1] += counts.max().double()
    t[experts + 2] += rows / touched.clamp(min=1).double()


def moe_tallies() -> list[dict]:
    """The device tallies as host numbers, one dict per (routed rows a call,
    experts): ``routed_rows``, ``experts``, ``touched`` (calls by experts
    touched, 0..experts), ``busiest_rows`` and ``mean_rows`` (sums over the calls)."""
    out = []
    for (rows, experts, _), t in _TALLIES.items():
        host = t.cpu().tolist()
        out.append(dict(routed_rows=rows, experts=experts, touched=host[: experts + 1],
                        busiest_rows=host[experts + 1], mean_rows=host[experts + 2]))
    return out


def moe_tallies_reset() -> None:
    _TALLIES.clear()


def routed_experts(x: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor, w13: torch.Tensor,
                   w2: torch.Tensor) -> torch.Tensor:
    """sum_j weights[t, j] * expert_idx[t, j](x[t]) in f32 [T, H], each row's
    chosen experts only: the (row, choice) pairs sorted by expert, gathered,
    two grouped products (gate and up stacked, then down) over the experts'
    offsets, put back in pair order and summed per row in f32."""
    t, k = idx.shape
    experts, inter = w13.shape[0], w13.shape[1] // 2
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(experts, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    h = grouped_mm(x[order // k], w13, offs)
    y = grouped_mm(F.silu(h[:, :inter]) * h[:, inter:], w2, offs)
    if _hostprof.ENABLED:
        _hostprof.count("moe_calls")
        _hostprof.count("moe_routed_rows", t * k)
        _tally(t * k, counts)
    out = torch.empty_like(y)
    out[order] = y
    return (out.view(t, k, -1).float() * weights[..., None]).sum(dim=1)


class SwiGLU(nn.Module):
    def __init__(self, hidden: int, inter: int, dtype, device) -> None:
        super().__init__()
        self.gate = Linear(hidden, inter, False, dtype, device)
        self.up = Linear(hidden, inter, False, dtype, device)
        self.down = Linear(inter, hidden, False, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class MoE(nn.Module):
    """The router, the routed experts stacked per role ([E, 2 * I, H]: each
    expert's gate rows then its up rows; [E, H, I] down) and the shared experts."""

    def __init__(self, c: KimiVLConfig, dtype, device) -> None:
        super().__init__()
        e, h, i = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.top_k, self.scale, self.norm = c.num_experts_per_tok, c.routed_scaling_factor, c.norm_topk_prob
        self.gate = nn.Parameter(torch.empty(e, h, dtype=dtype, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(e, dtype=torch.float32, device=device), requires_grad=False)
        self.w13 = nn.Parameter(torch.empty(e, 2 * i, h, dtype=dtype, device=device), requires_grad=False)
        self.w2 = nn.Parameter(torch.empty(e, h, i, dtype=dtype, device=device), requires_grad=False)
        self.shared = SwiGLU(h, i * c.n_shared_experts, dtype, device) if c.n_shared_experts else None

    def forward(self, x: torch.Tensor, rows: int | None = None, step: bool = False) -> torch.Tensor:
        """Rows x [..., H]; the shared experts run on :func:`_row_blocks` of
        ``rows``, the router and the routed experts on the rows themselves.
        Outside a decode ``step`` the routed product is the host span ``moe_experts``."""
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        idx, weights = route(x2, self.gate, self.bias, self.top_k, self.scale, self.norm)
        with nullcontext() if step else hostprof("moe_experts"):
            y = routed_experts(x2, idx, weights, self.w13, self.w2).to(x.dtype)
        if self.shared is not None:
            y = y + _row_blocks(self.shared, rows, x2)
        return y.view(shape)


# ======================================================================= decoder


def mla_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """The expanded form over a left-padded prompt: q and k [B, H, L, 192],
    v [B, H, L, 128], causal over the valid keys of ``kv_mask`` [B, L] (a
    padding query attends to itself alone, so no row is empty). SDPA."""
    l = q.shape[2]
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    allowed = causal[None] & ((kv_mask[:, None, :] != 0) | torch.eye(l, dtype=torch.bool, device=q.device)[None])
    return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed[:, None], scale=scale)


def _scores(q: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """q [B, H, C] against keys [B, S, C] -> [B, H, S] f32 (accumulated in
    f32 and kept there, also from bf16 operands)."""
    if q.dtype == torch.float32:
        return torch.bmm(q, keys.transpose(1, 2))
    if q.is_cuda:
        return torch.bmm(q, keys.transpose(1, 2), out_dtype=torch.float32)
    return torch.bmm(q.float(), keys.float().transpose(1, 2))


def mla_decode_attention(q: torch.Tensor, cache: torch.Tensor, layer: int, kv_mask: torch.Tensor,
                         value_dim: int, scale: float, out: torch.Tensor | None = None) -> torch.Tensor:
    """The absorbed form of one decode step: q [B, H, C] (each head's query
    against the latent and the rope key, C = 576) over ``cache[layer]``
    [B, 1, S, C], the positions ``kv_mask`` [B, S] marks; the value is the
    first ``value_dim`` columns of the same entries. Scores and softmax in
    f32 -> [B, H, value_dim] in q's dtype (written into ``out`` where given)."""
    keys = cache[layer][:, 0]
    s = _scores(q, keys) * scale
    s = s.masked_fill(kv_mask[:, None, :] == 0, float("-inf"))
    p = torch.softmax(s, dim=-1).to(keys.dtype)
    return torch.bmm(p, keys[..., :value_dim], out=out)


class KimiDecoderLayer(nn.Module):
    """MLA and a dense MLP (the first ``first_k_dense_replace`` layers) or :class:`MoE`."""

    def __init__(self, c: KimiVLConfig, index: int, dtype, device) -> None:
        super().__init__()
        h, nh = c.hidden_size, c.num_heads
        self.heads = nh
        self.nope, self.rope, self.vdim, self.rank = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank
        self.scale = c.q_head_dim**-0.5
        self.input_ln = RMSNorm(h, c.rms_norm_eps, dtype, device)
        self.q = Linear(h, nh * c.q_head_dim, False, dtype, device)
        self.kv_a = Linear(h, c.cache_dim, False, dtype, device)
        self.kv_a_ln = RMSNorm(c.kv_lora_rank, 1e-6, dtype, device)
        self.kv_b = Linear(c.kv_lora_rank, nh * (c.qk_nope_head_dim + c.v_head_dim), False, dtype, device)
        self.o = Linear(nh * c.v_head_dim, h, False, dtype, device)
        self.post_ln = RMSNorm(h, c.rms_norm_eps, dtype, device)
        self.dense = index < c.first_k_dense_replace
        self.ffn = SwiGLU(h, c.intermediate_size, dtype, device) if self.dense else MoE(c, dtype, device)

    def products(self) -> tuple:
        """The dense products a decode step runs over the batch's rows."""
        ffn = self.ffn if self.dense else self.ffn.shared
        dense = () if ffn is None else (ffn.gate, ffn.up, ffn.down)
        return (self.q, self.kv_a, self.o, *dense)

    def _expansion(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``kv_b``'s weight per head: (key [H, nope, rank], value [H, vdim, rank])."""
        w = self.kv_b.weight.view(self.heads, self.nope + self.vdim, self.rank)
        return w[:, : self.nope], w[:, self.nope :]

    def mlp(self, x: torch.Tensor, rows: int | None = None, step: bool = False) -> torch.Tensor:
        """The MLP or MoE on the post-attention norm; in a decode ``step`` the
        dense products on :func:`_row_blocks` of ``rows``."""
        h = _row_blocks(self.post_ln, rows, x)
        if self.dense:
            return _row_blocks(self.ffn, rows, h)
        return self.ffn(h, rows, step)

    def _latent(self, ckv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """The cache entries [B, 1, L, 576] of ``kv_a``'s output [B, L, 576]:
        the normed latent and the rotated rope key."""
        latent = self.kv_a_ln(ckv[..., : self.rank])
        k_pe = apply_rope(_deinterleave(ckv[..., self.rank :])[:, None], cos, sin)
        return torch.cat([latent[:, None], k_pe], dim=-1)

    def prefill_attention(self, x, cos, sin, attention_mask, keep, config) -> torch.Tensor:
        b, l, _ = x.shape
        nh = self.heads
        h = self.input_ln(x)
        q = self.q(h).view(b, l, nh, self.nope + self.rope).transpose(1, 2)
        entry = self._latent(self.kv_a(h), cos, sin)  # [B, 1, L, 576]
        if keep is not None:
            keep(entry)
        kv = self.kv_b(entry[:, 0, :, : self.rank]).view(b, l, nh, self.nope + self.vdim).transpose(1, 2)
        q = torch.cat([q[..., : self.nope], apply_rope(_deinterleave(q[..., self.nope :]), cos, sin)], dim=-1)
        k = torch.cat([kv[..., : self.nope], entry[..., self.rank :].expand(b, nh, l, self.rope)], dim=-1)
        with hostprof("mla_attention"):
            attn = mla_prefill_attention(q, k, kv[..., self.nope :], attention_mask, self.scale)
        return self.o(attn.transpose(1, 2).reshape(b, l, nh * self.vdim))

    def step_query(self, i, x, cos, sin, pos, cache, rows, config) -> torch.Tensor:
        """The absorbed query [B, H, 576] of a decode step; the new position's
        latent and rope key written IN PLACE into ``cache[0][i]`` at ``pos``."""
        b = x.shape[0]

        def project(t):
            n = self.input_ln(t)
            return self.q(n), self.kv_a(n)

        q, ckv = _row_blocks(project, rows, x)
        cache[0][i].index_copy_(2, pos, self._latent(ckv, cos, sin).to(cache[0].dtype))
        q = q.view(b, 1, self.heads, self.nope + self.rope).transpose(1, 2)  # [B, H, 1, 192]
        q_pe = apply_rope(_deinterleave(q[..., self.nope :]), cos, sin)[:, :, 0]
        w_k, _ = self._expansion()
        q_lat = torch.bmm(q[:, :, 0, : self.nope].transpose(0, 1), w_k).transpose(0, 1)  # [B, H, rank]
        return torch.cat([q_lat, q_pe], dim=-1)

    def step_attention(self, i, q, cache, kv_mask, **out) -> torch.Tensor:
        """Layer ``i``'s absorbed decode attention over the latent cache."""
        return mla_decode_attention(q, cache[0], i, kv_mask, self.rank, self.scale, **out)

    def step_post(self, x, attn, rows) -> torch.Tensor:
        _, w_v = self._expansion()
        o = torch.bmm(attn.transpose(0, 1), w_v.transpose(1, 2)).transpose(0, 1)  # [B, H, vdim]
        x = _row_blocks(lambda t, a: t + self.o(a), rows, x, o.reshape(x.shape[0], 1, -1))
        return x + self.mlp(x, rows, step=True)


class KimiVLModel(nn.Module):
    """The Kimi-VL decoder, MoonViT and the projector; parameters are
    uninitialised until :func:`init_params` or :func:`load_hf_weights` fills them."""

    def __init__(self, config: KimiVLConfig, dtype=torch.bfloat16, device="cpu") -> None:
        super().__init__()
        c = self.config = config
        self.embed_tokens = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size, dtype=dtype, device=device),
                                         requires_grad=False)
        self.layers = nn.ModuleList(KimiDecoderLayer(c, i, dtype, device) for i in range(c.num_layers))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_norm_eps, dtype, device)
        self.lm_head = None if c.tie_word_embeddings else Linear(c.hidden_size, c.vocab_size, False, dtype, device)
        self.vision = MoonViT(c.vision, c.hidden_size, dtype, device)
        self.tp = None  # no tensor parallelism for this family
        self.vocab_start = None

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    @property
    def capturable(self) -> bool:
        """Whether a decode step holds no host read, so a graph can take it:
        on a CUDA device the routed product's grouped GEMM reads its offsets
        on the device in bf16 only (:func:`grouped_mm`)."""
        return self.device.type != "cuda" or self.dtype == torch.bfloat16

    def rope_inv_freq(self, device: torch.device) -> torch.Tensor:
        d = self.config.qk_rope_head_dim
        return 1.0 / (self.config.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))

    def rope_tables(self, position_ids: torch.Tensor, inv_freq: torch.Tensor | None = None):
        """cos, sin [B, L, rope/2] of the text positions ``position_ids[0]``
        ([3, B, L]: the pipeline's M-RoPE layout, its three rows equal here)."""
        if inv_freq is None:
            inv_freq = self.rope_inv_freq(position_ids.device)
        freqs = position_ids[0][..., None].float() * inv_freq
        return torch.cos(freqs), torch.sin(freqs)

    # The latent cache is no K and V: the int8 KV cache does not apply (``kv_int8_cache`` refuses it).
    cache_quantizes = False

    def cache_shapes(self, batch: int, cache_len: int) -> tuple:
        """One latent tensor [L, B, 1, S, 576]: one shared key head."""
        c = self.config
        return ((c.num_layers, batch, 1, cache_len, c.cache_dim),)

    def hf_tensor(self, state, name: str) -> torch.Tensor:
        """The released checkpoint's tensor of parameter ``name``; a MoE
        layer's stacked experts are stacked from its per-expert tensors."""
        parts = name.split(".")
        if parts[0] == "vision":
            return _vision_tensor(state, parts[1:])
        if parts[0] == "layers":
            return _layer_tensor(state, int(parts[1]), parts[2:], self.config.n_routed_experts)
        hf = {"embed_tokens": "model.embed_tokens.weight", "final_norm": "model.norm.weight",
              "lm_head": "lm_head.weight"}[parts[0]]
        return find_tensor(state, hf, HF_TEXT_PREFIXES)


HF_TEXT_PREFIXES = ("language_model.", "")
HF_VISION_PREFIXES = ("vision_tower.", "")
_ATTN_ROLES = {"q": "q_proj", "kv_a": "kv_a_proj_with_mqa", "kv_a_ln": "kv_a_layernorm", "kv_b": "kv_b_proj",
               "o": "o_proj"}
_BLOCK_ROLES = {"norm0": "norm0", "norm1": "norm1", "wqkv": "wqkv", "wo": "wo", "fc0": "mlp.fc0", "fc1": "mlp.fc1"}


def _layer_tensor(state, i: int, parts: list[str], experts: int) -> torch.Tensor:
    def get(name):
        return find_tensor(state, f"model.layers.{i}.{name}", HF_TEXT_PREFIXES)

    role = parts[0]
    if role in ("input_ln", "post_ln"):
        return get(f"{'input_layernorm' if role == 'input_ln' else 'post_attention_layernorm'}.weight")
    if role in _ATTN_ROLES:
        return get(f"self_attn.{_ATTN_ROLES[role]}.weight")
    # ffn
    if parts[1] in ("gate", "up", "down") and len(parts) == 3:  # the dense MLP
        return get(f"mlp.{parts[1]}_proj.weight")
    if parts[1] == "gate":
        return get("mlp.gate.weight")
    if parts[1] == "bias":
        return get("mlp.gate.e_score_correction_bias")
    if parts[1] == "shared":
        return get(f"mlp.shared_experts.{parts[2]}_proj.weight")
    if parts[1] == "w13":
        return stack_experts(state, [[f"model.layers.{i}.mlp.experts.{e}.{r}_proj.weight" for r in ("gate", "up")]
                                     for e in range(experts)], HF_TEXT_PREFIXES)
    if parts[1] == "w2":
        return stack_experts(state, [[f"model.layers.{i}.mlp.experts.{e}.down_proj.weight"] for e in range(experts)],
                             HF_TEXT_PREFIXES)
    raise KeyError(f"layers.{i}.{'.'.join(parts)}")


def _vision_tensor(state, parts: list[str]) -> torch.Tensor:
    def get(name):
        return find_tensor(state, name, HF_VISION_PREFIXES)

    proj = ("multi_modal_projector.", "")
    if parts[0] == "patch_embed":
        w = get(f"patch_embed.proj.{parts[1]}")
        return w.reshape(w.shape[0], -1) if parts[1] == "weight" else w
    if parts[0] == "pos_emb":
        return get("patch_embed.pos_emb.weight")
    if parts[0] == "blocks":
        return get(f"encoder.blocks.{parts[1]}.{_BLOCK_ROLES[parts[2]]}.{parts[3]}")
    if parts[0] == "final_ln":
        return get(f"encoder.final_layernorm.{parts[1]}")
    return find_tensor(state, f"{parts[0]}.{parts[1]}", proj)


def stack_experts(state, names: list[list[str]], prefixes: tuple[str, ...]) -> torch.Tensor:
    """[E, sum of out, in]: expert ``e``'s tensors ``names[e]`` (each [out, in]),
    concatenated along the output axis, stacked over the experts. Made on the
    tensors' device, in their dtype, one expert at a time."""
    first = find_tensor(state, names[0][0], prefixes)
    out_rows = [find_tensor(state, n, prefixes).shape[0] for n in names[0]]
    stacked = torch.empty(len(names), sum(out_rows), first.shape[1], dtype=first.dtype, device=first.device)
    for e, group in enumerate(names):
        row = 0
        for name, rows in zip(group, out_rows):
            stacked[e, row : row + rows] = find_tensor(state, name, prefixes)
            row += rows
    return stacked


@torch.no_grad()
def init_params(model: KimiVLModel, generator: torch.Generator) -> KimiVLModel:
    """Random-init in place on the generator's device (a model built on
    ``meta`` comes there one module at a time): every linear weight, the
    embedding, the router, the stacked experts and the position grid
    ~ N(0, 1) * 0.02, biases and the router's choice bias zero, norm scales one."""

    def fill(name, t, module):
        if isinstance(module, (LayerNorm, RMSNorm)):
            t.fill_(1.0) if name.endswith("weight") else t.zero_()
        elif name.endswith(".bias") and isinstance(module, (Linear, MoE)):
            t.zero_()
        else:
            t.normal_(0.0, 0.02, generator=generator)

    return materialize_on_device(model, generator.device, fill)


def load_hf_weights(model: KimiVLModel, state, device=None) -> KimiVLModel:
    """Fill the model from a Kimi-VL checkpoint's tensors (released names,
    :meth:`KimiVLModel.hf_tensor`), cast to each parameter's dtype, one
    module at a time (:func:`~lmms_owc_tpu_torch.nn.loader.load_hf_tensors`)."""
    return load_hf_tensors(model, state, device)


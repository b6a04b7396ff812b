"""Megatron tensor parallelism for the port's decoder and the Qwen2-VL tower.

Counterpart of :mod:`lmms_owc_tpu.parallel.sharding`. The JAX rules
(``QWEN_DECODER_RULES``) are GSPMD layouts: XLA keeps the semantics whatever
the split and inserts the all-reduces. Here each rank keeps its slice of a
weight and the modules get the semantics right themselves:

  - column-parallel projections (q, k, v, gate, up, the tower's qkv and fc1,
    the merger's fc1) keep a slice of their output rows. q, k and v split by
    heads, each role on its own: the tower's fused qkv hands each rank its
    heads of q, of k and of v. Where the model group is larger than the KV
    head count, each rank keeps the KV heads of its query groups (the k and v
    projections are then replicated across the ranks that share them);
  - row-parallel projections (o, down, the tower's proj and fc2, the
    merger's fc2) keep a slice of their input columns inside a
    :class:`~lmms_owc_tpu_torch.nn.layers.RowParallel`, which sums the model
    group's partial products (W8A8: the per-token amax and the int32 partials
    are reduced, so the product is the unsharded one). int4's halves layout
    pairs input column ``i`` with ``i + in/2``, so a row-parallel int4 slice
    is unpacked and packed again at its own width;
  - the vocabulary: the embedding keeps its rows (a masked lookup plus an
    all-reduce) and the LM head its output rows (every rank then holds the
    full logits), see :func:`~lmms_owc_tpu_torch.nn.qwen2_vl.embed_tokens`.

Quantized weights follow the JAX rules: int8 ``q`` like the float weight, the
int8 scale on the output axis (replicated for a row-parallel product), int4
``q4`` and its group scales with the weight. As in JAX a width that the model
group does not divide replicates, here per block (the attention, the MLP, the
vocabulary, the tower's attention, its MLP, the merger), because a block
whose row-parallel half cannot split must keep its column-parallel half whole.
The Qwen2.5-VL tower stays replicated. A model that is drawn or read from a
checkpoint is sharded as a hook of the module walk, one module at a time
(:class:`Sharder`), so a rank never holds the whole model; one filled from a
JAX parameter tree is sharded in place once built (:func:`shard_model`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch import nn

from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear, Linear, RowParallel
from lmms_owc_tpu_torch.ops.quant import pack_int4, unpack_int4
from lmms_owc_tpu_torch.parallel.mesh import ModelGroup

__all__ = ["QWEN_DECODER_RULES", "ShardPlan", "Sharder", "make_plan", "shard_model"]

INT4_GROUP = 128  # the quantizer's group (``quantize_params_int4``)

# (pattern over a module path from the decoder's root, role, block). Roles:
# "q_heads" / "kv_heads" / "qkv_heads" split output rows by heads, "column"
# and "vocab" by contiguous output rows, "row" by contiguous input columns.
QWEN_DECODER_RULES: list[tuple[str, str, str]] = [
    (r"^layers\.\d+\.q$", "q_heads", "attn"),
    (r"^layers\.\d+\.[kv]$", "kv_heads", "attn"),
    (r"^layers\.\d+\.o$", "row", "attn"),
    (r"^layers\.\d+\.(gate|up)$", "column", "mlp"),
    (r"^layers\.\d+\.down$", "row", "mlp"),
    (r"^embed_tokens$", "vocab", "vocab"),
    (r"^lm_head$", "vocab", "vocab"),
    (r"^vision\.blocks\.\d+\.qkv$", "qkv_heads", "tower_attn"),
    (r"^vision\.blocks\.\d+\.proj$", "row", "tower_attn"),
    (r"^vision\.blocks\.\d+\.fc1$", "column", "tower_mlp"),
    (r"^vision\.blocks\.\d+\.fc2$", "row", "tower_mlp"),
    (r"^vision\.merger\.fc1$", "column", "merger"),
    (r"^vision\.merger\.fc2$", "row", "merger"),
]


def _rule(path: str) -> tuple[str, str] | None:
    for pattern, role, block in QWEN_DECODER_RULES:
        if re.search(pattern, path):
            return role, block
    return None


def _int4_groups(d_in: int) -> int:
    return d_in // INT4_GROUP if d_in % INT4_GROUP == 0 else 1


def _row_splits(d_in: int, size: int, int4: bool) -> bool:
    """Whether a row-parallel product of input width ``d_in`` splits over ``size``
    ranks: an int4 slice must have an even width and whole groups (or the one
    group of a narrow matrix)."""
    if d_in % size:
        return False
    groups = _int4_groups(d_in)
    return not int4 or ((d_in // size) % 2 == 0 and (groups % size == 0 or groups == 1))


@dataclass(frozen=True)
class ShardPlan:
    """Which blocks shard over ``size`` ranks, and rank ``rank``'s slices:
    query heads, KV heads and tower heads as [start, stop) and its vocabulary rows."""

    size: int
    rank: int
    blocks: frozenset
    heads: tuple[int, int]
    kv_heads: tuple[int, int]
    tower_heads: tuple[int, int] | None
    vocab: tuple[int, int]


def make_plan(decoder: nn.Module, size: int, rank: int = 0, int4: bool = False) -> ShardPlan:
    """The plan of a :class:`~lmms_owc_tpu_torch.nn.qwen2_vl.Qwen2VLModel` (or a
    text-only decoder) over ``size`` ranks; ``int4`` checks the row-parallel
    slices against int4's groups."""
    from lmms_owc_tpu_torch.nn.qwen2_vl import VisionTower

    c = decoder.config
    nh, kvh, hd = c.num_heads, c.num_kv_heads, c.head_dim
    blocks = set()
    if nh % size == 0 and (kvh % size == 0 or size % kvh == 0) and _row_splits(nh * hd, size, int4):
        blocks.add("attn")
    if _row_splits(c.intermediate_size, size, int4):
        blocks.add("mlp")
    if c.vocab_size % size == 0:
        blocks.add("vocab")
    tower_heads = None
    if isinstance(decoder.vision, VisionTower):
        v = decoder.vision.config
        if v.num_heads % size == 0 and _row_splits(v.embed_dim, size, int4):
            blocks.add("tower_attn")
            per = v.num_heads // size
            tower_heads = (rank * per, (rank + 1) * per)
        if _row_splits(v.mlp_hidden, size, int4):
            blocks.add("tower_mlp")
        if _row_splits(v.embed_dim * v.spatial_merge_size**2, size, int4):
            blocks.add("merger")
    per, group = nh // size, nh // kvh
    vocab = c.vocab_size // size
    return ShardPlan(
        size=size, rank=rank, blocks=frozenset(blocks),
        heads=(rank * per, (rank + 1) * per),
        kv_heads=(rank * per // group, ((rank + 1) * per - 1) // group + 1),
        tower_heads=tower_heads, vocab=(rank * vocab, (rank + 1) * vocab),
    )


def _dims(lin: nn.Module) -> tuple[int, int]:
    """(out, in) of a :class:`Linear`, :class:`Int8Linear` or :class:`Int4Linear`."""
    if isinstance(lin, Int4Linear):
        return lin.q4.shape[0], 2 * lin.q4.shape[1]
    return tuple((lin.q if isinstance(lin, Int8Linear) else lin.weight).shape)


def _leaves(lin: nn.Module) -> tuple[str, ...]:
    return ("weight",) if isinstance(lin, Linear) else (("q", "scale") if isinstance(lin, Int8Linear)
                                                         else ("q4", "scale"))


def _linear_like(lin: nn.Module, d_in: int, d_out: int, bias: bool, group: int | None = None) -> nn.Module:
    """An empty module of ``lin``'s kind at [d_out, d_in] on its device."""
    first = getattr(lin, _leaves(lin)[0])
    if isinstance(lin, Linear):
        return Linear(d_in, d_out, bias, first.dtype, first.device)
    dtype = lin.bias.dtype if lin.bias is not None else torch.float32
    if isinstance(lin, Int4Linear):
        return Int4Linear(d_in, d_out, bias, dtype, first.device, group=group or d_in // lin.scale.shape[1])
    return Int8Linear(d_in, d_out, bias, dtype, first.device)


@torch.no_grad()
def _take_rows(lin: nn.Module, rows) -> nn.Module:
    """Column-parallel slice: the output rows ``rows`` (a slice or an index tensor)."""
    d_out = rows.numel() if torch.is_tensor(rows) else rows.stop - rows.start
    new = _linear_like(lin, _dims(lin)[1], d_out, lin.bias is not None)
    for name in _leaves(lin):
        getattr(new, name).copy_(getattr(lin, name)[rows])
    if lin.bias is not None:
        new.bias.copy_(lin.bias[rows])
    new.tp_sharded = True
    return new


@torch.no_grad()
def _take_cols(lin: nn.Module, plan: ShardPlan, group: ModelGroup) -> RowParallel:
    """Row-parallel slice: this rank's input columns, in a :class:`RowParallel`
    that holds the full bias."""
    d_out, d_in = _dims(lin)
    k = d_in // plan.size
    cols = slice(plan.rank * k, (plan.rank + 1) * k)
    if isinstance(lin, Int4Linear):
        groups = lin.scale.shape[1]
        inner = _linear_like(lin, k, d_out, False, group=k if groups == 1 else d_in // groups)
        inner.q4.copy_(pack_int4(unpack_int4({"q4": lin.q4, "scale": lin.scale})[:, cols]))
        per = groups // plan.size
        inner.scale.copy_(lin.scale if groups == 1 else lin.scale[:, plan.rank * per : (plan.rank + 1) * per])
    else:
        inner = _linear_like(lin, k, d_out, False)
        if isinstance(lin, Int8Linear):
            inner.q.copy_(lin.q[:, cols])
            inner.scale.copy_(lin.scale)
        else:
            inner.weight.copy_(lin.weight[:, cols])
    inner.tp_sharded = True
    out = RowParallel(inner, None if lin.bias is None else lin.bias.detach().clone(), group)
    out.tp_sharded = True
    return out


class Sharder:
    """Tensor parallelism over ``group`` for ``decoder`` (a Qwen2-VL model or
    a text decoder), as a hook of the module walks: ``sharder(name, module)``
    returns the module, or the slice of it that replaces it (set on its
    parent). ``prefix`` is the decoder's path in the walked model (``"text."``
    for LLaVA's and InternVL2's). Building it sets the decoder's head counts
    and model group; the embedding is sliced when the walk reaches the
    decoder itself."""

    def __init__(self, decoder: nn.Module, group: ModelGroup, int4: bool = False, prefix: str = "") -> None:
        self.decoder, self.group, self.prefix = decoder, group, prefix
        self.plan = plan = make_plan(decoder, group.size, group.rank, int4)
        decoder.tp = group
        if "attn" in plan.blocks:
            for layer in decoder.layers:
                layer.heads = plan.heads[1] - plan.heads[0]
                layer.kv_heads = plan.kv_heads[1] - plan.kv_heads[0]
        if plan.tower_heads is not None:
            decoder.vision.heads = plan.tower_heads[1] - plan.tower_heads[0]

    def __call__(self, name: str, module: nn.Module) -> nn.Module:
        if module is self.decoder:
            if "vocab" in self.plan.blocks and self.decoder.vocab_start is None:
                self._shard_embedding()
            return module
        if not name.startswith(self.prefix) or getattr(module, "tp_sharded", False):
            return module
        path = name[len(self.prefix):]
        rule = _rule(path)
        if rule is None or rule[1] not in self.plan.blocks:
            return module
        new = self._shard(rule[0], module)
        parent, _, leaf = path.rpartition(".")
        setattr(self.decoder.get_submodule(parent) if parent else self.decoder, leaf, new)
        return new

    def _shard(self, role: str, lin: nn.Module) -> nn.Module:
        plan = self.plan
        if role == "row":
            return _take_cols(lin, plan, self.group)
        hd = self.decoder.config.head_dim
        if role == "q_heads":
            return _take_rows(lin, slice(plan.heads[0] * hd, plan.heads[1] * hd))
        if role == "kv_heads":
            return _take_rows(lin, slice(plan.kv_heads[0] * hd, plan.kv_heads[1] * hd))
        if role == "vocab":
            return _take_rows(lin, slice(*plan.vocab))
        if role == "qkv_heads":
            v = self.decoder.vision.config
            own = torch.arange(plan.tower_heads[0] * v.head_dim, plan.tower_heads[1] * v.head_dim)
            rows = torch.cat([own + i * v.embed_dim for i in range(3)])
            return _take_rows(lin, rows.to(getattr(lin, _leaves(lin)[0]).device))
        per = _dims(lin)[0] // plan.size
        return _take_rows(lin, slice(plan.rank * per, (plan.rank + 1) * per))

    @torch.no_grad()
    def _shard_embedding(self) -> None:
        d = self.decoder
        start, stop = self.plan.vocab
        d.embed_tokens = nn.Parameter(d.embed_tokens[start:stop].clone(), requires_grad=False)
        d.vocab_start = start


def shard_model(decoder: nn.Module, group: ModelGroup) -> nn.Module:
    """Shard a built decoder (a Qwen2-VL model or a text decoder) in place,
    module by module, each full tensor dropped as its slice replaces it."""
    int4 = any(isinstance(m, Int4Linear) for m in decoder.modules())
    sharder = Sharder(decoder, group, int4)
    for name, module in decoder.named_modules(remove_duplicate=False):  # holds no passed module
        sharder(name, module)
    return decoder

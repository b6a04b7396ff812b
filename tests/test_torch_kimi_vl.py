"""Kimi-VL on the port against its plain reference (``owcbench/reference/kimi_vl.py``).

At a tiny size with seeded random weights in f32 on the CPU: the prefill's
logits and decode steps through a pooled latent cache against the
reference's full forward; the absorbed MLA decode against the expanded form
over the same cache; the router (the bias chooses, it does not weight; the
chosen scores normalised and scaled; the shared experts added); MoonViT on
two images packed against each alone; the decode step under the stand-in
for ``StepGraphs`` with no host read. A ``card`` test holds replayed MoE
steps to direct ones bit for bit on an NVIDIA GPU
(``python -m pytest --noconftest tests/test_torch_kimi_vl.py``; this file
imports no JAX).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.models.kimi_vl import PRESET_CONFIGS
from lmms_owc_tpu_torch.nn import kimi_vl as kvl
from lmms_owc_tpu_torch.nn import qwen2_vl as tq
from lmms_owc_tpu_torch.utils import _hostprof

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from owcbench import weights as bench_weights  # noqa: E402
from owcbench.reference import kimi_vl as ref  # noqa: E402
from owcbench.reference.qwen2_vl import Weights  # noqa: E402

TINY = json.loads((REPO / "owcbench" / "tests" / "data" / "configs" / "kimi-vl-tiny.json").read_text())
F32 = {"weights": "bf16", "activations": None, "kv": None}
# f32 products in another order (grouped, absorbed, batched) against the
# reference's: a few ulps of the logits' size.
LOGIT_TOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    no_tf32()
    _hostprof.counters_reset()
    kvl.moe_tallies_reset()
    monkeypatch.setattr(tq._pool, "warm", set(), raising=False)
    yield
    _hostprof.counters_reset()
    kvl.moe_tallies_reset()


def _hf():
    return TINY["hf_config"]


def _state(seed=3, device="cpu", dtype=torch.float32):
    return bench_weights.draw(ref.hf_layout(_hf()), seed, dtype, device)


def _model(state, device="cpu", dtype=torch.float32) -> kvl.KimiVLModel:
    hf = _hf()
    config = kvl.KimiVLConfig.from_hf_dict({"text_config": {k: v for k, v in hf.items() if k != "vision_config"},
                                            "vision_config": hf["vision_config"]})
    model = kvl.KimiVLModel(config, dtype, "meta")
    return kvl.load_hf_weights(model, state, device)


def _left_padded(embeds: list[torch.Tensor], bucket: int):
    """[B, bucket, H] left-padded embeddings, mask and [3, B, L] text positions."""
    b, h = len(embeds), embeds[0].shape[1]
    x = torch.zeros(b, bucket, h)
    mask = torch.zeros(b, bucket, dtype=torch.int32)
    for r, e in enumerate(embeds):
        x[r, bucket - e.shape[0]:] = e
        mask[r, bucket - e.shape[0]:] = 1
    positions = (torch.cumsum(mask, 1) - 1).clamp(min=0)[None].expand(3, b, bucket).contiguous()
    return x, mask, positions


def test_prefill_and_pooled_decode_match_the_reference():
    """Two prompts of different lengths prefilled apart (as two chunks of a
    pool), their latent caches written into one pool front-padded to the
    longer bucket, then 4 greedy decode steps: every step's logits match the
    reference's full forward over the prompt and the tokens so far."""
    state = _state()
    model = _model(state)
    a = ref.arch(_hf())
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randn(n, a["hidden"], generator=g) for n in (11, 6)]
    buckets = [16, 8]
    steps = 4
    cache_len = 16 + steps + 4
    pool = (torch.zeros(model.cache_shapes(2, cache_len)[0]),)
    kv_mask = torch.zeros(2, cache_len, dtype=torch.int32)
    first = []
    for row, (emb, bucket) in enumerate(zip(prompts, buckets)):
        x, mask, positions = _left_padded([emb], bucket)
        logits, latent = tq.prefill_logits(model, x, positions, mask)
        front = 16 - bucket
        tq.write_pool_rows(pool[0], latent, row, front)
        kv_mask[row, front:front + bucket] = mask[0]
        first.append(logits)
    logits = torch.cat(first)
    tokens = [logits.argmax(-1)]
    seen = [logits]
    next_pos = torch.tensor([p.shape[0] for p in prompts])
    for s in range(steps):
        pos = (next_pos + s)[None, :, None].expand(3, 2, 1)
        kv_mask[:, 16 + s] = 1
        logits = tq.decode_step(model, tokens[-1], pos, pool, 16 + s, kv_mask)
        seen.append(logits.clone())
        tokens.append(logits.argmax(-1))
    table = state["language_model.model.embed_tokens.weight"].float()
    for row, emb in enumerate(prompts):
        served = torch.stack([t[row] for t in tokens[:-1]])
        xs = [torch.cat([emb, table[served]])]
        want = ref.decoder_logits(a, Weights(state, F32), xs, [emb.shape[0]])[0]
        got = torch.stack([s[row] for s in seen])
        assert got.shape == want.shape
        scale = want.abs().max()
        assert (got - want).abs().max() <= LOGIT_TOL * scale, (row, (got - want).abs().max(), scale)


def test_absorbed_decode_equals_the_expanded_form():
    """One layer's decode attention in the absorbed form (a 576-wide query
    against the latent cache, the value expansion after) equals the expanded
    form (each head's key and value from the latent) over the same cache."""
    model = _model(_state(seed=5))
    layer = model.layers[1]
    c = model.config
    g = torch.Generator().manual_seed(1)
    b, s = 3, 9
    cache = (torch.randn(c.num_layers, b, 1, s, c.cache_dim, generator=g),)
    kv_mask = (torch.arange(s)[None] >= torch.tensor([[0], [3], [5]])).to(torch.int32)
    x = torch.randn(b, 1, c.hidden_size, generator=g)
    pos_t = torch.full((1,), s - 1, dtype=torch.long)
    positions = torch.full((3, b, 1), 7)
    cos, sin = model.rope_tables(positions)
    q_abs = layer.step_query(1, x, cos, sin, pos_t, cache, None, c)
    absorbed = layer.step_post(torch.zeros_like(x), layer.step_attention(1, q_abs, cache, kv_mask), None)
    # The expanded form over the same cache entries (the new one written by step_query).
    entries = cache[0][1, :, 0]  # [B, S, 576]
    kv = layer.kv_b(entries[..., : c.kv_lora_rank]).view(b, s, c.num_heads, -1).transpose(1, 2)
    k = torch.cat([kv[..., : c.qk_nope_head_dim],
                   entries[:, None, :, c.kv_lora_rank:].expand(b, c.num_heads, s, c.qk_rope_head_dim)], -1)
    h = layer.input_ln(x)
    q = layer.q(h).view(b, 1, c.num_heads, -1).transpose(1, 2)
    q = torch.cat([q[..., : c.qk_nope_head_dim],
                   tq.apply_rope(kvl._deinterleave(q[..., c.qk_nope_head_dim:]), cos, sin)], -1)
    scores = (q @ k.transpose(-1, -2)) * c.q_head_dim**-0.5
    scores = scores.masked_fill(kv_mask[:, None, None, :] == 0, float("-inf"))
    o = (torch.softmax(scores, -1) @ kv[..., c.qk_nope_head_dim:]).transpose(1, 2).reshape(b, 1, -1)
    expanded = layer.o(o)
    expanded = expanded + layer.mlp(expanded)
    assert torch.allclose(absorbed, expanded, atol=1e-5, rtol=1e-5), (absorbed - expanded).abs().max()


def test_routing_bias_chooses_and_does_not_weight():
    """The correction bias picks the experts; the weights are the chosen
    sigmoid scores without it, normalised to one and times the scaling
    factor; the shared experts are added to the routed sum."""
    torch.manual_seed(0)
    h, e, k = 16, 8, 3
    x = torch.randn(5, h)
    gate = torch.randn(e, h)
    scores = torch.sigmoid(x @ gate.t())
    plain = torch.topk(scores, k, dim=-1).indices
    bias = torch.zeros(e)
    bias[plain[:, 0]] = -10.0  # each row's favourite expert can no longer be chosen
    idx, w = kvl.route(x, gate, bias, k, 2.446)
    assert not (idx == plain[:, :1]).any()
    assert torch.equal(idx, torch.topk(scores + bias, k, dim=-1).indices)
    want = scores.gather(1, idx)
    assert torch.allclose(w, want / want.sum(-1, keepdim=True) * 2.446, atol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((5,), 2.446), atol=1e-5)
    # The layer: routed experts by hand plus the shared expert, against MoE.forward.
    c = kvl.KimiVLConfig(hidden_size=h, n_routed_experts=e, num_experts_per_tok=k, moe_intermediate_size=4,
                         n_shared_experts=1)
    moe = kvl.MoE(c, torch.float32, "cpu")
    with torch.no_grad():
        for p in moe.parameters():
            p.normal_(0, 0.5)
        moe.gate.copy_(gate)
        moe.bias.copy_(bias)
    routed = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(k):
            ex = int(idx[t, j])
            g_, u_ = moe.w13[ex, :4] @ x[t], moe.w13[ex, 4:] @ x[t]
            routed[t] += w[t, j] * (moe.w2[ex] @ (torch.nn.functional.silu(g_) * u_))
    shared = moe.shared(x)
    assert torch.allclose(moe(x), routed + shared, atol=1e-5)
    assert not torch.allclose(moe(x), routed, atol=1e-3)


def test_routed_product_touches_only_the_chosen_experts(monkeypatch):
    """The grouped product's groups are the chosen (row, expert) pairs:
    as many rows as rows x experts per token, each expert's group its count."""
    calls = []
    real = kvl.grouped_mm

    def spy(x, w, offs):
        calls.append((x.shape[0], offs.clone()))
        return real(x, w, offs)

    monkeypatch.setattr(kvl, "grouped_mm", spy)
    torch.manual_seed(2)
    x, idx = torch.randn(7, 16), torch.stack([torch.randperm(8)[:3] for _ in range(7)])
    kvl.routed_experts(x, idx, torch.ones(7, 3), torch.randn(8, 8, 16), torch.randn(8, 16, 4))
    counts = torch.bincount(idx.reshape(-1), minlength=8)
    assert [c[0] for c in calls] == [21, 21]
    assert all(torch.equal(c[1], torch.cumsum(counts, 0).int()) for c in calls)


def test_moonvit_packs_two_images_as_each_alone():
    """Two images of different grids in one padded batch (a prefix key mask)
    give each image's merged embeddings as the tower on it alone, and the
    tower matches the reference's."""
    state = _state(seed=7)
    model = _model(state)
    v = model.config.vision
    a = ref.arch(_hf())
    g = torch.Generator().manual_seed(4)
    grids = [(4, 6), (8, 4)]
    bucket = 32

    def inputs(grid, pad_to):
        p = grid[0] * grid[1]
        patches = torch.randn(p, v.patch_dim, generator=g)
        pos = kvl.position_embedding(model.vision.pos_emb, grid, v.spatial_merge_size)
        ang = torch.from_numpy(kvl.vision_rope_angles(grid, v))
        pad = (0, 0, 0, pad_to - p)
        return [torch.nn.functional.pad(t, pad) for t in (patches, pos, ang)], p

    (one, p1), (two, p2) = inputs(grids[0], bucket), inputs(grids[1], bucket)
    mask = (torch.arange(bucket)[None] < torch.tensor([[p1], [p2]])).to(torch.int32)
    packed = model.vision(*(torch.stack([a_, b_]) for a_, b_ in zip(one, two)), mask)
    for row, (ins, p) in enumerate(((one, p1), (two, p2))):
        alone = model.vision(*(t[None, :p] for t in ins), None)[0]
        assert torch.allclose(packed[row, : p // 4], alone, atol=1e-5), (packed[row, : p // 4] - alone).abs().max()
    # Against the reference: the reference takes row-major patches, the port merge-window order.
    for (ins, p), grid, out in zip(((one, p1), (two, p2)), grids, packed):
        h, w = grid
        merged_order = ins[0][:p].reshape(h // 2, w // 2, 2, 2, -1).permute(0, 2, 1, 3, 4).reshape(p, -1)
        want = ref.towers(a, Weights(state, F32), [(merged_order, (1, h, w))])[0]
        assert torch.allclose(out[: p // 4], want, atol=1e-4, rtol=1e-4), (out[: p // 4] - want).abs().max()


@pytest.mark.parametrize("grid", [(8, 8), (4, 6), (12, 10)])
def test_position_grid_and_rope_angles_follow_the_merge_order(grid):
    """The port's position embeddings and rope angles, put back in row-major
    order, are the reference's (torch's bicubic of the grid; complex rope on
    interleaved pairs), for a grid at, below and above the learned one."""
    state = _state(seed=8)
    model = _model(state)
    v = model.config.vision
    h, w = grid
    to_rows = lambda t: t.reshape(h // 2, w // 2, 2, 2, -1).permute(0, 2, 1, 3, 4).reshape(h * w, -1)  # noqa: E731
    table = state["vision_tower.patch_embed.pos_emb.weight"].float()
    want = table if grid == (8, 8) else torch.nn.functional.interpolate(
        table.permute(2, 0, 1)[None], size=grid, mode="bicubic", align_corners=False)[0].permute(1, 2, 0)
    got = to_rows(kvl.position_embedding(model.vision.pos_emb, grid, 2))
    assert torch.allclose(got, want.reshape(h * w, -1), atol=1e-6, rtol=1e-5)
    angles = to_rows(torch.from_numpy(kvl.vision_rope_angles(grid, v)))
    cis = ref.rope_2d(ref.arch(_hf()), h, w, "cpu")
    assert torch.allclose(torch.polar(torch.ones_like(angles), angles), cis, atol=1e-5)


def test_int8_kv_cache_is_refused_for_the_latent_cache(monkeypatch):
    """The model says whether its cache quantizes: with ``LMMS_OWC_KV_INT8``
    on, a Qwen2 cache goes int8 and Kimi-VL's latent cache raises (never a
    silent bf16 cache); off, neither quantizes."""
    model = _model(_state())
    qwen = tq.Qwen2VLModel(tq.Qwen2VLConfig(), torch.float32, "meta")
    monkeypatch.setenv("LMMS_OWC_KV_INT8", "force")
    assert tq.kv_int8_cache(qwen, "cpu") is True
    with pytest.raises(ValueError, match="LMMS_OWC_KV_INT8"):
        tq.kv_int8_cache(model, "cpu")
    g = torch.Generator().manual_seed(1)
    embeds = torch.randn(2, 4, model.config.hidden_size, generator=g)
    mask = torch.ones(2, 4, dtype=torch.int32)
    positions = torch.arange(4)[None, None].expand(3, 2, 4).contiguous()
    with pytest.raises(ValueError, match="LMMS_OWC_KV_INT8"):
        tq.greedy_generate(model, embeds, positions, mask, torch.full((2,), 4), 2, 8, torch.tensor([-1]))
    monkeypatch.setenv("LMMS_OWC_KV_INT8", "")
    assert tq.kv_int8_cache(qwen, "cpu") is False and tq.kv_int8_cache(model, "cpu") is False


HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "nonzero", "numpy")


def _refuse(name):
    def refuse(*args, **kw):
        raise AssertionError(f"host read ({name}) inside a decode step")

    return refuse


def test_decode_step_replays_under_the_graph_stand_in_without_host_reads(monkeypatch):
    """A Kimi-VL pool decoded through ``decode_pool`` with the CPU stand-in
    for ``StepGraphs``: the step's L + 1 segments are captured once and
    replayed, with the MLA decode attention launched once a layer between
    them, the tokens and logits equal the direct steps', no step reads a
    tensor on the host, and the MoE counters of the capture come back at
    each replay."""
    from tests.test_torch_decode_graphs import RecordingGraphs

    state = _state(seed=9)
    model = _model(state)
    g = torch.Generator().manual_seed(5)
    rows, prompt, new = 5, 8, 6
    embeds = torch.randn(rows, prompt, model.config.hidden_size, generator=g)
    pads = torch.tensor([0, 2, 3, 1, 4])
    mask = (torch.arange(prompt)[None] >= pads[:, None]).to(torch.int32)
    positions = (torch.cumsum(mask, 1) - 1).clamp(min=0)[None].expand(3, rows, prompt).contiguous()
    logits, cache = tq.prefill(model, embeds, positions, mask, prompt + new)

    def decode(graphs: bool):
        kv_mask = torch.zeros(rows, prompt + new, dtype=torch.int32)
        kv_mask[:, :prompt] = mask
        seen = []
        real = tq.decode_step

        def step(*args):
            with monkeypatch.context() as m:
                for name in HOST_READS if graphs else ():
                    m.setattr(torch.Tensor, name, _refuse(name))
                out = real(*args)
            seen.append(out.clone())
            return out

        attention_calls = []
        real_attention = kvl.mla_decode_attention

        def attention(*args, **kw):
            attention_calls.append(args[2])
            return real_attention(*args, **kw)

        with monkeypatch.context() as m:
            m.setattr(tq, "decode_step", step)
            m.setattr(kvl, "mla_decode_attention", attention)
            if graphs:
                RecordingGraphs.made = []
                m.setattr(tq, "StepGraphs", RecordingGraphs)
            m.setattr(_hostprof, "ENABLED", True)
            _hostprof.counters_reset()
            tokens = tq.decode_pool(model, tuple(t.clone() for t in cache), logits, kv_mask,
                                    mask.sum(1).long(), new, prompt, torch.tensor([-1]))
            counters = dict(_hostprof.counters)
        return tokens, seen, counters, attention_calls

    direct = decode(False)
    graphed = decode(True)
    assert torch.equal(graphed[0], direct[0])
    assert all(torch.equal(a_, b_) for a_, b_ in zip(graphed[1], direct[1]))
    (made,) = RecordingGraphs.made
    # Step 1 warms up directly, step 2 captures (and replays at once), steps 3-5 replay.
    segments = model.config.num_layers + 1
    assert len(made.captures) == segments and made.replays == (new - 2) * segments
    moe_layers = model.config.num_layers - model.config.first_k_dense_replace
    for counters in (direct[2], graphed[2]):
        assert counters["moe_calls"] == (new - 1) * moe_layers
        assert counters["moe_routed_rows"] == (new - 1) * moe_layers * rows * model.config.num_experts_per_tok
    assert graphed[2]["decode_graph_steps"] == new - 3
    # The configured decode attention entry runs once a layer a step, replayed steps too.
    layers = list(range(model.config.num_layers))
    assert direct[3] == graphed[3] == layers * (new - 1)


def test_moe_tallies_count_every_call_and_the_busiest_expert():
    """The device tallies: per routed-row count, calls by experts touched, the
    busiest expert's rows and the mean rows per touched expert, summed."""
    torch.manual_seed(3)
    w13, w2 = torch.randn(8, 8, 16), torch.randn(8, 16, 4)
    with_counts = []
    for idx in (torch.tensor([[0, 1], [0, 2], [0, 1]]), torch.tensor([[3, 4], [5, 6], [7, 3]])):
        _hostprof.ENABLED = True
        try:
            kvl.routed_experts(torch.randn(3, 16), idx, torch.ones(3, 2), w13, w2)
        finally:
            _hostprof.ENABLED = False
        with_counts.append(torch.bincount(idx.reshape(-1), minlength=8))
    (t,) = kvl.moe_tallies()
    assert t["routed_rows"] == 6 and t["experts"] == 8
    assert t["touched"][3] == 1 and t["touched"][5] == 1 and sum(t["touched"]) == 2
    assert t["busiest_rows"] == 3 + 2
    assert t["mean_rows"] == pytest.approx(6 / 3 + 6 / 5)


def test_the_released_config_reads_as_published():
    """The preset (the released config.json's layout) gives the published
    widths, and the adapter's decoder holds one latent head of 576 a position."""
    c = kvl.KimiVLConfig.from_hf_dict(PRESET_CONFIGS["kimi-vl-a3b"])
    assert (c.hidden_size, c.num_layers, c.num_heads, c.n_routed_experts, c.num_experts_per_tok) == (2048, 27, 16, 64, 6)
    assert (c.kv_lora_rank, c.qk_rope_head_dim, c.q_head_dim, c.cache_dim) == (512, 64, 192, 576)
    assert c.vision.head_dim == 72 and c.vision.hidden_size == 1152 and c.vocab_size == 163840
    with pytest.raises(ValueError):
        kvl.KimiVLConfig.from_hf_dict({**PRESET_CONFIGS["kimi-vl-a3b"]["text_config"], "q_lora_rank": 1536})


def test_checkpoint_stacks_the_experts():
    """The loader stacks each MoE layer's per-expert gate and up into one
    [E, 2I, H] tensor and the downs into [E, H, I], from the released names."""
    state = _state(seed=11)
    model = _model(state)
    p = "language_model.model.layers.2.mlp.experts"
    moe = model.layers[2].ffn
    inter = model.config.moe_intermediate_size
    for e in range(moe.w13.shape[0]):
        assert torch.equal(moe.w13[e, :inter], state[f"{p}.{e}.gate_proj.weight"].float())
        assert torch.equal(moe.w13[e, inter:], state[f"{p}.{e}.up_proj.weight"].float())
        assert torch.equal(moe.w2[e], state[f"{p}.{e}.down_proj.weight"].float())
    assert torch.equal(moe.bias, state["language_model.model.layers.2.mlp.gate.e_score_correction_bias"])


@pytest.mark.card
def test_card_replayed_moe_steps_equal_direct_ones(card, monkeypatch):
    """Kimi-VL's widths at 3 layers (a dense layer, two of 64 experts) in
    bf16 on the card, a 96-row pool: decode steps replayed from CUDA graphs
    give the direct steps' logits and tokens bit for bit."""
    hf = {**PRESET_CONFIGS["kimi-vl-a3b"]["text_config"], "num_hidden_layers": 3}
    config = kvl.KimiVLConfig.from_hf_dict({"text_config": hf, "vision_config": {}})
    model = kvl.KimiVLModel(config, torch.bfloat16, "meta")
    kvl.init_params(model, torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    rows, prompt, new = 96, 128, 24
    pads = torch.randint(0, prompt // 2, (rows,), generator=g, device="cuda")
    mask = (torch.arange(prompt, device="cuda")[None] >= pads[:, None]).to(torch.int32)
    embeds = (torch.randn(rows, prompt, 2048, generator=g, device="cuda") * 0.5).bfloat16()
    positions = (torch.cumsum(mask, 1) - 1).clamp(min=0)[None].expand(3, rows, prompt).contiguous()
    logits, cache = tq.prefill(model, embeds, positions, mask, prompt + 64)

    def decode(graphs):
        kv_mask = torch.zeros(rows, prompt + 64, dtype=torch.int32, device="cuda")
        kv_mask[:, :prompt] = mask
        seen, real = [], tq.decode_step
        with monkeypatch.context() as m:
            m.setattr(tq, "decode_step", lambda *a: (lambda out: seen.append(out.clone()) or out)(real(*a)))
            if not graphs:
                m.setattr(tq.StepGraphs, "engages", staticmethod(lambda model, device: False))
            m.setattr(_hostprof, "ENABLED", True)
            _hostprof.counters_reset()
            tokens = tq.decode_pool(model, tuple(t.clone() for t in cache), logits, kv_mask, mask.sum(1).long(),
                                    new, prompt, torch.tensor([-1], device="cuda"), decode_rows=128)
            torch.cuda.synchronize()
            return tokens, seen, dict(_hostprof.counters)

    direct, graphed = decode(False), decode(True)
    assert torch.equal(graphed[0], direct[0])
    assert all(torch.equal(a_, b_) for a_, b_ in zip(graphed[1], direct[1]))
    assert graphed[2]["decode_graph_steps"] >= new - 3
    assert graphed[2]["moe_calls"] == direct[2]["moe_calls"] == (new - 1) * 2
    tallies = {t["routed_rows"]: t for t in kvl.moe_tallies()}
    assert sum(tallies[rows * 6]["touched"]) == 2 * (new - 1) * 2  # both decodes, every call counted


def test_tiny_preset_generates_pooled_as_unpooled(monkeypatch):
    """``generate_until`` of the tiny preset on the CPU: a decode pool of two
    chunks gives the unpooled answers (f32)."""
    from types import SimpleNamespace

    from PIL import Image

    from lmms_owc_tpu_torch.models import get_model

    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in [(64, 64), (120, 90), (200, 150), (90, 300)]]

    class Req:
        def __init__(self, args):
            self.args = args

    answers = {}
    for pool in ("1", "2"):
        monkeypatch.setenv("LMMS_OWC_DECODE_POOL", pool)
        model = get_model("kimi-vl-tiny", device="cpu", dtype="float32", batch_size=2)
        model.task_dict["t"] = SimpleNamespace(dataset={"test": [{"image": im} for im in images]})
        reqs = [Req(("What is this?", {"max_new_tokens": 5, "until": ["\n\n"]}, lambda d: [d["image"]], i, "t",
                     "test")) for i in range(len(images))]
        answers[pool] = model.generate_until(reqs)
    assert answers["1"] == answers["2"] and all(answers["1"])


# A pooled row's logits equal the same row's decoded in its own chunk, bit
# for bit on an H100 (PERF.md §6): the decode attention's batched products
# and softmax over the pool's longer cache add exact zeros for the masked
# positions, and the grouped GEMM gives a row the same bits whatever the
# other rows of its expert's group.


@pytest.mark.card
def test_card_pooled_decode_against_unpooled(card, monkeypatch):
    """Two chunks of 48 rows at Kimi-VL's widths (3 layers) and different
    prompt buckets, prefilled apart, decoded as one 96-row pool and each
    alone on the same tokens: every step's logits are equal bit for bit."""
    hf = {**PRESET_CONFIGS["kimi-vl-a3b"]["text_config"], "num_hidden_layers": 3}
    config = kvl.KimiVLConfig.from_hf_dict({"text_config": hf, "vision_config": {}})
    model = kvl.KimiVLModel(config, torch.bfloat16, "meta")
    kvl.init_params(model, torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(2)
    new, chunks = 16, []
    for bucket in (128, 256):
        pads = torch.randint(0, bucket // 2, (48,), generator=g, device="cuda")
        mask = (torch.arange(bucket, device="cuda")[None] >= pads[:, None]).to(torch.int32)
        embeds = (torch.randn(48, bucket, 2048, generator=g, device="cuda") * 0.5).bfloat16()
        positions = (torch.cumsum(mask, 1) - 1).clamp(min=0)[None].expand(3, 48, bucket).contiguous()
        logits, latent = tq.prefill_logits(model, embeds, positions, mask)
        chunks.append((bucket, mask, logits, latent))

    def decode(parts, forced=None):
        """(tokens, every step's logits); with ``forced`` [rows, new] the
        tokens fed back are those (the pooled run's), so both sides read the
        same inputs at every step."""
        l_max = max(p[0] for p in parts)
        rows = 48 * len(parts)
        cache = (torch.zeros(model.cache_shapes(rows, l_max + 64)[0], dtype=torch.bfloat16, device="cuda"),)
        kv_mask = torch.zeros(rows, l_max + 64, dtype=torch.int32, device="cuda")
        for r, (bucket, mask, _, latent) in enumerate(parts):
            tq.write_pool_rows(cache[0], latent, 48 * r, l_max - bucket)
            kv_mask[48 * r: 48 * (r + 1), l_max - bucket: l_max] = mask
        seen, real = [], tq.decode_step
        with monkeypatch.context() as m:
            m.setattr(tq, "decode_step", lambda *a: (lambda out: seen.append(out.clone()) or out)(real(*a)))
            if forced is not None:
                step = iter(range(new))
                m.setattr(tq, "_sample_token", lambda *a, **kw: forced[:, next(step)])
            tokens = tq.decode_pool(model, cache, torch.cat([p[2] for p in parts]), kv_mask,
                                    torch.cat([p[1].sum(1) for p in parts]).long(), new, l_max,
                                    torch.tensor([-1], device="cuda"), decode_rows=128)
        return tokens, torch.stack(seen)

    pooled_tokens, pooled = decode(chunks)
    alone = [decode([c], pooled_tokens[48 * r: 48 * (r + 1)]) for r, c in enumerate(chunks)]
    alone_logits = torch.cat([a[1] for a in alone], dim=1)
    gap = (pooled - alone_logits).abs().max().item()
    equal = (pooled == alone_logits).double().mean().item()
    greedy = (alone_logits.argmax(-1) == pooled.argmax(-1)).double().mean().item()
    print(f"pooled against unpooled: max logit gap {gap:.6g}, bit-equal share {equal:.6f}, "
          f"same greedy token {greedy:.4f}")
    assert gap == 0 and equal == 1.0

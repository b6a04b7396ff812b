"""The port's SigLIP tower and Idefics2 connector (``nn/idefics2.py``) and K2
at head_dim 72, against the JAX package.

A tiny Idefics2 config whose tower has SigLIP's head width (2 heads of 72)
gets its JAX tree from ``init_idefics2_params`` re-drawn from a numpy seed
and carried into the port with ``idefics2_params_from_jax``. In f32 with
TF32 off, ``siglip_vision_forward`` (plain arange positions, the full-grid
``bucket_positions``, and a padded batch with ``variable_patch_layout``
position ids and patch masks) and ``encode_images`` (the modality projection
and the perceiver) agree with JAX within ``TOL`` = 1e-4 (summation order
over a 2-layer tower). K2's plain path at D = 72 is held to the JAX
``attention_reference`` and to the Pallas kernel in interpret mode (block_k
< L, both mask forms) within ``TOL``; a D = 72 launch (library faked) hands
the kernel head_dim 72 with the (start, end) table or the int32 mask.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmms_owc_tpu.nn import idefics2 as jidf
from lmms_owc_tpu.nn.llama import llama_config_from_hf as jax_llama_config
from lmms_owc_tpu.ops import attention as jatt
from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.nn import idefics2 as idf
from lmms_owc_tpu_torch.ops import _build
from lmms_owc_tpu_torch.ops import attention as tatt
from tests.test_torch_attention import _FakeLibrary

TOL = 1e-4
HF_CONFIG = dict(
    vision_config=dict(hidden_size=144, num_hidden_layers=2, num_attention_heads=2, intermediate_size=96,
                       image_size=56, patch_size=14),
    perceiver_config=dict(resampler_n_latents=4, resampler_depth=2, resampler_n_heads=4, resampler_head_dim=8,
                          num_key_value_heads=2),
    text_config=dict(model_type="mistral", vocab_size=128, hidden_size=48, intermediate_size=96,
                     num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5),
    image_token_id=100,
)
DIMS = [(56, 56), (42, 28), (28, 56)]  # pixel (h, w) of a padded batch: 16, 6 and 8 valid patches


def redraw(node, rng):
    """Numpy copy of a JAX tree (dicts and lists) with every leaf re-drawn, as
    ``tests/test_torch_qwen2_vl._redraw``: weights ~ N(0, 0.1), biases ~
    N(0, 0.05), norm scales ~ 1 + N(0, 0.1)."""
    if isinstance(node, list):
        return [redraw(x, rng) for x in node]
    out = {}
    for key, leaf in node.items():
        if isinstance(leaf, (dict, list)):
            out[key] = redraw(leaf, rng)
            continue
        noise = rng.standard_normal(np.shape(leaf)).astype(np.float32)
        out[key] = 1.0 + 0.1 * noise if key == "scale" else (0.05 if key in ("b", "bias") else 0.1) * noise
    return out


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


@pytest.fixture(scope="module")
def pair():
    cfg_j = jidf.idefics2_config_from_hf(HF_CONFIG)
    cfg_t = idf.idefics2_config_from_hf(HF_CONFIG)
    tree = jidf.init_idefics2_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    tree = redraw(jax.tree_util.tree_map(np.asarray, tree), np.random.default_rng(0))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg_j, jtree, cfg_t, idf.idefics2_params_from_jax(tree, cfg_t), tree


def _padded_batch(dims, grid=(4, 4), p=14, seed=0):
    rng = np.random.RandomState(seed)
    pixels = np.zeros((len(dims), 3, grid[0] * p, grid[1] * p), np.float32)
    for i, (h, w) in enumerate(dims):
        pixels[i, :, :h, :w] = rng.randn(3, h, w)
    pos, mask = jidf.variable_patch_layout(dims, grid, 4, p)
    return pixels, pos, mask


def test_configs_match_jax():
    got, want = idf.idefics2_config_from_hf(HF_CONFIG), jidf.idefics2_config_from_hf(HF_CONFIG)
    assert dataclasses.asdict(got.vision) == dataclasses.asdict(want.vision)
    assert dataclasses.asdict(got.perceiver) == dataclasses.asdict(want.perceiver)
    assert dataclasses.asdict(got.text) == dataclasses.asdict(want.text)
    assert got.image_token_id == want.image_token_id == 100
    assert got.vision.hidden_size // got.vision.num_heads == 72
    assert dataclasses.asdict(idf.idefics2_config_from_hf({"text_config": HF_CONFIG["text_config"]}).vision) == \
        dataclasses.asdict(jidf.idefics2_config_from_hf({"text_config": HF_CONFIG["text_config"]}).vision)
    assert jax_llama_config(HF_CONFIG["text_config"]).num_kv_heads == got.text.num_kv_heads == 2


@pytest.mark.parametrize("dims,grid", [([(56, 56), (42, 28), (28, 56)], (4, 4)), ([(30, 100), (98, 14)], (7, 8))])
def test_variable_patch_layout_matches_jax(dims, grid):
    got, want = idf.variable_patch_layout(dims, grid, 70, 14), jidf.variable_patch_layout(dims, grid, 70, 14)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("mode", ["arange", "bucket", "padded"])
def test_siglip_vision_forward_matches_jax(pair, mode):
    cfg_j, jtree, cfg_t, model, _ = pair
    if mode == "padded":
        pixels, pos, mask = _padded_batch(DIMS)
        want = jidf.siglip_vision_forward(jtree["vision"], jnp.asarray(pixels), cfg_j.vision,
                                          position_ids=jnp.asarray(pos), patch_mask=jnp.asarray(mask))
        got = idf.siglip_vision_forward(model.vision, torch.from_numpy(pixels), cfg_t.vision,
                                        position_ids=torch.from_numpy(pos), patch_mask=torch.from_numpy(mask))
    else:
        pixels = np.random.RandomState(1).randn(2, 3, 56, 56).astype(np.float32)
        bucket = mode == "bucket"
        want = jidf.siglip_vision_forward(jtree["vision"], jnp.asarray(pixels), cfg_j.vision, bucket_positions=bucket)
        got = idf.siglip_vision_forward(model.vision, torch.from_numpy(pixels), cfg_t.vision, bucket_positions=bucket)
    assert tuple(got.shape) == np.shape(want) == (len(pixels), 16, 144)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_encode_images_matches_jax(pair, padded):
    cfg_j, jtree, cfg_t, model, _ = pair
    if padded:
        pixels, pos, mask = _padded_batch(DIMS, seed=2)
        want = jidf.encode_images(jtree, jnp.asarray(pixels), cfg_j, jnp.asarray(pos), jnp.asarray(mask))
        got = idf.encode_images(model, torch.from_numpy(pixels), cfg_t, torch.from_numpy(pos),
                                torch.from_numpy(mask))
    else:
        pixels = np.random.RandomState(3).randn(2, 3, 56, 56).astype(np.float32)
        want = jidf.encode_images(jtree, jnp.asarray(pixels), cfg_j)
        got = idf.encode_images(model, torch.from_numpy(pixels), cfg_t)
    assert tuple(got.shape) == np.shape(want) == (len(pixels), 4, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_params_from_jax_copies_every_leaf(pair):
    _, _, cfg_t, model, tree = pair
    v, p = model.vision, model.perceiver
    np.testing.assert_array_equal(v.patch_embed.weight.numpy(), tree["vision"]["patch_embed"]["w"].T)
    np.testing.assert_array_equal(v.patch_embed.bias.numpy(), tree["vision"]["patch_embed"]["b"])
    np.testing.assert_array_equal(v.position_embedding.numpy(), tree["vision"]["position_embedding"])
    np.testing.assert_array_equal(v.layers[1].fc2.weight.numpy(), tree["vision"]["layers"]["fc2"]["w"][1].T)
    np.testing.assert_array_equal(v.layers[0].ln2.bias.numpy(), tree["vision"]["layers"]["ln2"]["bias"][0])
    np.testing.assert_array_equal(v.post_ln.weight.numpy(), tree["vision"]["post_ln"]["scale"])
    np.testing.assert_array_equal(model.modality_projection.down.weight.numpy(),
                                  tree["modality_projection"]["down"]["w"].T)
    np.testing.assert_array_equal(p.latents.numpy(), tree["perceiver"]["latents"])
    np.testing.assert_array_equal(p.layers[1].k.weight.numpy(), tree["perceiver"]["layers"][1]["attn"]["k"]["w"].T)
    np.testing.assert_array_equal(p.layers[0].mlp.up.weight.numpy(), tree["perceiver"]["layers"][0]["mlp"]["up"]["w"].T)
    np.testing.assert_array_equal(p.layers[0].input_context_norm.weight.numpy(),
                                  tree["perceiver"]["layers"][0]["input_context_norm"]["scale"])
    np.testing.assert_array_equal(p.norm.weight.numpy(), tree["perceiver"]["norm"]["scale"])
    np.testing.assert_array_equal(model.text.embed_tokens.numpy(), tree["text"]["embed_tokens"])
    # Every parameter was written: the stacked [L, ...] leaves hold as many
    # values as the per-layer modules.
    n_values = sum(np.size(leaf) for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(t.numel() for t in model.parameters()) == n_values


# ------------------------------------------------------------------ K2 at D = 72


def _d72_operands(seed, b=2, h=4, kvh=2, l=100):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, l, 72).astype(np.float32)
    k = rng.randn(b, kvh, l, 72).astype(np.float32)
    v = rng.randn(b, kvh, l, 72).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("form", ["none", "contiguous", "tensor"])
def test_flash_attention_d72_matches_jax(form):
    """Both mask forms at D = 72: the plain path against the JAX reference and
    the Pallas kernel (interpret mode, 32-key blocks over 100 keys)."""
    q, k, v = _d72_operands(4)
    b, _, l, _ = q.shape
    mask = None
    if form == "contiguous":
        mask = np.zeros((b, l), np.int32)
        mask[0, :100], mask[1, :61] = 1, 1
    elif form == "tensor":
        mask = (np.random.RandomState(5).rand(b, l) < 0.6).astype(np.int32)
        mask[:, 0] = 1
    contiguous = form == "contiguous"
    jm = None if mask is None else jnp.asarray(mask)
    kr, vr = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    ref = jatt.attention_reference(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), kv_mask=jm)
    pallas = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jm,
                                  kv_mask_contiguous=contiguous, block_q=64, block_k=32, use_pallas=True,
                                  interpret=True)
    got = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               kv_mask=None if mask is None else torch.from_numpy(mask),
                               kv_mask_contiguous=contiguous)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["contiguous", "tensor"])
def test_d72_launch_hands_the_kernel_its_mask(monkeypatch, dtype, form):
    """A D = 72 launch is built (no head-dim refusal) and carries its int32
    mask as a contiguous run (``mask_run``) or a tensor mask (``mask``); a
    tensor-mask launch is counted as such."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(tatt, "_check_operands", lambda tensors: next(iter(tensors.values())).dtype)
    monkeypatch.setattr(tatt, "_stream_handle", lambda device: 0)
    tatt.reset_launch_counts()
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _d72_operands(6, b=2, h=16, kvh=16, l=40))
    mask = torch.ones(2, 40, dtype=torch.int32)
    mask[1, 30:] = 0
    if form == "tensor":
        mask[0, 5] = 0
    tatt._launch_flash("flash_attention", q, k, v, torch.empty(q.shape, dtype=dtype), causal=False, kv_mask=mask,
                       kv_mask_contiguous=form == "contiguous", scale=72 ** -0.5, rope_cos=None, rope_sin=None)
    (call,) = lib.calls
    assert call["head_dim"] == 72 and call["heads"] == call["kv_heads"] == 16
    assert call["dtype"] == (1 if dtype == torch.bfloat16 else 0)
    assert bool(call["mask_run"]) == (form == "contiguous") and bool(call["mask"]) == (form == "tensor")
    assert tatt.launch_counts["flash_attention"] == 1
    assert tatt.launch_counts["flash_attention_tensor_mask"] == (form == "tensor")
    tatt.reset_launch_counts()
    assert 72 in tatt._FLASH_HEAD_DIMS

"""The port loading HF checkpoints, against the JAX package loading the same ones.

Two tiny checkpoint directories are written offline with transformers'
classes, as ``tests/test_checkpoint_matrix.py`` writes its own, but with the
released Qwen2 vocabulary of 152064 tokens and the Qwen2 specials pinned at
their published ids (``chip_smoke.py``'s ``pinned_tokenizer``), so that every
id the adapters feed or stop on is a real row: ``qwen2-vl-tiny`` (untied head)
and ``qwen2.5-vl-tiny`` (tied). Weights are redrawn larger than the 0.02 init
(weights N(0, 0.1), biases N(0, 0.05), norm scales 1 + N(0, 0.1)) so greedy
tokens vary. Both packages load each directory with ``pretrained=`` on the
CPU; the port's parameters must be bit-equal to the JAX converter's, its
quantized leaves to the JAX adapter's, and its ``generate_until``,
``loglikelihood`` and ``generate_until_multi_round`` outputs identical (losses
within rtol 1e-5).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tests.test_checkpoint_matrix import _build_qwen2_vl

FIXTURE_TOK = chip_smoke.FIXTURE_TOKENIZER
SPECIALS = chip_smoke.QWEN2_SPECIAL_IDS
TEXT = dict(
    vocab_size=152064, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
    rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
    eos_token_id=SPECIALS["<|im_end|>"], pad_token_id=SPECIALS["<|endoftext|>"],
)
IDS = dict(
    image_token_id=SPECIALS["<|image_pad|>"], video_token_id=SPECIALS["<|video_pad|>"],
    vision_start_token_id=SPECIALS["<|vision_start|>"], eos_token_id=SPECIALS["<|im_end|>"],
    pad_token_id=SPECIALS["<|endoftext|>"],
)
PRESETS = ["qwen2-vl-tiny", "qwen2.5-vl-tiny"]


def _redraw_state(model, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
            if name.endswith("bias"):
                t.copy_(0.05 * noise)
            elif t.dim() == 1 and ("norm" in name or "ln_q" in name):
                t.copy_(1.0 + 0.1 * noise)
            else:
                t.copy_(0.1 * noise)


def _write_tokenizer(path) -> None:
    from transformers import PreTrainedTokenizerFast

    blob = chip_smoke.pinned_tokenizer(json.loads(FIXTURE_TOK.read_text()), SPECIALS)
    (path / "tokenizer.json").write_text(json.dumps(blob))
    PreTrainedTokenizerFast(
        tokenizer_file=str(path / "tokenizer.json"), eos_token="<|im_end|>", pad_token="<|endoftext|>"
    ).save_pretrained(str(path))


def _build(path, preset: str) -> None:
    if preset == "qwen2-vl-tiny":
        from transformers.models.qwen2_vl.configuration_qwen2_vl import Qwen2VLConfig as Config
        from transformers.models.qwen2_vl.modeling_qwen2_vl import Qwen2VLForConditionalGeneration as Cls

        tied = False
        vision = dict(depth=2, embed_dim=32, num_heads=4, mlp_ratio=2.0, in_channels=3, patch_size=14,
                      temporal_patch_size=2, spatial_merge_size=2, hidden_size=64)
    else:
        from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import Qwen2_5_VLConfig as Config
        from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import Qwen2_5_VLForConditionalGeneration as Cls

        tied = True
        vision = dict(depth=2, hidden_size=32, num_heads=4, intermediate_size=64, out_hidden_size=64, patch_size=14,
                      temporal_patch_size=2, spatial_merge_size=2, window_size=56, fullatt_block_indexes=[1])
    torch.manual_seed(0)
    config = Config(text_config=dict(TEXT, tie_word_embeddings=tied), vision_config=vision,
                    tie_word_embeddings=tied, **IDS)
    model = Cls(config).eval()
    _redraw_state(model, seed=len(preset))
    model.save_pretrained(str(path))
    _write_tokenizer(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    out = {}
    for preset in PRESETS:
        path = tmp_path_factory.mktemp(preset.replace(".", "_"))
        _build(path, preset)
        out[preset] = path
    return out


def _port(preset, path, **kw):
    from lmms_owc_tpu_torch.models import get_model

    return get_model(preset, pretrained=str(path), batch_size=4, dtype=kw.pop("dtype", "float32"), device="cpu", **kw)


def _jax(preset, path, **kw):
    from lmms_owc_tpu.models import get_model

    return get_model(preset, pretrained=str(path), batch_size=4, dtype="float32", **kw)


def _reference_model(preset, path, dtype):
    """The port's model filled by ``params_from_jax`` from the JAX converter's tree."""
    from lmms_owc_tpu.nn import qwen2_5_vl as jq25
    from lmms_owc_tpu.nn import qwen2_vl as jq
    from lmms_owc_tpu.nn.loader import load_config_json, load_safetensors_state
    from lmms_owc_tpu_torch.nn import qwen2_5_vl as tq25
    from lmms_owc_tpu_torch.nn import qwen2_vl as tq

    hf = load_config_json(path)
    state = load_safetensors_state(path)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jcfg = jq.Qwen2VLConfig.from_hf_dict(hf)
    v25 = None
    if hf.get("model_type") == "qwen2_5_vl":
        tree = jq.convert_hf_decoder_weights(state, jcfg, jdtype)
        tree["vision"] = jq25.convert_hf_vision25_weights(state, jq25.Qwen25VisionConfig.from_hf_dict(hf["vision_config"]), jdtype)
        v25 = tq25.Qwen25VisionConfig.from_hf_dict(hf["vision_config"])
    else:
        tree = jq.convert_hf_weights(state, jcfg, jdtype)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), tree)
    model = tq.Qwen2VLModel(tq.Qwen2VLConfig.from_hf_dict(hf), dtype, "cpu", vision25=v25)
    return tq.params_from_jax(model, tree)


def _assert_same_state(got: torch.nn.Module, want: torch.nn.Module) -> None:
    g, w = got.state_dict(), want.state_dict()
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        assert torch.equal(g[name], w[name]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", PRESETS)
def test_pretrained_parameters_bit_equal_to_jax_converter(checkpoints, preset, dtype):
    model = _port(preset, checkpoints[preset], dtype=dtype)
    assert model.is_v25 is (preset == "qwen2.5-vl-tiny")
    assert (model.model.lm_head is None) is (preset == "qwen2.5-vl-tiny")  # tied: no head to load
    _assert_same_state(model.model, _reference_model(preset, checkpoints[preset], model.torch_dtype))
    if model.is_v25:  # the tower alone, through its own entry
        from lmms_owc_tpu_torch.nn.loader import load_safetensors_state
        from lmms_owc_tpu_torch.nn.qwen2_5_vl import Vision25Tower, load_hf_vision25_weights

        tower = Vision25Tower(model.vision25_config, model.torch_dtype, "cpu")
        load_hf_vision25_weights(tower, load_safetensors_state(checkpoints[preset]))
        _assert_same_state(tower, model.model.vision)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_leaves_equal_jax_adapter(checkpoints, bits):
    from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
    from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLModel, params_from_jax

    preset, path = "qwen2-vl-tiny", checkpoints["qwen2-vl-tiny"]
    flag = {"load_in_8bit": True} if bits == 8 else {"load_in_4bit": True}
    port = _port(preset, path, **flag)
    jm = _jax(preset, path, **flag)
    want = params_from_jax(Qwen2VLModel(port.config, torch.float32, "cpu"),
                           jax.tree_util.tree_map(np.asarray, jm.params))
    cls = Int8Linear if bits == 8 else Int4Linear
    assert sum(isinstance(m, cls) for m in port.model.modules()) > 10
    _assert_same_state(port.model, want)


class _Req:
    def __init__(self, args):
        self.args = args


def _spy_tokens(model, monkeypatch) -> list:
    seen = []
    detok = model._detokenize

    def spy(tokens):
        seen.append(np.asarray(tokens).copy())
        return detok(tokens)

    monkeypatch.setattr(model, "_detokenize", spy)
    return seen


def _toy(name, toy_task_path, model_name="qwen2-vl-tiny"):
    from lmms_owc_tpu.tasks import TaskManager, get_tasks_as_dict

    task = get_tasks_as_dict([name], TaskManager(include_path=toy_task_path, model_name=model_name))[name]
    task.set_config(key="num_fewshot", value=0)
    task.build_all_requests(limit=6)
    return task


@pytest.mark.parametrize(
    "preset, flag",
    [("qwen2-vl-tiny", {}), ("qwen2-vl-tiny", {"load_in_8bit": True}), ("qwen2-vl-tiny", {"load_in_4bit": True}),
     ("qwen2.5-vl-tiny", {})],
    ids=["qwen2-f32", "qwen2-int8", "qwen2-int4", "qwen25-f32"],
)
def test_generate_until_identical_from_checkpoint(checkpoints, preset, flag, monkeypatch, toy_task_path, toy_dataset):
    """int4 runs 12 new tokens, the others 16. Its head multiplies in bf16, as
    the JAX package's does, so its logits are rounded to bf16 and near-ties
    are common; the two CPU matmul libraries sum in different orders, which
    moves about 1e-5 of those logits by one bf16 step, and on this request set
    one row's 14th token flips at such a tie."""
    task = _toy("toy", toy_task_path)
    gen_kwargs = {"max_new_tokens": 12 if flag.get("load_in_4bit") else 16, "do_sample": False, "until": None}
    contexts = ["What type of object is in this photo?", "Name it.", "Describe the scene in a few words, please."]
    requests = [_Req((contexts[i % 3], gen_kwargs, task.doc_to_visual, i, "toy", "test")) for i in range(6)]
    outs, tokens = [], []
    for model in (_jax(preset, checkpoints[preset], **flag), _port(preset, checkpoints[preset], **flag)):
        model.task_dict["toy"] = task
        seen = _spy_tokens(model, monkeypatch)
        outs.append(model.generate_until(requests))
        tokens.append(seen)
    assert outs[1] == outs[0] and len(outs[1]) == 6
    assert len(tokens[1]) == len(tokens[0]) > 0
    for got, want in zip(tokens[1], tokens[0]):
        np.testing.assert_array_equal(got, want)
    assert len(set(np.concatenate(tokens[1]).ravel().tolist())) > 3  # the redrawn weights vary the tokens


@pytest.mark.parametrize("preset", PRESETS)
def test_loglikelihood_matches_jax(checkpoints, preset, toy_task_path, toy_dataset):
    """toy_mc's multiple-choice requests (one per choice), plus the two-element
    (ctx, choice) form of ``acc_mutual_info``'s unconditional requests."""
    task = _toy("toy_mc", toy_task_path, preset)
    requests = [_Req(inst.args) for inst in task.instances] + [_Req(("", " paris")), _Req(("Say:", " golden retriever"))]
    assert len(requests) > 10
    out = []
    for model in (_jax(preset, checkpoints[preset]), _port(preset, checkpoints[preset])):
        model.task_dict["toy_mc"] = task
        out.append(model.loglikelihood(requests))
    (want, got) = out
    np.testing.assert_allclose([l for l, _ in got], [l for l, _ in want], rtol=1e-5)
    assert [g for _, g in got] == [g for _, g in want]
    assert all(np.isfinite(l) and l > 0 for l, _ in got)


def test_loglikelihood_continuation_ids(checkpoints, toy_task_path, toy_dataset, monkeypatch):
    """The scored continuation ids are exactly ``encode(" paris")``: the
    delimiter lives in the continuation and is not doubled."""
    from lmms_owc_tpu_torch.models._base import Model

    model = _port("qwen2-vl-tiny", checkpoints["qwen2-vl-tiny"])
    recorded = []
    orig = Model._encode_continuation
    monkeypatch.setattr(Model, "_encode_continuation", lambda self, c: recorded.append(orig(self, c)) or recorded[-1])
    task = _toy("toy", toy_task_path)
    model.task_dict["toy"] = task
    model.loglikelihood([_Req(("What is this?", " paris", task.doc_to_visual, 0, "toy", "test"))])
    expected = model.tokenizer.encode(" paris", add_special_tokens=False)
    assert recorded == [expected]
    assert recorded[0][0] != model.tokenizer.encode("  paris", add_special_tokens=False)[0]


def test_score_continuation_matches_jax(checkpoints):
    """``score_continuation`` on one padded batch, port against JAX, with one
    row scoring nothing (loss 0, greedy)."""
    from lmms_owc_tpu.nn import qwen2_vl as jq
    from lmms_owc_tpu_torch.nn import qwen2_vl as tq

    port = _port("qwen2-vl-tiny", checkpoints["qwen2-vl-tiny"])
    jm = _jax("qwen2-vl-tiny", checkpoints["qwen2-vl-tiny"])
    rng = np.random.default_rng(3)
    b, length, h = 3, 24, port.config.hidden_size
    embeds = rng.standard_normal((b, length, h)).astype(np.float32)
    mask = np.ones((b, length), np.int32)
    mask[1, :7] = 0
    pos = np.broadcast_to(np.cumsum(mask, 1)[None] - 1, (3, b, length)).astype(np.int64).copy()
    target_ids = rng.integers(0, port.config.vocab_size, (b, length))
    target_mask = np.zeros((b, length), np.int32)
    target_mask[0, 18:23] = 1
    target_mask[1, 20:23] = 1
    loss_j, greedy_j = jq.score_continuation(jm.params, jnp.asarray(embeds), jnp.asarray(pos), jnp.asarray(mask),
                                            jnp.asarray(target_ids), jnp.asarray(target_mask), jm.config)
    t = torch.from_numpy
    loss_t, greedy_t = tq.score_continuation(port.model, t(embeds), t(pos), t(mask), t(target_ids), t(target_mask))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)
    assert greedy_t.tolist() == np.asarray(greedy_j).tolist() and loss_t[2] == 0 and bool(greedy_t[2])


def test_multi_round_pool_1_and_2_identical(checkpoints, monkeypatch, toy_task_path, toy_dataset):
    """toy_multiround's two rounds: identical at pool 1 and pool 2 (chunks of 2,
    so each round's sub-chunks pool), and identical to the JAX adapter's."""
    task = _toy("toy_multiround", toy_task_path)
    requests = [_Req(inst.args) for inst in task.instances]
    assert len(requests) == 6 and len(requests[0].args) == 7
    port = _port("qwen2-vl-tiny", checkpoints["qwen2-vl-tiny"])
    jm = _jax("qwen2-vl-tiny", checkpoints["qwen2-vl-tiny"])
    for model in (port, jm):
        model.task_dict["toy_multiround"] = task
        model.batch_size = 2
    monkeypatch.setenv("LMMS_OWC_SORT_BY_VISION", "0")
    monkeypatch.setenv("LMMS_OWC_DECODE_POOL", "1")
    pool1 = port.generate_until_multi_round(requests)
    assert all(len(r) == 2 for r in pool1)
    assert jm.generate_until_multi_round(requests) == pool1
    monkeypatch.setenv("LMMS_OWC_DECODE_POOL", "2")
    calls = []
    run_pooled = port._run_pooled
    monkeypatch.setattr(port, "_run_pooled", lambda prepared, gk: calls.append(len(prepared)) or run_pooled(prepared, gk))
    assert port.generate_until_multi_round(requests) == pool1
    assert calls and max(calls) == 2  # the sub-chunks of a round did pool
    base_rounds = type(port).__mro__[1].generate_until_multi_round(port, requests)
    assert base_rounds == pool1  # the generic base protocol agrees


def test_vocabulary_check_raises_on_512_token_checkpoint(tmp_path, monkeypatch):
    """On a checkpoint whose 512-token vocabulary misses the Qwen2 pad and eos
    ids (``Qwen2VLConfig.from_hf_dict`` turns pad 0 into 151643), the JAX
    adapter's ``jnp.take`` reads NaN rows and decodes empty strings; the port
    refuses the checkpoint at load, naming the id."""
    from PIL import Image

    from lmms_owc_tpu_torch.models import get_model

    _build_qwen2_vl(tmp_path)
    with pytest.raises(ValueError, match="pad_token_id 151643 lies outside the checkpoint's vocabulary of 512"):
        get_model("qwen2-vl-tiny", pretrained=str(tmp_path), device="cpu", dtype="float32")

    jm = _jax("qwen2-vl-tiny", tmp_path)
    assert jm.config.pad_token_id == 151643 and jm.config.vocab_size == 512
    image = Image.fromarray(np.random.RandomState(0).randint(0, 255, (48, 56, 3), np.uint8))

    class _Task:
        dataset = {"test": [{"image": image}]}

    jm.task_dict["t"] = _Task()
    out = jm.generate_until([_Req(("Describe.", {"max_new_tokens": 4}, lambda d: [d["image"]], 0, "t", "test"))])
    assert out == [""]


def test_random_init_flag_keeps_the_jax_meaning(tmp_path):
    from lmms_owc_tpu_torch.models import get_model

    m = get_model("qwen2-vl-tiny", pretrained=str(tmp_path / "missing"), random_init=True, device="cpu",
                  dtype="float32")
    assert m.random_init and m.model.config.hidden_size == 64
    assert get_model("qwen2-vl-tiny", device="cpu", dtype="float32").random_init

"""The port's tensor and data parallelism (``lmms_owc_tpu_torch/parallel``) against the JAX package.

- ``MeshConfig.resolve`` gives JAX's shapes and errors, case for case;
  ``model_parallel=2`` without a process group raises, as JAX's mesh does on one device.
- The port's sharding of every parameter of a tiny Qwen2-VL tree (float,
  int8, int4; a width the model axis does not divide) splits the axis that
  JAX's ``make_param_shardings`` spec splits, on the conftest's 8 virtual
  devices, and keeps whole what JAX replicates.
- Two gloo ranks (``tests/torch_tp_worker.py``, one subprocess each, a 60 s
  process-group timeout): the JAX tree in the port, whole and sharded, gives
  the same prefill logits (within ``TOL`` = 2e-4, the bound of
  ``tests/test_parallel.py``; also against JAX's ``prefill`` under a
  ``data=1, model=2`` mesh; W8A8 sharded equals whole bit for bit, and JAX
  in argmax and within ``W8A8_TOL``; int4's bf16 head within one bf16
  step of XLA's f32 one), the same greedy tokens and the same tower
  output: float, weight-only int8, W8A8 (the amax all-reduce), int4 (the
  repack), the int8 KV cache, and one KV head at tp = 2 (replicated KV).
  Random init through the shard hook holds the unsharded model's weights
  (float, int8, int4). ``llava-tiny``, ``internvl2-tiny`` and
  ``qwen2-vl-tiny`` with ``model_parallel=2`` give the unsharded strings, each
  rank holding half of ``up``: drawn from a seed, and for LLaVA and InternVL2
  also read from a tiny checkpoint (float, sliced as each module is read). The judge with ``data_parallel`` on 2 ranks
  gives the one-rank verdicts on 11 prompts.
"""

import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmms_owc_tpu.nn import qwen2_vl as jqvl
from lmms_owc_tpu.ops import quant as jquant
from lmms_owc_tpu.parallel import MeshConfig as JaxMeshConfig
from lmms_owc_tpu.parallel import create_mesh as jax_create_mesh
from lmms_owc_tpu.parallel.sharding import make_param_shardings, shard_params
from lmms_owc_tpu_torch.models import get_model
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.parallel import MeshConfig, ModelGroup
from lmms_owc_tpu_torch.parallel.sharding import make_plan, shard_model

REPO = Path(__file__).resolve().parent.parent
TOL = 2e-4
W8A8_TOL = 5e-2  # a few steps of W8A8's activation grid in these logits
BF16_STEP = 2.0**-8
CONFIG = dict(
    vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=256, tie_word_embeddings=False,
    rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
    vision_config=dict(depth=2, embed_dim=32, num_heads=4, mlp_ratio=2.0),
)


def _tree(config: dict, bits: int | None = None, seed: int = 0) -> dict:
    """A JAX ``init_params`` tree re-drawn from numpy (weights ~ N(0, 0.1),
    biases ~ N(0, 0.05), norm scales ~ 1 + N(0, 0.1)), int8/int4 by the JAX quantizers."""
    rng = np.random.default_rng(seed)
    tree = jqvl.init_params(jax.random.PRNGKey(0), jqvl.Qwen2VLConfig.from_hf_dict(config), jnp.float32)

    def redraw(path, leaf):
        key = str(getattr(path[-1], "key", ""))
        noise = rng.standard_normal(np.shape(leaf)).astype(np.float32)
        return 1.0 + 0.1 * noise if key == "scale" else (0.05 if key in ("b", "bias") else 0.1) * noise

    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    if bits is not None:
        tree = (jquant.quantize_params_int8 if bits == 8 else jquant.quantize_params_int4)(
            jax.tree_util.tree_map(jnp.asarray, tree))
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("shape,n", [((-1, 2), 8), ((-1, 1), 8), ((4, 2), 8), ((4, -1), 8), ((3, 2), 8),
                                     ((-1, -1), 8), ((-1, 2), 1), ((1, 1), 1), ((2, 2), 4)])
def test_mesh_resolve_matches_jax(shape, n):
    def resolve(cls):
        try:
            return cls(*shape).resolve(n)
        except ValueError as err:
            return f"ValueError: {err}"

    assert resolve(MeshConfig) == resolve(JaxMeshConfig)


def test_model_parallel_without_a_process_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="does not match device count 1"):
        get_model("qwen2-vl-tiny", dtype="float32", device="cpu", model_parallel=2)
    # A data-only mesh of one process is no mesh: the adapter runs as before.
    assert get_model("qwen2-vl-tiny", dtype="float32", device="cpu", use_mesh=True).mesh is None


# ------------------------------------------------------------------ rules


def _port_name(path: tuple) -> tuple[str, bool]:
    """The port's parameter name of a JAX leaf path (layer 0 of a stacked
    leaf), and whether the JAX leaf is laid out [in, out] (a kernel, its int
    leaves and int4's group scales)."""
    parts = [str(getattr(k, "key", k)) for k in path]
    if len(parts) > 1 and parts[-2] in ("w_q8", "w_q4"):
        parts, leaf, kernel = parts[:-2], parts[-1], True
    else:
        parts, leaf, kernel = parts[:-1], {"w": "weight", "b": "bias", "scale": "weight"}.get(parts[-1], parts[-1]), \
            parts[-1] == "w"
    if parts[:1] == ["layers"]:
        parts = ["layers", "0", *[p for p in parts[1:] if p not in ("attn", "mlp")]]
    elif parts[:2] == ["vision", "layers"]:
        parts = ["vision", "blocks", "0", *parts[2:]]
    return ".".join([*parts, leaf]), kernel


def _port_spec_of_jax(spec, stacked: bool, kernel: bool, ndim: int) -> tuple:
    dims = list(spec) + [None] * (ndim - len(tuple(spec)))
    if stacked:
        dims = dims[1:]
    if kernel and len(dims) == 2:
        dims = dims[::-1]
    return tuple(dims)


@pytest.mark.parametrize("form", ["float", "int8", "int4", "indivisible"])
def test_rules_match_jax_make_param_shardings(form):
    """Every parameter that the port's sharding (``shard_model`` over 2 ranks)
    slices is split on the axis that JAX's spec puts on "model", and every
    other parameter is whole, as JAX replicates it."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    config = dict(CONFIG, intermediate_size=127) if form == "indivisible" else CONFIG
    bits = {"int8": 8, "int4": 4}.get(form)
    tree = _tree(config, bits)
    shardings = make_param_shardings(tree, jax_create_mesh(JaxMeshConfig(data=4, model=2)))

    def build():
        return qvl.params_from_jax(qvl.Qwen2VLModel(qvl.Qwen2VLConfig.from_hf_dict(config), torch.float32, "cpu"),
                                   tree)

    whole, sharded = build(), shard_model(build(), ModelGroup(None, 0, 2))
    full = dict(whole.named_parameters()) | dict(whole.named_buffers())
    split = {name.replace(".inner.", "."): t for name, t in
             [*sharded.named_parameters(), *sharded.named_buffers()]}
    checked = 0
    for path, sharding in jax.tree_util.tree_leaves_with_path(shardings):
        value = tree
        for k in path:
            value = value[getattr(k, "key", getattr(k, "idx", k))]
        name, kernel = _port_name(path)
        stacked = str(getattr(path[0], "key", "")) == "layers" or (
            str(getattr(path[0], "key", "")) == "vision" and str(getattr(path[1], "key", "")) == "layers")
        want = _port_spec_of_jax(sharding.spec, stacked, kernel, np.ndim(value))
        got = tuple("model" if b < a else None for a, b in zip(full[name].shape, split[name].shape))
        assert got == want, (name, got, want)
        checked += 1
    assert checked == len([n for n in full if not re.search(r"(layers|blocks)\.[1-9]", n)])  # every leaf, once
    plan = make_plan(whole, 2, 0, int4=bits == 4)
    if form != "indivisible":
        assert {"attn", "mlp", "vocab", "tower_attn", "tower_mlp", "merger"} <= plan.blocks
    else:
        assert "mlp" not in plan.blocks and "attn" in plan.blocks


# ------------------------------------------------------------------ two gloo ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_mesh_logits(tree: dict, config: dict, w8a8: bool) -> np.ndarray:
    """JAX's ``prefill`` logits with the tree sharded over a ``data=1, model=2`` mesh."""
    from lmms_owc_tpu.nn.layers import set_int8_activations

    sys.path.insert(0, str(REPO / "tests"))
    from torch_tp_worker import _inputs

    cfg = jqvl.Qwen2VLConfig.from_hf_dict(config)
    embeds, pos, mask, _ = _inputs(qvl.Qwen2VLConfig.from_hf_dict(config))
    mesh = jax_create_mesh(JaxMeshConfig(data=1, model=2), jax.devices()[:2])
    params = shard_params(jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    set_int8_activations(w8a8)
    try:
        with mesh:
            logits, _ = jqvl.prefill(params, jnp.asarray(embeds.numpy()), jnp.asarray(pos.numpy()),
                                     jnp.asarray(mask.numpy()), cfg, cache_len=24)
    finally:
        set_int8_activations(False)
    return np.asarray(logits)


DECODER_CASES = {
    "float": dict(),
    "int8": dict(bits=8),
    "w8a8": dict(bits=8, w8a8=True),
    "int4": dict(bits=4),
    "kv_int8": dict(kv_int8=True),
    "one_kv_head": dict(config=dict(CONFIG, num_key_value_heads=1)),
}
INIT_CASES = {"init_float": None, "init_int8": 8, "init_int4": 4}
# name: (preset, checkpoint writer or None for random init)
ADAPTER_CASES = {"llava-tiny": ("llava-tiny", None), "internvl2-tiny": ("internvl2-tiny", None),
                 "qwen2-vl-tiny": ("qwen2-vl-tiny", None), "llava-tiny-checkpoint": ("llava-tiny", "llava"),
                 "internvl2-tiny-checkpoint": ("internvl2-tiny", "internvl2")}


def _write_checkpoint(family: str, path: Path) -> Path:
    """A tiny HF checkpoint of ``family`` with a tokenizer, as the family's own tests write it."""
    path.mkdir()
    if family == "llava":
        from tests.test_torch_llava import _write_llava_checkpoint

        return _write_llava_checkpoint(path)
    from tests.test_checkpoint_matrix import _build_internvl2

    _build_internvl2(path)
    return path


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case through one pair of gloo ranks; returns (results, trees)."""
    from tests.test_torch_judge import write_llama_checkpoint

    work = tmp_path_factory.mktemp("torch_tp")
    trees, cases = {}, {}
    for name, spec in DECODER_CASES.items():
        config = spec.get("config", CONFIG)
        trees[name] = _tree(config, spec.get("bits"))
        cases[name] = dict(kind="decoder", config=config, tree=trees[name], w8a8=spec.get("w8a8", False),
                           kv_int8=spec.get("kv_int8", False))
    for name, bits in INIT_CASES.items():
        cases[name] = dict(kind="init", config=CONFIG, bits=bits)
    for name, (preset, writer) in ADAPTER_CASES.items():
        kwargs = {}
        if writer is not None:
            kwargs["pretrained"] = str(_write_checkpoint(writer, work / name))
        cases[name] = dict(kind="adapter", model=preset, kwargs=kwargs)
    cases["judge"] = dict(kind="judge", path=str(write_llama_checkpoint(work / "judge")), batch_size=8)
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    port = str(_free_port())
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.path.expanduser("~"),
           "PYTHONPATH": str(REPO), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "WORLD_SIZE": "2",
           "OMP_NUM_THREADS": "2", "LMMS_OWC_TPU_LOG_LEVEL": "WARNING"}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_tp_worker.py"), str(work / "cases.pkl"),
                               str(work / "out.pkl")], cwd=REPO, env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(work / "out.pkl", "rb") as f:
        return pickle.load(f), trees


@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_sharded_decoder_matches_whole_and_jax(two_ranks, case):
    results, trees = two_ranks
    r = results[case]
    np.testing.assert_allclose(r["sharded"]["logits"], r["whole"]["logits"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(r["sharded"]["tokens"], r["whole"]["tokens"])
    np.testing.assert_allclose(r["sharded"]["vision"], r["whole"]["vision"], rtol=TOL, atol=TOL)
    spec = DECODER_CASES[case]
    config = spec.get("config", CONFIG)
    want = _jax_mesh_logits(trees[case], config, spec.get("w8a8", False))
    if spec.get("w8a8"):
        # The row-parallel W8A8 product is the unsharded one, bit for bit. Against
        # JAX, the per-token quantizer turns a last-bit difference upstream of it
        # into one step of its grid (the unsharded port already differs from JAX
        # by 2e-2 on the left-padded row): the argmax of every row, within W8A8_TOL.
        np.testing.assert_array_equal(r["sharded"]["logits"], r["whole"]["logits"])
        np.testing.assert_array_equal(r["sharded"]["logits"].argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(r["sharded"]["logits"], want, rtol=0, atol=W8A8_TOL)
    elif spec.get("bits") == 4:
        # The int4 head's logits are rounded to bf16 in both packages' head
        # (``dense`` on bf16 x); XLA on the CPU keeps them in f32 (excess
        # precision), so against JAX they agree within one bf16 step.
        np.testing.assert_allclose(r["sharded"]["logits"], want, rtol=BF16_STEP, atol=TOL)
    else:
        np.testing.assert_allclose(r["sharded"]["logits"], want, rtol=TOL, atol=TOL)
    # Each rank holds half of every column- and row-parallel weight, and its KV heads.
    shapes = r["shapes"]
    leaf = {8: "q", 4: "q4"}.get(spec.get("bits"), "weight")
    per = 1 if spec.get("bits") != 4 else 2
    assert shapes[f"up.{leaf}"][0] == config["intermediate_size"] // 2
    assert shapes[f"down.inner.{leaf}"][1] == config["intermediate_size"] // 2 // per
    assert shapes["embed_tokens"][0] == config["vocab_size"] // 2
    assert r["kv_heads"] == max(1, config["num_key_value_heads"] // 2)
    assert len(set(np.asarray(r["sharded"]["tokens"]).ravel())) > 1


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_sharded_random_init_holds_the_whole_weights(two_ranks, case):
    r = two_ranks[0][case]
    np.testing.assert_allclose(r["sharded"]["logits"], r["whole"]["logits"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(r["sharded"]["tokens"], r["whole"]["tokens"])
    assert r["shapes"]["embed_tokens"][0] == CONFIG["vocab_size"] // 2


@pytest.mark.parametrize("case", list(ADAPTER_CASES))
def test_adapter_model_parallel_matches_unsharded(two_ranks, case):
    r = two_ranks[0][case]
    assert r["sharded"] == r["whole"] and all(r["whole"])
    assert r["sharded_up"][0] * 2 == r["whole_up"][0]
    assert r["sharded_rank"] == (0, 1, 0)  # data coordinate, data size, model coordinate of rank 0


def test_judge_data_parallel_matches_one_rank(two_ranks):
    r = two_ranks[0]["judge"]
    assert (r["one_ranks"], r["data_parallel_ranks"]) == (1, 2)
    assert r["data_parallel"] == r["one"] and len(r["one"]) == 11

"""One rank of the gloo group that ``tests/test_torch_parallel.py`` starts.

Run as ``python tests/torch_tp_worker.py CASES OUT`` with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set. ``CASES`` is a pickle
of ``{name: case}``; every rank runs every case in order (the model group's
collectives then come in one sequence) and rank 0 pickles ``{name: result}``
to ``OUT``. Imports torch and the port only.
"""

import datetime
import os
import pickle
import sys

import numpy as np
import torch

from lmms_owc_tpu_torch import no_tf32
from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
from lmms_owc_tpu_torch.nn.layers import set_int8_activations
from lmms_owc_tpu_torch.ops import quant
from lmms_owc_tpu_torch.parallel.mesh import ModelGroup
from lmms_owc_tpu_torch.parallel.sharding import Sharder, shard_model


def _inputs(config, seed: int = 0):
    rng = np.random.RandomState(seed)
    b, length = 3, 16
    embeds = torch.from_numpy(rng.randn(b, length, config.hidden_size).astype(np.float32) * 0.5)
    pos = torch.arange(length)[None, None].expand(3, b, length).contiguous()
    mask = torch.ones(b, length, dtype=torch.int32)
    mask[0, :5] = 0
    patches = torch.from_numpy(rng.randn(2, 16, config.vision.patch_dim).astype(np.float32))
    return embeds, pos, mask, patches


def _run_decoder(model, config) -> dict:
    """Prefill logits, greedy tokens and the tower's output of ``model``."""
    embeds, pos, mask, patches = _inputs(config)
    logits, _ = qvl.prefill(model, embeds, pos, mask, 24)
    length = embeds.shape[1]
    tokens = qvl.greedy_generate(model, embeds, pos, mask, torch.full((3,), length), 6, length + 8,
                                 torch.tensor([config.vocab_size - 1]))
    freqs = torch.zeros(2, 16, config.vision.head_dim // 2)
    return {"logits": logits.numpy(), "tokens": tokens.numpy(), "vision": model.vision(patches, freqs, None).numpy()}


def _shapes(model) -> dict:
    layer = model.layers[0]
    return {name: tuple(t.shape) for name, t in
            [*layer.named_parameters(), *layer.named_buffers(), ("embed_tokens", model.embed_tokens)]}


def decoder_case(case: dict, group: ModelGroup) -> dict:
    """The JAX tree ``case["tree"]`` in the port, whole and sharded by ``shard_model``."""
    config = qvl.Qwen2VLConfig.from_hf_dict(case["config"])
    set_int8_activations(case.get("w8a8", False))
    os.environ["LMMS_OWC_KV_INT8"] = "force" if case.get("kv_int8") else ""
    out = {}
    for tag in ("whole", "sharded"):
        model = qvl.params_from_jax(qvl.Qwen2VLModel(config, torch.float32, "cpu"), case["tree"])
        if tag == "sharded":
            shard_model(model, group)
            out["shapes"] = _shapes(model)
            out["kv_heads"] = model.kv_heads
        out[tag] = _run_decoder(model, config)
    set_int8_activations(False)
    os.environ["LMMS_OWC_KV_INT8"] = ""
    return out


def init_case(case: dict, group: ModelGroup) -> dict:
    """Random init from one seed, whole and through the shard hook of the walk."""
    config = qvl.Qwen2VLConfig.from_hf_dict(case["config"])
    bits = case.get("bits")
    out = {}
    for tag in ("whole", "sharded"):
        model = qvl.Qwen2VLModel(config, torch.float32, "meta")
        shard = Sharder(model, group, int4=bits == 4) if tag == "sharded" else None
        gen = torch.Generator().manual_seed(3)
        if bits:
            quant.init_quantized_on_device(model, gen, bits=bits, dtype=torch.float32, after=shard)
        else:
            qvl.init_params(model, gen, shard)
        out[tag] = _run_decoder(model, config)
        if shard is not None:
            out["shapes"] = _shapes(model)
    return out


def adapter_case(case: dict, group: ModelGroup) -> dict:
    """A registered adapter, whole and with ``model_parallel`` over every rank."""
    from PIL import Image

    from lmms_owc_tpu_torch.models import get_model

    rng = np.random.RandomState(0)
    docs = [{"image": Image.fromarray(rng.randint(0, 255, (hw, 40, 3), dtype=np.uint8))} for hw in (40, 56, 28)]

    class _Task:
        dataset = {"test": docs}

    class _Req:
        def __init__(self, doc_id, prompt):
            self.args = (prompt, {"max_new_tokens": 8, "do_sample": False, "until": None},
                         lambda doc: [doc["image"]], doc_id, "smoke", "test")

    requests = [_Req(i, p) for i, p in enumerate(["What is this?", "Name the object in the photo.", "Colour?"])]
    out = {}
    for tag, mp in (("whole", 1), ("sharded", group.size)):
        model = get_model(case["model"], dtype="float32", device="cpu", batch_size=2, model_parallel=mp,
                          **case.get("kwargs", {}))
        model.task_dict["smoke"] = _Task()
        out[tag] = model.generate_until(requests)
        text = model.model.text if hasattr(model.model, "text") else model.model
        out[f"{tag}_up"] = tuple(text.layers[0].up.weight.shape)
        out[f"{tag}_rank"] = (model.rank, model.world_size, model.model_rank)
    return out


def judge_case(case: dict, group: ModelGroup) -> dict:
    from lmms_owc_tpu_torch.nn.judge import JudgeModel

    prompts = [f"judge w{i} better a b tie score" for i in range(11)]
    out = {}
    for tag, dp in (("one", False), ("data_parallel", True)):
        judge = JudgeModel.from_pretrained(case["path"], dtype=torch.float32, device="cpu", data_parallel=dp)
        judge.batch_size = case.get("batch_size", 64)
        out[f"{tag}_ranks"] = judge.ranks
        out[tag] = judge.score_pairs(prompts, None, None)
    return out


KINDS = {"decoder": decoder_case, "init": init_case, "adapter": adapter_case, "judge": judge_case}


def main(cases_path: str, out_path: str) -> None:
    no_tf32()
    torch.distributed.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    group = ModelGroup(None, rank, world)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    results = {name: KINDS[case["kind"]](case, group) for name, case in cases.items()}
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])

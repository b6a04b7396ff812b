"""The port's model registry against the JAX package's.

Every name the JAX registry holds is registered in the port, and
``custom-model`` dispatches an arbitrary checkpoint to the adapter of its
``model_type`` as the JAX one does: the same five families (and Kimi-VL,
which only the port has), the same error for an unknown type, and, for ``model_type=llava`` on the tiny LLaVA
checkpoint of ``tests/test_torch_llava.py`` (the one of
``tests/test_checkpoint_matrix.py`` has a pad id of 0, which the LLaVA
adapters read as 32001, past its 512-token vocabulary: the port refuses it),
the tokens of ``llava-tiny`` built from the same directory. Every family's
``PRESET_CONFIGS`` holds the JAX adapter's presets, name for name and value
for value (the port lacked ``qwen2-vl-flagship-dryrun`` until it took the
tensor-parallel dry run).
"""

import numpy as np
import pytest
import torch

from lmms_owc_tpu import models as jax_models
from lmms_owc_tpu_torch import models
from lmms_owc_tpu_torch.models import MODELS, get_model
from lmms_owc_tpu_torch.models.llava_hf import LlavaHf
from tests.test_torch_llava import _write_llava_checkpoint
from tests.test_torch_onevision import _Req, _Task


def test_port_registers_every_jax_name():
    assert sorted(set(jax_models.MODELS) - set(MODELS)) == []
    assert {"custom-model", "phi3v", "phi3v-tiny"} <= set(MODELS)


@pytest.mark.parametrize("family", ["qwen2_vl", "llava_hf", "llava_onevision", "idefics2", "internvl2",
                                    "instructblip", "phi3v"])
def test_presets_match_jax(family):
    import importlib

    want = importlib.import_module(f"lmms_owc_tpu.models.{family}").PRESET_CONFIGS
    got = importlib.import_module(f"lmms_owc_tpu_torch.models.{family}").PRESET_CONFIGS
    assert sorted(got) == sorted(want)
    assert {name: got[name] for name in want} == want


def test_custom_model_families_match_jax():
    """The JAX package's five families, and Kimi-VL, which only the port has."""
    got, want = models._model_types(), jax_models._model_types()
    assert sorted(want) == ["idefics2", "instructblip", "internvl2", "llava", "qwen2-vl"]
    assert sorted(got) == sorted([*want, "kimi_vl"])
    assert {k: v.__name__ for k, v in got.items() if k in want} == {k: v.__name__ for k, v in want.items()}
    assert all(cls.__module__.startswith("lmms_owc_tpu_torch.models.") for cls in got.values())


def test_custom_model_dispatch_error():
    with pytest.raises(ValueError, match="not found") as got:
        get_model("custom-model", model_type="nonexistent", model_name_or_path="/x")
    with pytest.raises(ValueError, match="not found") as want:
        jax_models.get_model("custom-model", model_type="nonexistent", model_name_or_path="/x")
    # The same message, naming the port's families (Kimi-VL's too).
    families = str(sorted(jax_models._model_types())), str(sorted(models._model_types()))
    assert "'kimi_vl'" in str(got.value) and str(got.value) == str(want.value).replace(*families)


def test_custom_model_llava_serves_the_checkpoint(tmp_path, monkeypatch):
    """``--model custom-model --model_args model_type=llava,model_name_or_path=DIR``:
    a LLaVA adapter over the checkpoint, with the tokens of ``llava-tiny``
    loaded from the same directory."""
    _write_llava_checkpoint(tmp_path)
    custom = get_model("custom-model", model_type="llava", model_name_or_path=str(tmp_path), batch_size=2,
                       dtype="float32", device="cpu")
    tiny = get_model("llava-tiny", pretrained=str(tmp_path), batch_size=2, dtype="float32", device="cpu")
    assert isinstance(custom, LlavaHf) and custom.pretrained == str(tmp_path)
    rng = np.random.RandomState(0)
    from PIL import Image

    docs = [{"images": [Image.fromarray(rng.randint(0, 255, (30, 40, 3), dtype=np.uint8))]} for _ in range(2)]
    gen = {"max_new_tokens": 6, "do_sample": False, "until": None}
    requests = [_Req(("What is this?", gen, lambda d: d["images"], i, "smoke", "test")) for i in range(2)]
    tokens = {}
    for name, model in (("custom", custom), ("tiny", tiny)):
        model.task_dict["smoke"] = _Task(docs)
        seen = []
        detok = model._detokenize
        monkeypatch.setattr(model, "_detokenize", lambda t, _seen=seen, _d=detok: _seen.append(t.copy()) or _d(t))
        model.generate_until(requests)
        tokens[name] = np.concatenate(seen)
    np.testing.assert_array_equal(tokens["custom"], tokens["tiny"])
    for a, b in zip(custom.model.parameters(), tiny.model.parameters()):
        assert torch.equal(a, b)

"""The adapters' seed under both of its names.

The JAX adapters take ``jax_random_seed`` (``lmms_owc_tpu/models/*.py``) and
the JAX evaluator sets it only where ``--model_args`` did not; the port's
adapters call it ``torch_random_seed``. Either name seeds a port adapter's
``torch.Generator`` alike, at every tiny preset of the registry on the CPU:
the same random weights under ``jax_random_seed=7`` as under
``torch_random_seed=7`` and other weights than the default seed's; two
different values under the two names raise; and ``--model_args
...,jax_random_seed=7`` on the port's CLI reaches the adapter's generator,
over the evaluator's third ``--seed`` value.
"""

import pytest
import torch

from lmms_owc_tpu_torch.engine import evaluator
from lmms_owc_tpu_torch.models import get_model
from lmms_owc_tpu_torch.models._base import DEFAULT_SEED
from tests.test_torch_cli import TASKS

# One tiny preset per adapter family the registry holds.
TINY = ("qwen2-vl-tiny", "qwen2.5-vl-tiny", "llava-tiny", "llava-onevision-tiny", "idefics2-tiny",
        "internvl2-tiny", "instructblip-tiny", "phi3v-tiny")


def _build(name: str, **seed):
    return get_model(name, device="cpu", dtype="float32", **seed)


def _weights(model) -> list[torch.Tensor]:
    return [p.detach().clone() for p in model.model.parameters()]


def _same(a: list[torch.Tensor], b: list[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", TINY)
def test_jax_seed_draws_the_torch_seeds_weights(name):
    by_jax, by_torch, default = _build(name, jax_random_seed=7), _build(name, torch_random_seed=7), _build(name)
    assert by_jax.torch_random_seed == by_torch.torch_random_seed == 7 and default.torch_random_seed == DEFAULT_SEED
    assert by_jax.generator.initial_seed() == 7
    assert _same(_weights(by_jax), _weights(by_torch))
    assert not _same(_weights(by_jax), _weights(default))


@pytest.mark.parametrize("name", TINY)
def test_conflicting_seeds_raise(name):
    with pytest.raises(ValueError, match="one seed"):
        _build(name, jax_random_seed=7, torch_random_seed=8)
    assert _build(name, jax_random_seed=7, torch_random_seed=7).torch_random_seed == 7


@pytest.mark.parametrize("name", ["fake", *TINY])
def test_cli_model_args_jax_seed_reaches_the_generator(name, tmp_path, toy_dataset, monkeypatch):
    """A one-document CLI run: ``jax_random_seed=7`` in ``--model_args`` wins
    over the third ``--seed`` value (1234) and seeds the adapter."""
    from lmms_owc_tpu_torch.eval_model import main

    built = []

    def spy(model_name, **kwargs):
        built.append(get_model(model_name, **kwargs))
        return built[-1]

    monkeypatch.setattr(evaluator, "get_model", spy)
    model_args = "response_mode=target" if name == "fake" else "dtype=float32,device=cpu"
    (results,) = main(["--model", name, "--model_args", f"{model_args},jax_random_seed=7", "--tasks", "toy",
                       "--include_path", TASKS, "--limit", "1", "--output_path", str(tmp_path),
                       "--seed", "0,1234,1234,1234"])
    (model,) = built
    assert model.torch_random_seed == 7 and results["config"]["torch_seed"] == 1234
    if name != "fake":
        assert model.generator.initial_seed() == 7

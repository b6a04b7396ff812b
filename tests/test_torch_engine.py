"""The port's evaluation layers against the JAX package's, module by module.

Same inputs, made from a seed, go through both packages' filters, instance
metrics, aggregations (with their stderr), samplers, task index, request
building and tracker; the outputs must be equal. The registries hold the same
names. The four aggregations that need a scoring model equal the JAX
package's through the fallback scorers.
"""

import json
import random
import re
from functools import partial

import numpy as np
import pytest

from lmms_owc_tpu import filters as jax_filters
from lmms_owc_tpu import metrics as jax_metrics
from lmms_owc_tpu import samplers as jax_samplers
from lmms_owc_tpu.engine import EngineTracker as JaxTracker
from lmms_owc_tpu.models import MODELS as JAX_MODELS
from lmms_owc_tpu.tasks import TaskManager as JaxTaskManager
from lmms_owc_tpu.tasks import get_tasks_as_dict as jax_tasks_as_dict
from lmms_owc_tpu_torch import filters, metrics, samplers
from lmms_owc_tpu_torch.engine import EngineTracker
from lmms_owc_tpu_torch.models import MODELS
from lmms_owc_tpu_torch.tasks import TaskManager, get_tasks_as_dict

SCORING_MODEL_AGGREGATIONS = (
    "concept_semantic_similarity", "mean_average_semantic_similarity", "semantic_similarity",
    "textual_inclusion_llama32",
)
TOY_TASKS = ("toy", "toy_mc", "toy_multiround", "toy_semantic")
WORDS = ["red panda", "blue jay", "cat", "Dog", "#### 42", "#### -3.5", "(B)", "Answer: C", "  spaced  ", "a, b $"]


def _text(rng: random.Random) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(rng.randint(1, 4)))


# -------------------------------------------------------------- registries


def test_registries_match_jax():
    assert sorted(filters.FILTERS) == sorted(jax_filters.FILTERS)
    assert sorted(metrics.METRICS) == sorted(jax_metrics.METRICS)
    assert sorted(metrics.AGGREGATIONS) == sorted(jax_metrics.AGGREGATIONS)
    assert sorted(samplers.SAMPLERS) == sorted(jax_samplers.SAMPLERS)
    assert {"fake", "fake-echo"} <= set(MODELS) & set(JAX_MODELS)
    for name, info in metrics.METRICS.items():
        ref = jax_metrics.METRICS[name]
        got = (info.group_fn_name, info.higher_is_better, info.output_types, info.can_bootstrap)
        assert got == (ref.group_fn_name, ref.higher_is_better, ref.output_types, ref.can_bootstrap), name
    for name, info in metrics.AGGREGATIONS.items():
        assert info.can_bootstrap == jax_metrics.AGGREGATIONS[name].can_bootstrap, name
    assert metrics.DEFAULT_METRICS_PER_OUTPUT_TYPE == jax_metrics.DEFAULT_METRICS_PER_OUTPUT_TYPE


# ------------------------------------------------------------------ filters


FILTER_KWARGS = {
    "regex": [{}, {"regex_pattern": r"(\d+)", "group_select": -1, "fallback": "none"}],
    "multi_choice_regex": [{"regex_pattern": r"\(([A-D])\)", "ignore_case": True, "ignore_punctuation": True,
                            "regexes_to_ignore": [","]}],
    "take_first_k": [{"k": 2}],
}


@pytest.mark.parametrize("name", sorted(jax_filters.FILTERS))
def test_filter_matches_jax(name):
    rng = random.Random(sum(map(ord, name)))
    responses = [[_text(rng) for _ in range(3)] for _ in range(16)]
    docs = [{"choices": ["red panda", "blue jay", "cat", "dog"]} for _ in responses]
    for kwargs in FILTER_KWARGS.get(name, [{}]):
        got = list(filters.get_filter(name)(**kwargs).apply(responses, docs))
        want = list(jax_filters.get_filter(name)(**kwargs).apply(responses, docs))
        assert got == want, (name, kwargs)


def test_filter_ensemble_matches_jax():
    class Inst:
        def __init__(self, resps):
            self.resps, self.filtered_resps = resps, {}

    rng = random.Random(5)
    resps = [[_text(rng), _text(rng)] for _ in range(8)]
    components = [("lowercase", None), ("regex", {"regex_pattern": r"(\w+)"}), ("take_first", None)]
    port, ref = [Inst(r) for r in resps], [Inst(r) for r in resps]
    filters.get_filters_ensemble("chain", components).apply(port, None)
    jax_filters.get_filters_ensemble("chain", components).apply(ref, None)
    assert [i.filtered_resps for i in port] == [i.filtered_resps for i in ref]


# ------------------------------------------------------------------ metrics


def _metric_inputs(name: str, rng: random.Random) -> list[tuple[tuple, dict]]:
    """(args, kwargs) calls of one instance metric."""
    preds, refs = [_text(rng) for _ in range(6)], [_text(rng) for _ in range(6)]
    refs[0] = preds[0]
    if name == "exact_match":
        return [((), dict(predictions=preds, references=refs)),
                ((), dict(predictions=preds, references=refs, regexes_to_ignore=[",", r"\$"], ignore_case=True,
                          ignore_punctuation=True, ignore_numbers=True))]
    if name == "textual_inclusion":
        return [((), dict(predictions=preds, references=refs))]
    if name == "anls":
        return [((), dict(references=refs[:3], predictions=[preds[0]])),
                ((), dict(references=["cat"], predictions=["cats"], threshold=0.1))]
    if name == "acc_all":
        items = [(rng.random() > 0.5, {"idx": {"paragraph": i // 4, "question": i // 2}, "label": rng.randint(0, 1)})
                 for i in range(16)]
        return [((items,), {})]
    return [(([(rng.random(), rng.randint(0, 3)) for _ in range(5)],), {})]


@pytest.mark.parametrize("name", sorted(jax_metrics.METRICS))
def test_instance_metric_matches_jax(name):
    for args, kwargs in _metric_inputs(name, random.Random(len(name))):
        got = metrics.get_metric_builder(name)(*args, **kwargs)
        want = jax_metrics.get_metric_builder(name)(*args, **kwargs)
        assert got == want, name


def _aggregation_items(name: str, rng: np.random.RandomState) -> list:
    n = 24
    if name in ("bits_per_byte", "weighted_perplexity"):
        return [(float(-rng.rand() * 5), int(rng.randint(1, 40))) for _ in range(n)]
    if name in ("bleu", "chrf", "ter"):
        r = random.Random(int(rng.randint(1 << 30)))
        return [(_text(r), _text(r)) for _ in range(n)]
    if name == "brier_score":
        probs = rng.dirichlet(np.ones(4), size=n)
        return [(int(rng.randint(4)), p.tolist()) for p in probs]
    if name == "f1":
        return [(int(rng.randint(2)), int(rng.randint(2))) for _ in range(n)]
    if name == "matthews_corrcoef":
        return [(int(rng.randint(4)), int(rng.randint(4))) for _ in range(n)]
    if name == "perplexity":
        return (-rng.rand(n) * 4).tolist()
    return rng.rand(n).tolist()


@pytest.mark.parametrize("name", sorted(set(jax_metrics.AGGREGATIONS) - set(SCORING_MODEL_AGGREGATIONS)))
def test_aggregation_matches_jax(name):
    items = _aggregation_items(name, np.random.RandomState(len(name)))
    port_fn, jax_fn = metrics.get_aggregation_builder(name), jax_metrics.get_aggregation_builder(name)
    assert port_fn(items) == pytest.approx(jax_fn(items), rel=1e-12, abs=1e-12)
    port_err = metrics.get_metric_stderr_builder(port_fn, bootstrap_iters=50)
    jax_err = jax_metrics.get_metric_stderr_builder(jax_fn, bootstrap_iters=50)
    assert (port_err is None) == (jax_err is None)
    if port_err is not None:
        assert port_err(items) == pytest.approx(jax_err(items), rel=1e-12)


@pytest.mark.parametrize("labels", [[0, 0, 0], [1, 1, 0], [0, 0, 1, 1]])
def test_f1_and_mcc_edge_cases_match_jax(labels):
    """Single-class and all-wrong inputs, where scikit-learn's definitions take their special cases."""
    for golds, preds in ((labels, labels), (labels, [1 - x for x in labels])):
        items = list(zip(golds, preds))
        for name in ("f1", "matthews_corrcoef"):
            got = metrics.get_aggregation_builder(name)(items)
            assert got == pytest.approx(jax_metrics.get_aggregation_builder(name)(items), abs=1e-12), (name, items)


@pytest.fixture
def fallback_scoring(monkeypatch):
    """Both packages' scoring singletons reset, no checkpoint paths: the hashed
    encoder and the heuristic judge score (unless a model is in the local
    Hugging Face cache, which both then load, the port on the CPU)."""
    from lmms_owc_tpu.pipelines import text as jax_text
    from lmms_owc_tpu_torch.pipelines import text as port_text

    for var in ("LMMS_OWC_SBERT_PATH", "LMMS_OWC_JUDGE_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LMMS_OWC_SCORING_DEVICE", "cpu")
    for mod in (jax_text, port_text):
        monkeypatch.setattr(mod, "_sentence_encoder", None)
        monkeypatch.setattr(mod, "_judge", None)


@pytest.mark.parametrize("name", SCORING_MODEL_AGGREGATIONS)
def test_scoring_model_aggregations_raise(name, fallback_scoring):
    """The four scoring-model aggregations (which raised before the scoring
    pipelines were ported) equal the JAX package's on seeded items, reduced and
    per sample, through the fallback scorers."""
    rng = random.Random(len(name))
    items = [(_text(rng), [_text(rng)]) for _ in range(24)] + [("cat", ["a cat"]), ("Dog", ["red panda and a dog"])]
    reduces = {"concept_semantic_similarity": ("max", "mean", "median", "min", "none")}.get(name, ("mean", "none"))
    for reduce in reduces:
        got = metrics.get_aggregation_builder(name)(items, reduce=reduce)
        want = jax_metrics.get_aggregation_builder(name)(items, reduce=reduce)
        assert json.dumps(got) == json.dumps(want), (name, reduce)


# --------------------------------------------------------------- tasks


@pytest.fixture(scope="module")
def task_pairs(toy_dataset, toy_task_path):
    """Each toy task built by both packages' TaskManagers."""
    port = get_tasks_as_dict(list(TOY_TASKS), TaskManager(include_path=toy_task_path, model_name="fake"))
    ref = jax_tasks_as_dict(list(TOY_TASKS), JaxTaskManager(include_path=toy_task_path, model_name="fake"))
    return {name: (port[name], ref[name]) for name in TOY_TASKS}


def test_task_index_matches_jax(toy_task_path):
    port = TaskManager(include_path=toy_task_path, include_defaults=False)
    ref = JaxTaskManager(include_path=toy_task_path, include_defaults=False)
    assert port.task_index == ref.task_index
    assert (port.all_tasks, port.all_subtasks, port.all_tags) == (ref.all_tasks, ref.all_subtasks, ref.all_tags)
    assert port.list_all_tasks() == ref.list_all_tasks()
    # The port's default directory is its own: nothing of the JAX package's configs.
    default = TaskManager(include_path=toy_task_path)
    assert default.task_index == port.task_index
    assert not any("lmms_owc_tpu/" in str(v["yaml_path"]) for v in default.task_index.values())


def _same_value(got, want, doc) -> None:
    if callable(want):
        assert callable(got)
        name = getattr(getattr(want, "func", want), "__name__", None)
        assert getattr(getattr(got, "func", got), "__name__", None) == name
        if name == "doc_to_visual":
            g, w = got(doc), want(doc)
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        elif name == "doc_to_target":
            assert got(doc) == want(doc)
        if isinstance(want, partial):
            assert got.keywords == want.keywords
    else:
        assert got == want


@pytest.mark.parametrize("name", TOY_TASKS)
def test_task_instances_match_jax(task_pairs, name):
    port, ref = task_pairs[name]
    assert port.dump_config().keys() == ref.dump_config().keys()
    for task in (port, ref):
        task.build_all_requests(limit=5, rank=0, world_size=1)
    assert len(port.instances) == len(ref.instances) > 0
    for got, want in zip(port.instances, ref.instances):
        assert (got.request_type, got.idx, got.metadata, got.doc_id, got.repeats) == (
            want.request_type, want.idx, want.metadata, want.doc_id, want.repeats)
        doc = ref.dataset[want.metadata["split"]][want.doc_id]
        assert len(got.args) == len(want.args)
        for a, b in zip(got.args, want.args):
            _same_value(a, b, doc)
    assert port.doc_to_target(port.eval_docs[3]) == ref.doc_to_target(ref.eval_docs[3])
    assert list(port.eval_docs_no_media[0]) == list(ref.eval_docs_no_media[0])


@pytest.mark.parametrize("sampler", sorted(jax_samplers.SAMPLERS))
@pytest.mark.parametrize("multiturn", [False, True])
def test_samplers_match_jax(task_pairs, sampler, multiturn):
    port, ref = task_pairs["toy_mc"]
    outs = []
    for task, package in ((port, samplers), (ref, jax_samplers)):
        docs = list(task.dataset_no_image["test"])
        s = package.get_sampler_builder(sampler)(docs, task, rnd=random.Random(7))
        outs.append([s.get_context(docs[i], 3) for i in range(4)]
                    + [s.get_chat_context(docs[i], 2, multiturn) for i in range(4)])
    assert outs[0] == outs[1]


def test_fewshot_prompts_match_jax(toy_dataset, toy_task_path):
    """Few-shot contexts through the default sampler, seeded as the CLI seeds them."""
    built = []
    for manager, as_dict in ((TaskManager, get_tasks_as_dict), (JaxTaskManager, jax_tasks_as_dict)):
        task = as_dict(["toy"], manager(include_path=toy_task_path))["toy"]
        task.set_config(key="num_fewshot", value=2)
        task.set_fewshot_seed(seed=1234)
        task.build_all_requests(limit=4, rank=0, world_size=1)
        built.append([inst.args[0] for inst in task.instances])
    assert built[0] == built[1] and "\n\n" in built[0][0]


# ---------------------------------------------------------------- tracker


def test_tracker_matches_jax(tmp_path):
    results = {
        "results": {"toy": {"alias": "toy", "exact_match,none": 0.5, "exact_match_stderr,none": 0.1}},
        "configs": {"toy": {"task": "toy", "output_type": "generate_until"}},
        "versions": {"toy": "Yaml"}, "n-shot": {"toy": 0}, "higher_is_better": {"toy": {"exact_match": True}},
        "n-samples": {"toy": {"original": 12, "effective": 2}}, "config": {"model": "fake"},
        "timings": {"build_requests": 0.1, "inference": {}, "scoring": 0.0},
    }
    samples = {"toy": [{"doc_id": i, "doc": {"class_name": "cat"}, "target": "cat", "arguments": ["q"],
                        "resps": [["a cat"]], "filtered_resps": ["a cat"], "exact_match": 1.0, "doc_hash": f"d{i}",
                        "prompt_hash": "p", "target_hash": "t"} for i in range(2)]}
    trees = {}
    for name, cls in (("port", EngineTracker), ("jax", JaxTracker)):
        out = tmp_path / name
        tracker = cls(output_path=str(out))
        tracker.general_config_tracker.log_experiment_args(
            model_source="fake", model_args="pretrained=fake-x,response_mode=target", system_instruction=None,
            chat_template=None, fewshot_as_multiturn=False)
        own = json.loads(json.dumps(samples))  # the tracker rewrites the samples it saves
        tracker.save_results_aggregated(results=json.loads(json.dumps(results)), samples=own,
                                        datetime_str="20260101_000000")
        tracker.save_results_samples(task_name="toy", samples=own["toy"])
        files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
        saved = json.loads(next(out.rglob("*_results.json")).read_text())
        lines = [json.loads(x) for x in next(out.rglob("*_samples_toy.jsonl")).read_text().splitlines()]
        for key in ("start_time", "end_time", "total_evaluation_time_seconds"):
            saved.pop(key)
        trees[name] = (files, saved, lines)
    assert trees["port"] == trees["jax"]
    assert re.match(r"fake-x/20260101_000000_results\.json", trees["port"][0][0])

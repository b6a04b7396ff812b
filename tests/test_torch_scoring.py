"""The port's scoring pipelines, the four scoring aggregations and the offline
CLIs (``eval_metrics``, ``eval_ranking``) against the JAX package's.

Through the tiny checkpoints of ``tests/test_torch_sbert.py`` and
``tests/test_torch_judge.py``, named by ``LMMS_OWC_SBERT_PATH`` and
``LMMS_OWC_JUDGE_PATH`` (the port's models on the CPU through
``LMMS_OWC_SCORING_DEVICE``), and through the fallback scorers: the four
aggregations equal the JAX package's on seeded items; ``eval_metrics`` prints
the same tables and writes the same columns back into the samples files;
``eval_ranking`` prints the same leaderboards under the same seed.
"""

import json
import random
import shutil
from argparse import Namespace
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import eval_metrics as jax_eval_metrics
import eval_ranking as jax_eval_ranking
from lmms_owc_tpu import metrics as jax_metrics
from lmms_owc_tpu.pipelines import text as jax_text
from lmms_owc_tpu_torch import eval_metrics, eval_ranking, metrics, no_tf32
from lmms_owc_tpu_torch.nn.judge import JudgeModel
from lmms_owc_tpu_torch.nn.sbert import SentenceEncoder
from lmms_owc_tpu_torch.pipelines import text
from tests.test_torch_judge import write_llama_checkpoint
from tests.test_torch_sbert import write_bert_checkpoint

AGGREGATIONS = ("concept_semantic_similarity", "mean_average_semantic_similarity", "semantic_similarity",
                "textual_inclusion_llama32")
WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "fast", "bird", "flew", "blue", "red", "sky", "grass",
         "over", "jumped", "lazy", "quick", "w3", "w7", "yes", "1", "0", "zebra!"]
TARGETS = ["cat", "red bird", "blue sky", "lazy dog"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory) -> dict[str, Path]:
    root = tmp_path_factory.mktemp("scoring_ckpts")
    (root / "bert").mkdir()
    (root / "llama").mkdir()
    return {"sbert": write_bert_checkpoint(root / "bert"), "judge": write_llama_checkpoint(root / "llama")}


@pytest.fixture(params=["fallbacks", "checkpoints"])
def scorers(request, monkeypatch, checkpoints):
    """Both packages' scoring singletons reset, the checkpoint paths set or not."""
    no_tf32()
    for var in ("LMMS_OWC_SBERT_PATH", "LMMS_OWC_JUDGE_PATH", "LMMS_OWC_JUDGE_DECODE_POOL", "LMMS_OWC_KV_INT8"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LMMS_OWC_SCORING_DEVICE", "cpu")
    if request.param == "checkpoints":
        monkeypatch.setenv("LMMS_OWC_SBERT_PATH", str(checkpoints["sbert"]))
        monkeypatch.setenv("LMMS_OWC_JUDGE_PATH", str(checkpoints["judge"]))
    for mod in (jax_text, text):
        monkeypatch.setattr(mod, "_sentence_encoder", None)
        monkeypatch.setattr(mod, "_judge", None)
    return request.param


def _sentence(rng: random.Random, lo: int = 1, hi: int = 6) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(rng.randint(lo, hi)))


def _close(got, want, path="") -> None:
    """Equal structure; floats within 1e-5 (embeddings differ by f32 rounding)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-5), path
    else:
        assert got == want, path


@pytest.mark.parametrize("name", AGGREGATIONS)
def test_aggregations_match_jax(scorers, name):
    rng = random.Random(7)
    items = [(rng.choice(TARGETS), [_sentence(rng)]) for _ in range(20)] + [("cat", ["a cat"]), ("sky", ["sky"])]
    reduces = {"concept_semantic_similarity": ("max", "mean", "median", "min", "none")}.get(name, ("mean", "none"))
    for reduce in reduces:
        got = metrics.get_aggregation_builder(name)(items, reduce=reduce)
        want = jax_metrics.get_aggregation_builder(name)(items, reduce=reduce)
        _close(got, want, f"{name}/{reduce}")
    if scorers == "checkpoints":
        assert isinstance(text._sentence_encoder, SentenceEncoder) or name == "textual_inclusion_llama32"
        assert isinstance(text._judge, JudgeModel) or name != "textual_inclusion_llama32"


def _samples(root: Path, seed: int) -> Path:
    """Samples files under ``root/{task}/{model}/``: two models on a
    single-round task, one on a multi-round task (nested responses)."""
    rng = random.Random(seed)
    for task, model, nested in (("toy", "model_a", False), ("toy", "model_b", False), ("toy_mr", "model_a", True)):
        rows = []
        for doc_id in range(10):
            resp = [_sentence(rng), _sentence(rng)] if nested else _sentence(rng)
            rows.append({"doc_id": doc_id, "target": TARGETS[doc_id % 4],
                         "filtered_resps": [resp] if nested else [resp], "resps": [[resp]]})
        path = root / task / model
        path.mkdir(parents=True)
        (path / f"2024_samples_{task}.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return root


def test_eval_metrics_matches_jax(scorers, tmp_path, capsys):
    """Same printed tables; same columns written back into every samples file."""
    port, ref = _samples(tmp_path / "port", 3), _samples(tmp_path / "jax", 3)
    names = ",".join(AGGREGATIONS) + ",textual_inclusion"
    got = eval_metrics.main(["-i", str(port), "-m", names])
    port_out = capsys.readouterr().out
    jax_eval_metrics.main(Namespace(input=str(ref), metrics=names, seed=1234, log_level="INFO"))
    jax_out = capsys.readouterr().out
    assert port_out == jax_out and "Semantic similarity on toy:" in port_out
    assert set(got) == {"toy", "toy_mr"} and set(got["toy"]) == {"model_a", "model_b"}
    for file in sorted(port.rglob("*.jsonl")):
        want = pd.read_json(ref / file.relative_to(port), lines=True)
        have = pd.read_json(file, lines=True)
        assert list(have.columns) == list(want.columns)
        assert {"concept_semantic_similarity", "last_resp_concepts", "semantic_similarity@0.5",
                "textual_inclusion_llama32"} <= set(have.columns)
        for column in want.columns:
            _close(json.loads(have[column].to_json(orient="values")), json.loads(want[column].to_json(orient="values")),
                   f"{file.name}:{column}")


@pytest.mark.parametrize("criterion", ["semantic_similarity", "llama_score"])
def test_eval_ranking_matches_jax(scorers, tmp_path, capsys, criterion):
    """Same leaderboards (online and bootstrapped) under the same seed."""
    root = _samples(tmp_path / "runs", 5)
    argv = ["-i", str(root), "-c", criterion, "-n", "64", "-b", "8"]
    got = eval_ranking.main(argv)
    port_out = capsys.readouterr().out
    args = eval_ranking.build_parser().parse_args(argv)
    jax_eval_ranking.main(args)
    assert port_out == capsys.readouterr().out
    assert "Final Elo ratings on toy:" in port_out and set(got) == {"toy"}
    assert set(got["toy"]["final"]) == {"model_a", "model_b"}


def test_cli_entry_points_parse_the_jax_flags():
    """Both CLIs take the JAX scripts' flags with the same defaults."""
    args = eval_ranking.build_parser().parse_args(["-i", "x", "-c", "llama_score"])
    assert (args.initial_rating, args.k_factor, args.num_rounds, args.num_samples, args.seed) == (1000, 16, 100, 10000, 1234)
    assert not args.disable_zero_sum
    args = eval_metrics.build_parser().parse_args(["-i", "x", "-m", "semantic_similarity"])
    assert (args.seed, args.log_level) == (1234, "INFO")
    assert eval_metrics.METRICS_TO_SAVE_INTERMEDIATE_VALUES == jax_eval_metrics.METRICS_TO_SAVE_INTERMEDIATE_VALUES


def test_concepts_without_spacy_model(monkeypatch):
    """Without spaCy's model the chunker runs and nothing is downloaded; with
    a stub model the spaCy branch runs, as in the JAX package."""
    texts = ["A red panda sat in the tree.", "The dog, and a blue jay!"]
    monkeypatch.setattr(text, "_spacy_model", None)
    want = jax_text._concepts_fallback(texts, ["the"], True)
    assert text.concept_extraction(texts, ["the"], True) == want

    class _Span:
        def __init__(self, t):
            self.text = t

    class _Doc:
        def __init__(self, t):
            words = t.split()
            self.noun_chunks = [_Span(" ".join(words[:2]))]
            self.ents = [_Span(words[-1])]

    class _Nlp:
        def pipe(self, texts, batch_size):
            return [_Doc(t) for t in texts]

    monkeypatch.setattr(text, "_spacy_model", _Nlp())
    monkeypatch.setattr(jax_text, "_spacy_model", _Nlp())
    assert text.concept_extraction(texts, [], True) == jax_text.concept_extraction(texts, [], True)
    assert text.concept_extraction(texts, [], True) == [["red", "tree."], ["dog,", "jay!"]]  # prefixes stripped
    np.testing.assert_array_equal(text.encode_sentence_bert([]), jax_text.encode_sentence_bert([]))


def test_cli_runs_as_a_module(tmp_path):
    """``python -m lmms_owc_tpu_torch.eval_metrics`` in a subprocess, on the fallbacks."""
    import os
    import subprocess
    import sys

    root = _samples(tmp_path, 9)
    env = {"PATH": "/usr/bin:/bin", "HOME": os.path.expanduser("~"), "LMMS_OWC_SCORING_DEVICE": "cpu"}
    proc = subprocess.run([sys.executable, "-m", "lmms_owc_tpu_torch.eval_metrics", "-i", str(root), "-m",
                           "semantic_similarity"], capture_output=True, text=True, timeout=300,
                          cwd=Path(__file__).resolve().parent.parent, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Semantic similarity on toy:" in proc.stdout
    shutil.rmtree(root)

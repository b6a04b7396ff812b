"""CLI: Elo-style pairwise model ranking from saved samples.

The JAX package's ``eval_ranking.py`` on the port, run as ``python -m
lmms_owc_tpu_torch.eval_ranking -i <runs> -c <criterion>``: sample n games
(random doc x random model pair), judge each with the Llama-3.2 triplet prompt
or SBERT similarity with a 0.05 draw threshold, run online Elo, and bootstrap
a final Elo as the median over ``--num-rounds`` shards. Defaults: rating 1000,
K=16, 10k games, 100 rounds, zero-sum on. Judging runs through
:mod:`lmms_owc_tpu_torch.pipelines` (on the card, or on the device
``LMMS_OWC_SCORING_DEVICE`` names).
"""

from __future__ import annotations

import os
import random
from argparse import ArgumentParser, Namespace
from collections import Counter
from itertools import combinations
from pathlib import Path

import numpy as np
import pandas as pd

from lmms_owc_tpu_torch import utils

log = utils.get_logger(__name__)


def _elo_rating(
    rating_a: float, rating_b: float, score_a: float, k_factor: int = 32, zero_sum: bool = False
) -> tuple[float, float]:
    """One Elo update; optional zero-sum adjustment to prevent pool inflation."""
    expected_a = 1 / (1 + 10 ** ((rating_b - rating_a) / 400))
    expected_b = 1 / (1 + 10 ** ((rating_a - rating_b) / 400))

    if zero_sum:
        change_a = k_factor * (score_a - expected_a)
        change_b = k_factor * ((1 - score_a) - expected_b)
        average_change = (change_a - change_b) / 2
        return rating_a + average_change, rating_b - average_change
    return (
        rating_a + k_factor * (score_a - expected_a),
        rating_b + k_factor * ((1 - score_a) - expected_b),
    )


def _sample_games(task_inputs: dict, n: int) -> list[dict]:
    """Sample n (random doc, random model pair) games."""
    player_names = list(task_inputs.keys())
    game_results = task_inputs[player_names[0]][["doc_id", "target"]]
    for model_name in task_inputs:
        right = task_inputs[model_name][["doc_id", "filtered_resps"]]
        right = right.rename(columns={"filtered_resps": model_name})
        game_results = pd.merge(game_results, right, how="left", on="doc_id")

    pairs = list(combinations(player_names, 2))
    games = []
    for _ in range(n):
        idx = random.sample(range(len(game_results)), 1)[0]
        players = random.sample(pairs, 1)[0]
        row = game_results.iloc[idx]

        def last_resp(value):
            return value[-1] if isinstance(value, (list, tuple)) else value

        games.append(
            dict(
                doc_id=row["doc_id"],
                player_a_name=players[0],
                player_a_response=last_resp(row[players[0]]),
                player_b_name=players[1],
                player_b_response=last_resp(row[players[1]]),
                reference=row["target"],
            )
        )
    return games


def _judge_games(games: list[dict], criterion: str) -> list[float]:
    """Score games: 1 = A wins, 0 = B wins, 0.5 = draw."""
    refs = [g["reference"] for g in games]
    a = [g["player_a_response"] for g in games]
    b = [g["player_b_response"] for g in games]

    if criterion == "llama_score":
        from lmms_owc_tpu_torch.pipelines.text import elo_score_llama32

        raw = elo_score_llama32(predictions_a=a, predictions_b=b, references=refs)
        return [int(s) if s in ["0", "1"] else 0.5 for s in raw]

    if criterion == "semantic_similarity":
        from lmms_owc_tpu_torch.pipelines.text import encode_sentence_bert

        refs_z = np.asarray(encode_sentence_bert(refs))
        a_z = np.asarray(encode_sentence_bert(a))
        b_z = np.asarray(encode_sentence_bert(b))
        diff = np.sum(refs_z * a_z, axis=-1) - np.sum(refs_z * b_z, axis=-1)
        threshold = 0.05
        scores = np.full(len(games), 0.5)
        scores[diff > threshold] = 1.0
        scores[diff < -threshold] = 0.0
        return scores.tolist()

    raise ValueError(f"unknown winning criterion {criterion!r}")


def _run_elo(games: list[dict], scores: list[float], ratings: dict, k_factor: int, zero_sum: bool) -> dict:
    for game, score in zip(games, scores):
        new_a, new_b = _elo_rating(
            ratings[game["player_a_name"]],
            ratings[game["player_b_name"]],
            score,
            k_factor=k_factor,
            zero_sum=zero_sum,
        )
        ratings[game["player_a_name"]] = new_a
        ratings[game["player_b_name"]] = new_b
    return ratings


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("-i", "--input", required=True, type=str, help="Folder containing the sample runs")
    parser.add_argument(
        "-c", "--criterion", required=True, choices=["llama_score", "semantic_similarity"],
        type=str, help="Criterion to evaluate win/draw/loss",
    )
    parser.add_argument("-r", "--initial-rating", default=1000, type=int, help="Initial Elo rating")
    parser.add_argument("-k", "--k-factor", default=16, type=int, help="Rating adjustment magnitude")
    parser.add_argument("-b", "--num-rounds", default=100, type=int, help="Bootstrap rounds for the final Elo")
    parser.add_argument("-n", "--num-samples", default=10_000, type=int, help="Number of games to sample")
    parser.add_argument("--disable-zero-sum", action="store_true", help="Disable the zero-sum adjustment")
    parser.add_argument("--seed", type=int, default=1234, help="Random seed")
    parser.add_argument("--log-level", type=str, default="INFO", help="Logging level")
    return parser


def main(args: Namespace | list[str] | None = None) -> dict:
    """Run the CLI on a parsed namespace or an argument list (``sys.argv[1:]``
    when None); returns ``{task: {"online": ratings, "final": ratings}}``, as printed."""
    if not isinstance(args, Namespace):
        args = build_parser().parse_args(args)
    os.environ.setdefault("LMMS_OWC_TPU_LOG_LEVEL", args.log_level)
    if args.seed:
        log.info("Setting random seed to %s", args.seed)
        random.seed(args.seed)
        np.random.seed(args.seed)

    input_path = Path(args.input)
    if input_path.is_file():
        raise ValueError("--input should be a folder containing multiple runs")

    input_files = sorted(str(f) for f in input_path.glob("**/*_samples_*.jsonl"))
    log.info("Expecting run paths of the form .../{task_name}/{model_name}/")

    tasks_inputs: dict = {}
    for input_file in input_files:
        task_name = Path(input_file).parent.parent.name
        model_name = Path(input_file).parent.name
        df = pd.read_json(input_file, lines=True)
        df = df[["doc_id", "filtered_resps", "target"]].sort_values("doc_id")

        task_models = tasks_inputs.setdefault(task_name, {})
        if model_name not in task_models:
            task_models[model_name] = df
        elif len(df) > len(task_models[model_name]):
            log.warning(
                "multiple runs for task=%s model=%s; keeping the larger", task_name, model_name
            )
            task_models[model_name] = df

    for task_name in [t for t in tasks_inputs if len(tasks_inputs[t]) < 2]:
        log.warning("removing task %s: fewer than two players", task_name)
        del tasks_inputs[task_name]

    leaderboards: dict = {}
    for task_name, task_inputs in tasks_inputs.items():
        online_ratings = {model: float(args.initial_rating) for model in task_inputs}

        games = _sample_games(task_inputs, n=args.num_samples)

        coverage = Counter()
        for game in games:
            coverage[game["player_a_name"]] += 1
            coverage[game["player_b_name"]] += 1
        log.info("Player coverage: %s", dict(coverage))

        scores = _judge_games(games, args.criterion)
        log.info("Scores counter: %s", Counter(scores))

        zero_sum = not args.disable_zero_sum
        online_ratings = _run_elo(games, scores, online_ratings, args.k_factor, zero_sum)

        # Bootstrap the final rating: shuffle, shard, run Elo per shard, median.
        order = list(range(len(games)))
        random.shuffle(order)
        bootstrap_ratings = []
        final_ratings: dict = {}
        for i in range(args.num_rounds):
            shard = order[i :: args.num_rounds]
            round_ratings = {model: float(args.initial_rating) for model in task_inputs}
            round_ratings = _run_elo(
                [games[j] for j in shard], [scores[j] for j in shard],
                round_ratings, args.k_factor, zero_sum,
            )
            bootstrap_ratings.append(round_ratings)
            for player in online_ratings:
                final_ratings[player] = float(
                    np.median([r[player] for r in bootstrap_ratings])
                )

        for title, ratings in [("Online", online_ratings), ("Final", final_ratings)]:
            lines = [f"{title} Elo ratings on {task_name}:"]
            leaderboard = sorted(ratings.items(), key=lambda x: x[1], reverse=True)
            for i, (model, rating) in enumerate(leaderboard):
                lines.append(f"{str(i + 1) + '.':<3} {model:<29}: {int(rating)}")
            print("\n".join(lines) + "\n")
        leaderboards[task_name] = {"online": online_ratings, "final": final_ratings}
    return leaderboards


if __name__ == "__main__":
    main()

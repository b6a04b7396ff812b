"""Deterministic fake model backend for engine/CLI tests (the JAX package's
``models.fake``).

This adapter lets the full request -> filter -> metric -> results pipeline run
on any machine with pinned, reproducible outputs; it runs on the host and
needs no card. Response modes:

  - ``response_mode=const``:   always ``response_text``.
  - ``response_mode=doc_id``:  "response-<task>-<doc_id>".
  - ``response_mode=echo``:    the last line of the prompt.
  - ``response_mode=target``:  the ground-truth target looked up through
    ``task_dict`` (set by the engine), exercising the 1.0-accuracy path.
"""

from __future__ import annotations

import hashlib

from lmms_owc_tpu_torch.models._api import register_model
from lmms_owc_tpu_torch.models._base import Model
from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = ["FakeModel"]


def _stable_unit_float(text: str) -> float:
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") / 2**64


@register_model("fake", "fake-echo")
class FakeModel(Model):
    """Deterministic echo model (no accelerator required)."""

    default_device = "cpu"

    def __init__(self, response_mode: str = "doc_id", response_text: str = "a fake answer", **kwargs):
        self.response_mode = response_mode
        self.response_text = response_text
        super().__init__(model_id="fake", **kwargs)

    def load_model(self) -> None:
        log.info("fake model ready (mode=%s)", self.response_mode)

    def _lookup_target(self, task_name: str, split: str, doc_id: int) -> str:
        task = self.task_dict.get(task_name)
        if task is None:
            return self.response_text
        if isinstance(task, tuple):
            task = task[1]
        doc = task.dataset[split][doc_id]
        target = task.doc_to_target(doc)
        return str(target[0] if isinstance(target, list) else target)

    def _respond(self, ctx: str, task_name: str, split: str, doc_id: int) -> str:
        if self.response_mode == "const":
            return self.response_text
        if self.response_mode == "doc_id":
            return f"response-{task_name}-{doc_id}"
        if self.response_mode == "echo":
            return ctx.strip().splitlines()[-1] if ctx.strip() else ""
        if self.response_mode == "target":
            return self._lookup_target(task_name, split, doc_id)
        raise ValueError(f"unknown response_mode {self.response_mode!r}")

    def generate_until(self, requests) -> list[str]:
        out = []
        for req in requests:
            ctx, _gen_kwargs, _visual, doc_id, task_name, split = req.args
            out.append(self._respond(ctx, task_name, split, doc_id))
        return out

    def generate_until_multi_round(self, requests) -> list[list[str]]:
        """Drive the reference multi-round protocol (5-tuple doc_to_text contract)."""
        out = []
        for req in requests:
            ctx, _gen_kwargs, _visual, doc_to_text, doc_id, task_name, split = req.args
            task = self.task_dict.get(task_name)
            if isinstance(task, tuple):
                task = task[1]
            doc = task.dataset[split][doc_id] if task is not None else {}
            rounds = [self._respond(ctx, task_name, split, doc_id)]
            last_round_info = None
            for round_idx in range(1, 8):
                try:
                    _visual_out, text, terminal, _prev, last_round_info = doc_to_text(
                        doc,
                        round_idx=round_idx,
                        previous_round_results=list(rounds),
                        last_round_info=last_round_info,
                    )
                except TypeError:
                    break
                if terminal:
                    break
                rounds.append(self._respond(text, task_name, split, doc_id))
            out.append(rounds)
        return out

    def loglikelihood(self, requests) -> list[tuple[float, bool]]:
        out = []
        for req in requests:
            ctx, continuation = req.args[0], req.args[1]
            if callable(continuation):
                # loglikelihood output type passes doc_to_target; resolve via doc.
                doc_id, task_name, split = req.args[3], req.args[4], req.args[5]
                continuation = str(self._lookup_target(task_name, split, doc_id))
            loss = _stable_unit_float(f"{ctx}||{continuation}") * 10.0
            is_greedy = _stable_unit_float(f"greedy||{ctx}||{continuation}") < 0.5
            out.append((loss, is_greedy))
        return out

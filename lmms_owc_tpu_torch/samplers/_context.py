"""Few-shot context samplers (behavior parity: reference src/data/samplers/_context.py:14-135).

``ContextSampler`` ("default") draws k docs with a caller-provided ``random.Random``
and formats ``doc_to_text + target_delimiter + target`` joined by ``fewshot_delimiter``;
``FirstNSampler`` ("first_n") takes the first n docs in split order.
"""

from __future__ import annotations

from random import Random

from lmms_owc_tpu_torch.samplers._api import Sampler, register_sampler

__all__ = ["ContextSampler", "FirstNSampler"]


@register_sampler("default")
class ContextSampler(Sampler):
    def __init__(
        self,
        docs,
        task,
        fewshot_indices: list | None = None,
        rnd: Random | None = None,
    ) -> None:
        if not rnd:
            raise ValueError("must pass rnd to ContextSampler")
        self.rnd = rnd
        self.task = task
        self.config = task._config
        self.target_delimiter = self.config.target_delimiter
        self.fewshot_delimiter = self.config.fewshot_delimiter
        self.doc_to_text = task.doc_to_text
        self.doc_to_target = task.doc_to_target
        self.doc_to_choice = task.doc_to_choice
        self.docs = docs
        if fewshot_indices:
            self.docs = self.docs.select(fewshot_indices)

    def _label_example(self, doc: dict) -> str:
        text = self.doc_to_text(doc)
        if self.config.doc_to_choice is None or isinstance(text, str):
            first = text
        else:
            first = self.doc_to_choice(doc)[text]

        target = self.doc_to_target(doc)
        if isinstance(target, list):
            second = str(target[0])
        elif self.config.doc_to_choice is None or isinstance(target, str):
            second = target
        else:
            second = str(self.doc_to_choice(doc)[target])
        return first + self.target_delimiter + second

    def get_context(self, doc: dict, num_fewshot: int) -> str:
        n_samples = num_fewshot
        # Draw an extra doc when sampling from the eval split, then drop the eval doc.
        if self.config.fewshot_split == self.config.test_split:
            n_samples += 1
        fewshot_examples = self.sample(n_samples)
        selected = [x for x in fewshot_examples if x != doc][:num_fewshot]
        labeled = [self._label_example(d) for d in selected]
        return self.fewshot_delimiter.join(labeled) + self.fewshot_delimiter

    def get_chat_context(
        self, doc: dict, num_fewshot: int, fewshot_as_multiturn: bool = False
    ) -> list[dict]:
        """Few-shot context as chat messages (user/assistant turns when multiturn)."""
        n_samples = num_fewshot
        if self.config.fewshot_split == self.config.test_split:
            n_samples += 1
        fewshot_examples = self.sample(n_samples)
        selected = [x for x in fewshot_examples if x != doc][:num_fewshot]
        messages: list[dict] = []
        if fewshot_as_multiturn:
            for d in selected:
                text = self.doc_to_text(d)
                target = self.doc_to_target(d)
                if isinstance(target, list):
                    target = str(target[0])
                elif self.config.doc_to_choice is not None and not isinstance(target, str):
                    target = str(self.doc_to_choice(d)[target])
                messages.append({"role": "user", "content": text})
                messages.append({"role": "assistant", "content": target})
        else:
            labeled = [self._label_example(d) for d in selected]
            if labeled:
                messages.append(
                    {
                        "role": "user",
                        "content": self.fewshot_delimiter.join(labeled) + self.fewshot_delimiter,
                    }
                )
        return messages

    def sample(self, n_samples: int) -> list:
        return self.rnd.sample(list(self.docs), n_samples)


@register_sampler("first_n")
class FirstNSampler(ContextSampler):
    def sample(self, n_samples: int) -> list:
        if n_samples > len(self.docs):
            raise ValueError(
                f"requested {n_samples} few-shot samples but only {len(self.docs)} available"
            )
        return list(self.docs)[:n_samples]

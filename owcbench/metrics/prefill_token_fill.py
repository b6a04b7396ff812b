"""The share of the prefill's prompt slots that hold a prompt token: the
program's counters ``prefill_tokens`` (text and merged image tokens) over
``prefill_slots`` (each chunk's rows times its length bucket;
``models/qwen2_vl.py _run_pooled``), over the window."""


def read(record):
    from lmms_owc_tpu_torch.utils import _hostprof

    counters = getattr(_hostprof, "counters", {})
    tokens, slots = counters.get("prefill_tokens"), counters.get("prefill_slots")
    if not tokens or not slots:
        return None
    return 100.0 * tokens / slots

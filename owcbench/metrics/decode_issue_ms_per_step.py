"""The host's issue of a decode step: the program's ``decode_issue`` span
(``nn/qwen2_vl.py _decode_loop``: the ``decode_step`` call, the sampling and
the token bookkeeping) summed over the window, over the decode steps the
program counted (``decode_steps``)."""


def read(record):
    from lmms_owc_tpu_torch.utils import _hostprof

    steps = getattr(_hostprof, "counters", {}).get("decode_steps")
    if "decode_issue" not in record.hostprof or not steps:
        return None
    return record.hostprof["decode_issue"] * 1e3 / steps

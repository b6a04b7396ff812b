"""The share of the decode steps that replayed CUDA graphs captured at an
earlier step of their pool: the program's counters ``decode_graph_steps``
over ``decode_steps`` (``nn/qwen2_vl.py decode_step`` and ``_decode_loop``),
over the window. None where the program counts no graph steps."""


def read(record):
    from lmms_owc_tpu_torch.utils import _hostprof

    counters = getattr(_hostprof, "counters", {})
    steps, replayed = counters.get("decode_steps"), counters.get("decode_graph_steps")
    if not steps or replayed is None:
        return None
    return 100.0 * replayed / steps

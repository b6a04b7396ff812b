"""The share of the rows that the decoder layers' products run on in a
decode step that are the pool's own: the program's counters ``decode_rows``
over ``decode_rows_computed`` (``nn/qwen2_vl.py decode_step``, after the row
blocks pad to ``DECODE_ROWS`` or to ``REDUCE_ROWS``), over the window."""


def read(record):
    from lmms_owc_tpu_torch.utils import _hostprof

    counters = getattr(_hostprof, "counters", {})
    rows, computed = counters.get("decode_rows"), counters.get("decode_rows_computed")
    if not rows or not computed:
        return None
    return 100.0 * rows / computed

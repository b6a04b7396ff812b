"""The host blocked on a decode step's stop check: the program's
``decode_stop_check`` span (``nn/qwen2_vl.py _decode_loop``, around
``bool(done.all())``, where the host waits for the device to catch up)
summed over the window, over the decode steps the program counted
(``decode_steps``)."""


def read(record):
    from lmms_owc_tpu_torch.utils import _hostprof

    steps = getattr(_hostprof, "counters", {}).get("decode_steps")
    if "decode_stop_check" not in record.hostprof or not steps:
        return None
    return record.hostprof["decode_stop_check"] * 1e3 / steps

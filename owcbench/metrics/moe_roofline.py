"""The routed expert products' share of their roofline over the window: the
summed bound of every MoE call (``owcbench/moe.py``, from the program's
device tallies of each call's routed rows and touched experts,
``nn/kimi_vl.py moe_tallies``) over the device time of the grouped
products' kernels in the trace (``moe.SYMBOLS``). None where the program
has no such tallies or the trace no such kernel."""


def read(record):
    from owcbench import moe

    if record.timeline is None:
        return None
    try:
        from lmms_owc_tpu_torch.nn import kimi_vl
    except ImportError:
        return None
    tallies = getattr(kimi_vl, "moe_tallies", None)
    if tallies is None:
        return None
    hf = record.cell.config["hf_config"]
    bound_s = moe.window_bound_s(tallies(), hf["hidden_size"], hf["moe_intermediate_size"])
    device_s = sum(s for name, s in record.timeline.kernel_s.items() if any(k in name for k in moe.SYMBOLS))
    if bound_s <= 0 or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s

"""How evenly the routed rows spread over the experts a MoE call touches:
over the window's calls, the mean rows per touched expert over the busiest
expert's rows (``owcbench/moe.py load_balance``, from the program's device
tallies, ``nn/kimi_vl.py moe_tallies``). The busiest expert paces a grouped
product. None where the program has no such tallies."""


def read(record):
    from owcbench import moe

    try:
        from lmms_owc_tpu_torch.nn import kimi_vl
    except ImportError:
        return None
    tallies = getattr(kimi_vl, "moe_tallies", None)
    if tallies is None:
        return None
    share = moe.load_balance(tallies())
    return None if share is None else 100.0 * share

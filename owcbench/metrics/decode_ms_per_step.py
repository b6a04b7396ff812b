"""A decode step: the adapter's ``decode`` phase seconds over the window,
over the decode steps counted at the configuration's ``decode_step``."""


def read(record):
    if "decode" not in record.phase_seconds or not record.decode_steps:
        return None
    return record.phase_seconds["decode"] * 1e3 / record.decode_steps

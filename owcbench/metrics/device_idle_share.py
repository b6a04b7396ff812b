"""The share of the traced window's wall time in which no operation ran on the device."""


def read(record):
    if record.timeline is None or record.timeline.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.timeline.busy_s / record.timeline.window_s)

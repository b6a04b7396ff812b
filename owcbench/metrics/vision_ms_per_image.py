"""The vision tower per image: the adapter's ``vision`` phase seconds (its
phase timer, which synchronises the device at each boundary) over the window."""


def read(record):
    if "vision" not in record.phase_seconds:
        return None
    return record.phase_seconds["vision"] * 1e3 / record.images

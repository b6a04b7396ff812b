"""The prefill per image: the adapter's ``prefill`` phase seconds over the window."""


def read(record):
    if "prefill" not in record.phase_seconds:
        return None
    return record.phase_seconds["prefill"] * 1e3 / record.images

"""The whole step's share of the card's peak: the window's model operations
(real patches and tokens; ``roofline.Work``), each product at the peak of the
type it runs in, as least seconds over the window's wall seconds."""


def read(record):
    if record.window_s <= 0 or record.work.least_seconds() <= 0:
        return None
    return 100.0 * record.work.least_seconds() / record.window_s

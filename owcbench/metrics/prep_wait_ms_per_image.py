"""Host preparation the chunk pipeline failed to hide, per image: the host
stage timer ``prep_wait`` (``utils/_core.py foreach_chunk_pipelined``) summed
over the window's calls."""


def read(record):
    if "prep_wait" not in record.hostprof:
        return None
    return record.hostprof["prep_wait"] * 1e3 / record.images

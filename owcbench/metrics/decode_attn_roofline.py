"""The decode kernel's share of its roofline over the window (K3 and
K3-int8; ``csrc/decode_attn.cu``): the summed bound of every decode step's
calls (``roofline.decode_bound`` at each step's valid keys) over the device
time of ``decode_kernel`` in the trace."""


def read(record):
    if record.timeline is None or not record.decode_bound_s:
        return None
    device_s = sum(s for name, s in record.timeline.kernel_s.items() if "decode_kernel" in name)
    return 100.0 * record.decode_bound_s / device_s if device_s > 0 else None

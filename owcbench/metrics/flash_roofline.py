"""The flash kernel's share of its roofline over the window (K1, K2, K5;
``csrc/flash_attn.cu``): the summed bound of every call, from its shapes and
masks (``roofline.attention_bound``), over the device time of the kernel's
symbols in the trace."""

SYMBOLS = ("flash_kernel", "rope_keys_kernel")


def read(record):
    if record.timeline is None or not record.flash_bound_s:
        return None
    device_s = sum(s for name, s in record.timeline.kernel_s.items() if any(k in name for k in SYMBOLS))
    return 100.0 * record.flash_bound_s / device_s if device_s > 0 else None

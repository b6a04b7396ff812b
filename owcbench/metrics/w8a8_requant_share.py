"""The share of W8A8's activation quantizations that quantize again the
input the product before had quantized (k and v after q, up after gate): the
program's counters ``w8a8_requantize`` over ``w8a8_quantize``
(``nn/layers.py _quantize_tokens``), over the window. What a quantize shared
between the products of one input would save."""


def read(record):
    from lmms_owc_tpu_torch.utils import _hostprof

    counters = getattr(_hostprof, "counters", {})
    quantized = counters.get("w8a8_quantize")
    if not quantized:
        return None
    return 100.0 * counters.get("w8a8_requantize", 0) / quantized

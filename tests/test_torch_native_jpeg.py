"""The JPEG half of the port's native loader (``native/owc_jpeg.cpp``) against the JAX package's.

Both libraries decode with libjpeg and resize with the same arithmetic, so
``jpeg_dims``, ``decode_resize`` and ``decode_resize_batch`` give the JAX
loader's dimensions and pixels exactly; the decode stays within JAX's own
bound of PIL's (``tests/test_native_loader.py``: mean absolute difference
below 1.0 at the source size, below 0.6 after a resize with the 99th
percentile within 2 levels). Undecodable bytes raise in both. Skipped where
g++ or libjpeg is missing (neither loader builds).
"""

import io

import numpy as np
import pytest
from PIL import Image

from lmms_owc_tpu.native import NativeImageLoader as JaxLoader
from lmms_owc_tpu.native import native_loader_available as jax_available
from lmms_owc_tpu_torch.native import NativeImageLoader, native_loader_available


@pytest.fixture(scope="module")
def loaders():
    if not (native_loader_available() and jax_available()):
        pytest.skip("the native JPEG loader does not build here (g++ or libjpeg missing)")
    return NativeImageLoader(num_workers=2), JaxLoader(num_workers=2)


def _jpeg(seed: int, hw) -> bytes:
    arr = np.random.RandomState(seed).randint(0, 255, (*hw, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


@pytest.mark.parametrize("hw,out_hw", [((96, 128), (96, 128)), ((100, 80), (84, 56)), ((100, 80), (120, 160)),
                                       ((448, 336), (28, 28)), ((37, 53), (56, 56))])
def test_decode_resize_matches_jax(loaders, hw, out_hw):
    port, jax_loader = loaders
    data = _jpeg(hw[0] + hw[1], hw)
    assert port.jpeg_dims(data) == jax_loader.jpeg_dims(data) == hw
    got = port.decode_resize(data, *out_hw)
    np.testing.assert_array_equal(got, jax_loader.decode_resize(data, *out_hw))
    pil = Image.open(io.BytesIO(data)).convert("RGB")
    if out_hw != hw:
        pil = pil.resize(out_hw[::-1], Image.BICUBIC)
    diff = np.abs(got.astype(int) - np.asarray(pil).transpose(2, 0, 1).astype(int))
    assert np.mean(diff) < (1.0 if out_hw == hw else 0.6)
    if out_hw != hw:
        assert np.percentile(diff, 99) <= 2


def test_batch_decode_and_errors_match_jax(loaders):
    port, jax_loader = loaders
    jobs = [(_jpeg(i, (40 + 8 * i, 60)), 28, 28 + 14 * i) for i in range(6)]
    for got, want in zip(port.decode_resize_batch(jobs), jax_loader.decode_resize_batch(jobs), strict=True):
        np.testing.assert_array_equal(got, want)
    for loader in (port, jax_loader):
        with pytest.raises(ValueError):
            loader.jpeg_dims(b"not a jpeg")
        with pytest.raises(ValueError):
            loader.decode_resize(b"\xff\xd8 truncated", 8, 8)

"""The port's safetensors reader against the ``safetensors`` package.

Files are written with ``safetensors.torch.save_file`` (every dtype the
reader takes, odd shapes, a scalar and an empty tensor) as one file, as a
directory of files, and as a sharded directory with an index; the reader's
lazy mapping must give the same names, dtypes, shapes and bytes as
``safe_open``. ``chip_smoke.py``'s writer is held to ``safe_open`` in
``tests/test_torch_chip_smoke.py``.
"""

import json

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from lmms_owc_tpu_torch.nn import loader

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.int32, torch.int64, torch.uint8, torch.bool]


def _tensors(seed: int) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, dtype in enumerate(DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), (1, 1, 9), (), (0, 4), (33,), (4, 4)][k]
        if dtype.is_floating_point:
            t = torch.randn(shape, generator=g).to(dtype)
        elif dtype == torch.bool:
            t = torch.randint(0, 2, shape, generator=g).bool()
        else:
            info = torch.iinfo(dtype)
            t = torch.randint(max(info.min, -(2**40)), min(info.max, 2**40), shape, generator=g, dtype=torch.int64).to(dtype)
        out[f"t.{dtype}".replace("torch.", "")] = t
    return out


def _reference(path) -> dict[str, torch.Tensor]:
    files = [path] if path.is_file() else sorted(path.glob("*.safetensors"))
    ref = {}
    for file in files:
        with safe_open(str(file), framework="pt") as f:
            ref.update({name: f.get_tensor(name) for name in f.keys()})
    return ref


def _assert_same(state, ref):
    assert sorted(state) == sorted(ref) and len(state) == len(ref)
    for name, want in ref.items():
        got = state[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("layout", ["file", "directory", "sharded"])
def test_reader_matches_safe_open(tmp_path, layout):
    tensors = _tensors(0)
    if layout == "file":
        path = tmp_path / "model.safetensors"
        save_file(tensors, str(path), metadata={"format": "pt"})
    else:
        path = tmp_path
        names = sorted(tensors)
        halves = {"a.safetensors": names[::2], "b.safetensors": names[1::2]}
        for file, part in halves.items():
            save_file({n: tensors[n] for n in part}, str(path / file))
        if layout == "sharded":
            (path / "model.safetensors.index.json").write_text(json.dumps(
                {"metadata": {}, "weight_map": {n: f for f, part in halves.items() for n in part}}))
            save_file({"stray": torch.ones(2)}, str(path / "unlisted.safetensors"))  # not in the index
    state = loader.load_safetensors_state(path)
    ref = _reference(path)
    ref.pop("stray", None)
    _assert_same(state, ref)
    _assert_same(state, tensors)


def test_reader_is_lazy_and_copy_on_write(tmp_path):
    """A lookup views the privately mapped file: a write into it never reaches
    the file, which a new mapping reads unchanged."""
    path = tmp_path / "m.safetensors"
    want = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    save_file({"w": want}, str(path))
    state = loader.load_safetensors_state(path)
    t = state["w"]
    assert not t.is_meta and t.device.type == "cpu"
    t.add_(100)
    assert torch.equal(loader.load_safetensors_state(path)["w"], want)
    _assert_same(loader.load_safetensors_state(path), _reference(path))


def test_unaligned_offsets_are_copied(tmp_path):
    """Tensors whose bytes start at an offset their element size does not
    divide (an int8 tensor of odd length first) still read correctly."""
    path = tmp_path / "u.safetensors"
    header = {"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [2], "data_offsets": [3, 11]}}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    body = np.array([1, -2, 3], np.int8).tobytes() + np.array([1.5, -2.25], np.float32).tobytes()
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + body)
    state = loader.load_safetensors_state(path)
    assert state["a"].tolist() == [1, -2, 3] and state["b"].tolist() == [1.5, -2.25]
    _assert_same(state, _reference(path))


def test_unsupported_dtype_and_missing_files_raise(tmp_path):
    path = tmp_path / "f64.safetensors"
    save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(path))
    with pytest.raises(ValueError, match="F64"):
        loader.load_safetensors_state(path)
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        loader.load_safetensors_state(tmp_path / "empty_dir_does_not_exist")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        loader.load_safetensors_state(tmp_path / "empty")


def test_config_json_and_cast_module(tmp_path):
    from lmms_owc_tpu_torch.nn.layers import Int8Linear

    (tmp_path / "config.json").write_text(json.dumps({"vocab_size": 7}))
    assert loader.load_config_json(tmp_path) == {"vocab_size": 7}
    assert loader.load_config_json(tmp_path / "config.json") == {"vocab_size": 7}
    lin = Int8Linear(4, 3, True, torch.float32, "cpu")
    loader.cast_module(lin, torch.bfloat16)
    assert lin.q.dtype == torch.int8 and lin.scale.dtype == torch.bfloat16 and lin.bias.dtype == torch.bfloat16

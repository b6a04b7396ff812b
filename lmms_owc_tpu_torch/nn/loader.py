"""Checkpoint reading of the port: HF safetensors files -> lazy CPU tensors.

Counterpart of :mod:`lmms_owc_tpu.nn.loader`, without the ``safetensors``
package: the format is an 8-byte little-endian header length, a JSON header
(``name -> {"dtype", "shape", "data_offsets": [begin, end]}``, offsets relative
to the end of the header, and an optional ``__metadata__``) and the raw
little-endian tensor bytes. Each file is memory-mapped copy-on-write and a
tensor is a view of its bytes, made when it is looked up, so a 16.6 GB
checkpoint is read page by page as its tensors are copied to the device and
never held in host memory all at once.

Each model module names the checkpoint tensor of each of its parameters
(``hf_tensor(state, name)``); :func:`load_hf_tensors` copies them all in,
cast to the parameters' dtype.
"""

from __future__ import annotations

import json
import struct
from collections.abc import Iterator, Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = [
    "SAFETENSORS_DTYPES",
    "SafetensorsState",
    "cast_module",
    "copy_checkpoint_tensor",
    "find_tensor",
    "load_config_json",
    "load_hf_tensors",
    "load_safetensors_state",
]

SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I8": torch.int8,
    "I32": torch.int32,
    "I64": torch.int64,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _read_header(file: Path) -> tuple[dict, int]:
    """(header entries without ``__metadata__``, byte offset of the data)."""
    with open(file, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{file}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsState(Mapping):
    """Lazy ``name -> CPU tensor`` mapping over one or more safetensors files.

    Headers are parsed when the mapping is made; every dtype is checked then
    (one outside :data:`SAFETENSORS_DTYPES` raises ``ValueError``). A lookup
    returns a tensor that views the privately mapped file (copied when its
    bytes are not aligned to its element size): a write into it never reaches
    the file, but later lookups of this mapping see it.
    """

    def __init__(self, files: list[Path]) -> None:
        self._files = list(files)
        self._maps: dict[int, torch.Tensor] = {}
        self._entries: dict[str, tuple[int, torch.dtype, tuple[int, ...], int, int]] = {}
        for idx, file in enumerate(self._files):
            header, data_start = _read_header(file)
            size = file.stat().st_size
            for name, info in header.items():
                if info["dtype"] not in SAFETENSORS_DTYPES:
                    raise ValueError(f"{file}: tensor {name!r} has dtype {info['dtype']}, which is not read "
                                     f"(supported: {sorted(SAFETENSORS_DTYPES)})")
                begin, end = (data_start + int(o) for o in info["data_offsets"])
                dtype, shape = SAFETENSORS_DTYPES[info["dtype"]], tuple(int(s) for s in info["shape"])
                expected = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
                if end - begin != expected or end > size:
                    raise ValueError(f"{file}: tensor {name!r} spans {end - begin} bytes, its shape needs {expected}")
                if name in self._entries:
                    raise ValueError(f"tensor {name!r} appears in more than one file")
                self._entries[name] = (idx, dtype, shape, begin, end)

    def _bytes(self, idx: int) -> torch.Tensor:
        if idx not in self._maps:
            mapped = np.memmap(self._files[idx], dtype=np.uint8, mode="c")
            self._maps[idx] = torch.from_numpy(mapped)
        return self._maps[idx]

    def __getitem__(self, name: str) -> torch.Tensor:
        idx, dtype, shape, begin, end = self._entries[name]
        raw = self._bytes(idx)[begin:end]
        size = torch.empty((), dtype=dtype).element_size()
        if begin % size:
            raw = raw.clone()
        if dtype == torch.bool:
            return raw.view(torch.bool).reshape(shape)
        return raw.view(dtype).reshape(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: object) -> bool:
        return name in self._entries


def load_safetensors_state(path: str | Path) -> SafetensorsState:
    """All tensors of a checkpoint: one file, a directory of ``*.safetensors``
    files, or a sharded directory with ``model.safetensors.index.json``.

    Raises ``FileNotFoundError`` when no file is found.
    """
    path = Path(path)
    if path.is_file():
        files = [path]
    else:
        index_file = path / "model.safetensors.index.json"
        if index_file.exists():
            index = json.loads(index_file.read_text())
            files = sorted({path / shard for shard in index["weight_map"].values()})
        else:
            files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors found under {path}")
    state = SafetensorsState(files)
    log.info("indexed %d tensors in %d file(s) under %s", len(state), len(files), path)
    return state


def load_config_json(path: str | Path) -> dict:
    """Read the HF config.json next to a checkpoint."""
    path = Path(path)
    config_file = path / "config.json" if path.is_dir() else path
    return json.loads(config_file.read_text())


def cast_module(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer of ``module`` to ``dtype`` in
    place (integer tensors untouched): the JAX package's ``cast_tree``."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_floating_point() and t.dtype != dtype:
            t.data = t.data.to(dtype)
    return module


def find_tensor(state: Mapping, name: str, prefixes: tuple[str, ...]) -> torch.Tensor:
    """``state[prefix + name]`` for the first prefix that the checkpoint has."""
    for prefix in prefixes:
        if prefix + name in state:
            return state[prefix + name]
    raise KeyError(f"tensor {name!r} not found under the prefixes {prefixes} (available sample: {list(state)[:5]})")


@torch.no_grad()
def copy_checkpoint_tensor(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    """Copy a checkpoint tensor into a parameter, cast to the parameter's dtype."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def load_hf_tensors(module: nn.Module, state: Mapping) -> nn.Module:
    """Fill every parameter of ``module`` from ``state`` through the module's
    ``hf_tensor(state, name)``, cast to the parameter's dtype, in place."""
    for name, param in module.named_parameters():
        copy_checkpoint_tensor(param, module.hf_tensor(state, name), name)
    return module

"""The multi-rank dry run of the port, on the CPU.

Counterpart of ``__graft_entry__.dryrun_multichip``: ``N`` processes form a
gloo group and a ("data", "model") mesh of ``N / 2`` x 2. Every rank holds its
model group's shards of a tiny Qwen2-VL (weights drawn from one seed, each
module sliced as it is drawn) and its data group's slice of the batch; the
vision tower, prefill with a greedy decode, and ``score_continuation`` run
under the mesh. Then phase B: the ``qwen2-vl-flagship-dryrun`` preset (the
7B's widths with 2 layers) in f32 with ``load_in_8bit``, through the adapter,
sharded against unsharded: the same tokens on every row.

    python -m lmms_owc_tpu_torch.parallel.dryrun [N]    # N even, default 4

Rank 0 prints ``dryrun_multichip OK: mesh={'data': N/2, 'model': 2} ...`` as
the JAX entry does; the command fails if a rank fails or hangs past its timeout.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import time

import numpy as np
import torch

TIMEOUT_S = 600
NEW_TOKENS = 4
TINY = dict(
    vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=128, tie_word_embeddings=True,
    rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
    vision_config=dict(depth=2, embed_dim=32, num_heads=4, mlp_ratio=2.0),
)


def _tiny_under_mesh(mesh) -> str:
    """The tower, prefill + greedy decode and scoring on this rank's rows."""
    from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
    from lmms_owc_tpu_torch.parallel.mesh import DATA_AXIS, model_group
    from lmms_owc_tpu_torch.parallel.sharding import Sharder

    config = qvl.Qwen2VLConfig.from_hf_dict(TINY)
    model = qvl.Qwen2VLModel(config, torch.float32, "meta")
    qvl.init_params(model, torch.Generator().manual_seed(0), Sharder(model, model_group(mesh)))

    data, d = mesh.size(0), mesh.get_local_rank(DATA_AXIS)
    b, length, rows = data * 2, 32, slice(2 * d, 2 * d + 2)  # the global batch and this data group's rows
    rng = np.random.RandomState(0)
    embeds = torch.from_numpy(rng.randn(b, length, config.hidden_size).astype(np.float32))[rows]
    position_ids = torch.arange(length)[None, None].expand(3, 2, length).contiguous()
    mask = torch.ones(2, length, dtype=torch.int32)
    v = config.vision
    patches = torch.from_numpy(rng.randn(b, 16, v.patch_dim).astype(np.float32))[rows]

    vis = model.vision(patches, torch.zeros(2, 16, v.head_dim // 2), None)
    tokens = qvl.greedy_generate(model, embeds, position_ids, mask, torch.full((2,), length), NEW_TOKENS,
                                 length + NEW_TOKENS, torch.tensor([-1]))
    targets = torch.zeros(2, length, dtype=torch.long)
    target_mask = torch.cat([torch.zeros(2, length - 4, dtype=torch.long), torch.ones(2, 4, dtype=torch.long)], 1)
    loss, greedy = qvl.score_continuation(model, embeds, position_ids, mask, targets, target_mask)
    assert vis.shape[0] == 2 and tokens.shape == (2, NEW_TOKENS) and loss.shape == greedy.shape == (2,)
    assert bool(torch.isfinite(vis).all()) and bool(torch.isfinite(loss).all())
    return f"tokens={tokens[0].tolist()} loss0={float(loss[0]):.4f}"


def flagship_outputs(model_parallel: int, device: str = "cpu", new_tokens: int = NEW_TOKENS) -> list[str]:
    """Phase B: the flagship dry-run preset in f32 with ``load_in_8bit``
    through ``generate_until`` on four 64x64 images, on ``device``."""
    from PIL import Image

    from lmms_owc_tpu_torch.models import get_model

    rng = np.random.RandomState(0)
    docs = [{"image": Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8))} for _ in range(4)]

    class _Task:
        dataset = {"test": docs}

    class _Req:
        def __init__(self, doc_id):
            self.args = ("What type of object is in this photo?",
                         {"max_new_tokens": new_tokens, "do_sample": False, "until": None},
                         lambda doc: [doc["image"]], doc_id, "dryrun", "test")

    model = get_model("qwen2-vl-tiny", preset="qwen2-vl-flagship-dryrun", batch_size=4, random_init=True,
                      dtype="float32", load_in_8bit=True, max_pixels=56 * 56, device=device,
                      model_parallel=model_parallel)
    assert (model.mesh is not None) == (model_parallel > 1)
    model.task_dict["dryrun"] = _Task()
    return model.generate_until([_Req(i) for i in range(4)])


def _rank(rank: int, world: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.distributed.init_process_group("gloo", rank=rank, world_size=world,
                                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from lmms_owc_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(data=world // 2, model=2), "cpu")
    tiny = _tiny_under_mesh(mesh)
    sharded, whole = flagship_outputs(2), flagship_outputs(1)
    if sharded != whole:
        raise AssertionError(f"sharded vs unsharded adapter outputs diverge:\n{sharded}\n{whole}")
    if rank == 0:
        print(f"dryrun_multichip OK: mesh={{'data': {mesh.size(0)}, 'model': {mesh.size(1)}}} {tiny}"
              f" flagship_adapter=token-identical", flush=True)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_ranks: int = 4) -> None:
    """Run the dry run over ``n_ranks`` CPU processes (an even count)."""
    import torch.multiprocessing as mp

    if n_ranks < 2 or n_ranks % 2:
        raise ValueError(f"the dry run needs an even rank count of at least 2, got {n_ranks}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, n_ranks, port)) for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(code != 0 for code in codes):
        raise SystemExit(f"dryrun_multichip failed: rank exit codes {codes}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)

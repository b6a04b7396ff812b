#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lmms_owc_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

``python3 chip_smoke.py --decode-rows-probe`` builds the kernels and then
only times phase 3 with the adapter's decode row blocks and without them
(:func:`probe_decode_rows`). ``python3 chip_smoke.py --flash-wg-probe``
builds them and then only times the flash kernel's Hopper instance at its
own plan and at 1, 2 and 3 warpgroups per CTA at K2's Hopper rows
(:func:`probe_flash_warpgroups`; ``--flash-wg-probe=0`` the plan alone).
``python3 chip_smoke.py --kernel-rows`` runs phases 1 and 2 alone and logs
the flash rows' device times on one line. ``python3 chip_smoke.py
--decode-split-probe`` builds them and then only times K3 at its main-path
shapes under split plans of at most 8 and 16 CTAs a cluster
(:func:`probe_decode_splits`; ``--decode-split-probe=8`` the plan alone).
``python3 chip_smoke.py --decode-graph-probe`` builds them and then only
times the 28-layer 7B decoder's decode steps (W8A8 and bf16, 96 rows): each
step's host issue and wall time, run directly and replayed from CUDA graphs,
alone and beside a thread busy in Python, and whole decode pools that stop
after 1 to 16 steps (:func:`probe_decode_graphs`; through public functions
where a checkout has no graphs, so the file copied into an older checkout
times that checkout's decode).

Phases, in order; any failure raises and the script exits non-zero:

1. Device: needs CUDA; prints the card's name and power limit; turns TF32
   off; builds the hand-written kernels (``lmms_owc_tpu_torch/csrc/*.cu``,
   one ``nvcc`` per source, side by side) into ``build/kernels/``; fails if
   ptxas reports a serialized wgmma pipeline in any kernel.
2. Kernel parity: each kernel against its plain PyTorch version on the card,
   in bf16 at the main paths' shapes, within ``atol = rtol = 2e-2``, with the
   kernel's and the plain version's times: the median per call between CUDA
   events (launch overhead included) and the device time the profiler records.
   K4 (``int4_matmul``) runs every 7B decode product at M = 96 and M = 8,
   the first 8 rows of each M = 96 call must equal an M = 8 call bit for bit,
   and one M = 8 decode step's 197 calls are summed; the int8-cache decode
   runs at the pooled shape; K3 also runs at the longest cache the adapter
   builds (8192 + 512 positions) in bf16, f32 and int8, held to the tighter
   bounds of ``LONG_CACHE_TOL``; K2's combined-qkv entry runs
   at the Qwen2.5-VL tower's global and window shapes with the gappy mask of a
   392x448 image's window layout, K2's tensor-mask form also at the prefill
   shape, and K5's packed entry at the Qwen2-VL tower's shape. Each row
   carries its bound (flops or bytes over the H100 SXM peaks) and the time of
   one PyTorch call computing the same function; ptxas's registers and
   spills are printed first. Each flash row's kernel symbol is read from
   the profiler's events and held to its label: the Hopper instance
   (``sm90::flash_kernel``), the general bf16 one, or, in f32, the 3xTF32
   one (``tf32::flash_kernel``, its bound taken at a third of the TF32
   tensor-core rate). Each Hopper row carries the plan it ran (warpgroups
   per CTA, CTAs per KV head; ``flash_plan`` held to the library's
   ``owc_flash_plan``), and each GQA row (the judge, Mistral, Qwen2-7B at
   320 and at onevision's 4096, Qwen2-1.5B at 2048, tp = 2) must equal
   per-head launches of the same kernel bit for bit (``_per_head_equal``).
   The kernels' f32 forms, and the bf16 Hopper
   instances, are checked at small ragged shapes. Phases 14-17's shapes
   are held too: K2's Hopper instance at head_dim 64 (the LLaVA tower in
   bf16 over 577 keys), its 3xTF32 instance (the CLIP scorer's towers in
   f32), its Hopper instance
   at G = 1 (the Vicuna prefill at buckets 640 and 3072), and K3 at G = 1
   (bf16 and int8 over 704 positions and over llava-next's 3136). Phases
   18-20's shapes: K2 at head_dim 72 (the SigLIP towers) in bf16 over
   onevision's tiles with no mask and over Idefics2's padded batch in the
   tensor-mask form, and in f32 in both mask forms; K2's Hopper instance at
   Mistral's G = 4 and over onevision's 4096-token bucket; K3 at G = 4 and
   at onevision's 4160-position cache (bf16 and int8). Phases 21-23's
   shapes: K2 at head_dim 88 (BLIP ViT-g, tiles 96 columns wide) in bf16 over
   [8, 16, 257, 88] through the Hopper instance (the fused qkv's views) and
   the general one (a 90-element row stride), and in f32 at a ragged shape;
   K2's Hopper instance at head_dim 64 over InternViT's [20, 16, 1025, 64],
   and its general one at 64 over views with a 66-element row stride;
   K2's Hopper instance at G = 6 (Qwen2-1.5B) over a 2048 bucket and at
   G = 1 over the Vicuna prefill's 128; K3 at G = 6 (over 352 positions,
   and in bf16 and int8 over 2112) and at G = 1 over 192. Every K3 row with
   a bf16 query must run the Hopper instance (``sm90::decode_kernel``), every
   f32 one the general kernel: the profiler's kernel symbol says which.
3. Main path, bf16: the ``qwen2-vl-7b`` adapter with random bf16 weights drawn
   on the card answers 8 image requests (64 greedy tokens) through
   ``generate_until``; the launch counts show every kernel ran.
4. Whole model: on one chunk, the prefill's last-position logits through the
   kernels against the same chunk through the plain versions (relative L2),
   in bf16 (held to the plain path's own distance from f32 attention) and
   with the weights in f32 (held to ``LOGITS_REL_L2``).
3b. Pooled = unpooled (run after phase 8): phase 3's model answers phase 3's
   8 requests in prompt order at batch 4 (two chunks) unpooled and under
   ``LMMS_OWC_DECODE_POOL=2`` (one pool of 8 rows); every row must give the
   same tokens. On the card the adapter passes ``DECODE_ROWS`` (128) to the
   decode, pooled and unpooled alike, which pads to those row blocks the
   products whose bits depend on the row count (float and weight-only int8;
   not W8A8 or K4). Phase 5 repeats the check on its model in weight-only
   int8 (W8A8 off) first, and phase 6 in int4.
5. Quantized pooled serving (the JAX bench's configuration): ``qwen2-vl-7b``
   with int8 weights drawn and quantized on the card, W8A8, a decode pool of
   2 and the int8 KV cache answers 96 448x448 requests at batch 48; images/s,
   phase seconds, peak device memory and launches are printed, and the int8
   decode kernel must run at least 28 times per decode step. The same
   requests unpooled must give the same tokens on every row; one pooled
   decode step's logits through the kernel are held to the plain versions
   as in phase 4.
6. int4: ``qwen2-vl-7b`` with int4 weights answers 8 requests unpooled; K4
   must run on every decode-step product (7 x 28 + 1 per step), and one
   decode step's logits through K4 are held to the plain version within
   ``LOGITS_REL_L2``; then phase 3b's check.
7. Qwen2.5-VL: ``qwen2.5-vl-7b`` with random bf16 weights answers 8 requests
   (six 448x448, two 392x448; the second size pads windows, so the tower's
   attention takes K2's tensor mask) through ``generate_until``; images/s,
   phase seconds, peak memory and launches are printed, and one chunk's
   prefill logits are held to the plain versions by phase 4's rule.
8. K5: phase 3's ``qwen2-vl-7b`` tower (run right after phase 3, before
   phase 4 turns the weights to f32) encodes phase 3's images with
   ``LMMS_OWC_VISION_PACKED=1`` and without; the packed call must launch
   ``packed_vision_attention`` once per layer, and the merged embeddings of
   real patches must agree with the unpacked ones as closely as the plain
   versions' do (+25%), or within ``PACKED_REL_L2``.
9. Checkpoints (run after phase 8, before phase 4): phase 3's bf16 weights are
   written as an HF checkpoint into a temporary directory (safetensors shards
   of at most 4 GiB with an index, ``config.json`` from the preset, the
   fixture tokenizer with the Qwen2 specials at their published ids; the free
   disk space is printed first and a shortfall fails). Loaded with
   ``pretrained=`` in bf16, every parameter must be bit-equal and phase 3's
   8 requests must give the same tokens as phase 3's model with the loaded
   tokenizer; loaded with ``load_in_8bit`` (W8A8, pool 2, int8 KV cache) every
   int8 module must equal ``quantize_int8`` of phase 3's weight, the load's
   peak memory stays within the int8 model plus twice the largest bf16
   tensor, and 16 requests run K3-int8 28 times per decode step; loaded with
   ``load_in_4bit`` the leaves equal ``quantize_int4`` and K4 runs 197 times
   per decode step. After phase 7, its ``qwen2.5-vl-7b`` gets the same bf16
   round trip (the first directory is deleted before the second is written).
10. Loglikelihood: the bf16 checkpoint model scores phase 3's 8 images with
    multi-token continuations; its losses are held by phase 4's rule (the
    plain path's distance from f32 attention, +25%) and each call launches
    the tower kernel 32 times and the prefill kernel 28 times.
11. Multi-round: 8 requests run two rounds in chunks of 4 under a decode pool
    of 2; round 0's tokens must equal ``generate_until``'s on the same prompts.
12. The CLI (``python -m lmms_owc_tpu_torch.eval_model``) from phase 9's bf16
    checkpoint on the toy tasks of ``tests/fixtures/tasks`` (their dataset is
    written by the fixture's recipe when missing). First phase 9's loaded
    model answers the toy task's 12 generate_until requests in-process at
    batch 8; then ``main(argv)`` runs ``toy``, ``toy_mc``,
    ``toy_multiround`` and ``toy_semantic`` (48 documents, all three request
    types, the scoring metrics): one results file, four samples files of 12
    lines, finite metrics, the toy responses equal to the in-process ones,
    and K1, K2 and K3 launched in the CLI's window; then the JAX bench's
    serving configuration (int8 + W8A8, pool 2, int8 KV cache) on ``toy``
    must launch K3-int8; then the command in a subprocess on the
    ``toy_suite`` tag (4 documents of each task, toy_semantic scored) must
    exit 0 and write its results file; then one of the paper's benchmarks,
    ``caltech101`` with its ``base`` prompt (64 tokens), from a synthesised
    image folder of four classes of the vendored ``metadata.csv``
    (converted by the task's own download hook, the split tables through
    ``LMMS_OWC_ASSETS_DIR``), through ``python -m
    lmms_owc_tpu_torch.eval_model`` in a scratch working directory: 8
    documents, the synthesised classes as targets, the four metrics finite
    (MiniLM from phase 13's checkpoint). Each CLI run's launches are in the
    ``summary cli`` line; the kernels line keeps each kernel's launches from
    its own main path.
13. Scoring (after phase 12, whose toy_semantic task scores with this
    phase's MiniLM checkpoint): (a) an HF BERT checkpoint at MiniLM-L6's
    published config with random f32 weights from a seed (a 30522-entry
    ``vocab.txt`` holding the toy answers' words) is loaded on the card and
    encodes 4096 sentences at batch 1024 through K2's f32 head_dim-32
    instance (6 launches per batch), every row held to the plain attention
    within ``SBERT_TOL``; (b) the judge at Llama-3.2-3B's width with random
    weights (``JudgeModel.random_init``) scores 256 textual-inclusion prompts
    at batch 64 in bf16 and in int8 with the int8 KV cache, each unpooled and
    under ``LMMS_OWC_JUDGE_DECODE_POOL=2``: pooled answers equal unpooled ones
    on every row, 28 K2 launches per prefill chunk and 28 K3 (or K3-int8) per
    decode step, one chunk's prefill logits held by phase 4's rule; (c) a
    judge checkpoint at full width cut to ``JUDGE_CKPT_LAYERS`` layers (a
    byte-level BPE with the Llama-3 pattern, specials and chat template) and
    the MiniLM one back the offline CLIs through ``LMMS_OWC_SBERT_PATH`` and
    ``LMMS_OWC_JUDGE_PATH``: ``eval_metrics`` scores phase 12's samples with
    the four scoring metrics and ``eval_ranking`` ranks phase 12's bf16 and
    int8 runs by ``llama_score`` and ``semantic_similarity``; a fallback
    scorer taken, or K2 or K3 not launched, fails the phase. The
    ``summary scoring`` line holds its numbers. Phase 2 also holds K2 and K3
    at this phase's shapes (MiniLM's f32 attention, the judge's prefill and
    pooled decode).

14. CLIP scorer: an HF ``CLIPModel`` checkpoint at
    openai/clip-vit-large-patch14's config (random f32 weights, a
    49408-entry ``vocab.json`` + ``merges.txt``, ``preprocessor_config.json``)
    backs ``pipelines.image.encode_clip`` through ``LMMS_OWC_CLIP_PATH``: 64
    images of mixed sizes against 16 prompts; K2 24 launches in the vision
    tower's call and 12 in the text tower's (read around each call); logits
    within ``CLIP_TOL`` of the plain
    attention's; ``summary clip``.
15. LLaVA-1.5-7B with random bf16 weights: phase 3's 8 requests (the centre
    crop runs on the 336x448 images) in one chunk, 64 greedy tokens: one
    tower call (23 K2 launches), 32 prefill launches, 32 K3 launches per
    step (MHA, G = 1), each read around its call; the chunk's prefill
    logits by phase 4's rule;
    ``loglikelihood`` by phase 10's; then ``load_in_8bit`` with the int8 KV
    cache, 32 K3-int8 launches per step.
16. A LLaVA checkpoint at llava-1.5-7b's width with 2 decoder layers (the
    released checkpoints' tensor names, a Llama-2-form ``byte_fallback``
    tokenizer): loaded bit-equal, the same tokens as the model written, and
    the port's CLI (``main(argv)``, ``--model llava-1.5-7b``) on ``toy``
    with responses equal to the in-process ones.
17. LLaVA-NeXT-vicuna-7B: one 672x672 and one 1008x336 image (anyres, about
    2,950 and 2,330 prompt tokens, bucket 3072): K3 on a 3136-position
    cache (the Hopper instance past 2048); launches printed and checked; the
    chunk's prefill logits by phase 4's rule. ``summary llava`` holds
    phases 15-17.
18. LLaVA-OneVision-Qwen2-7B with random bf16 weights: phase 3's 8 requests
    in one chunk through anyres (36 SigLIP tiles; prompts of 3712 and 1741
    tokens, bucket 4096, decode cache 4160): 8 tower calls of 26 K2
    launches at head_dim 72, 28 prefill launches, 28 K3 per step (the
    Hopper instance past 2048 positions), each read around its call; prefill
    logits by phase 4's rule; ``loglikelihood`` by phase 10's at batch 2.
7b. Qwen2.5-VL quantized (run after phase 7's checkpoint round trip):
   ``qwen2.5-vl-7b`` with weights drawn and quantized on the card, on phase
   7's 8 requests. int8 weight-only at batch 4, unpooled against pool 2,
   every row equal; W8A8 + pool 2 + the int8 KV cache against the same
   requests unpooled, every row equal, 28 K3-int8 launches in every decode
   step, one pooled step's logits by phase 4's rule; int4: 197 K4 launches
   in every decode step, one step's logits through K4 against the plain
   version, then unpooled against pool 2, every row equal. ``summary
   qwen2.5-vl quantized`` holds each run's images/s, phase seconds and peak.
19. Idefics2-8B with random bf16 weights: four images of mixed aspect,
    padded to one 448 x 672 grid (every patch mask has gaps): one tower
    call of 27 K2 launches in the tensor-mask form, 32 prefill launches
    (Hopper, G = 4), 32 K3 per step; logits and ``loglikelihood`` as 18.
20. A full-width checkpoint of each family with 2 decoder layers (the
    published tensor names, the Qwen2 fixture tokenizer with ``<image>`` at
    151646, the Mistral form with Idefics2's three added tokens) loaded
    bit-equal and serving the model's own tokens. ``summary siglip`` holds
    phases 18-20.
21. InternVL2-2B with random bf16 weights: phase 3's 8 requests in one chunk
    (20 tiles; prompts of 279 and 1815 tokens, bucket 2048, decode cache
    2112: K3's Hopper instance at G = 6): one tower call of 24 K2 launches
    at head_dim 64, 28 prefill launches, 28 K3 per step, each read around
    its call; prefill logits by phase 4's rule; ``loglikelihood`` by
    phase 10's.
22. InstructBLIP-Vicuna-7B with random bf16 weights: the same requests:
    one tower call of 39 K2 launches at head_dim 88, no launch in the
    Q-Former, 32 prefill launches, 32 K3 per step; logits and
    ``loglikelihood`` as 21.
23. A full-width checkpoint of each with 2 decoder layers (the published
    tensor names and shapes; the Qwen2 fixture tokenizer with ``<img>``,
    ``</img>`` and ``<IMG_CONTEXT>`` at their published ids; the Llama-2
    form and a ``qformer_tokenizer/``) loaded bit-equal and serving the
    model's own tokens; after phase 24, phi3v's from phase 24's model (its
    first 2 decoder layers, in the released layout: fused ``qkv_proj`` and
    ``gate_up_proj``, the tower under ``model.vision_embed_tokens.``, the
    longrope config with no ``vision_config``, the Llama-2 form with Phi-3's
    five added tokens). ``summary internvl_blip`` holds phases 21-23.
24. Phi-3-Vision (``phi3v``) with random bf16 weights at the published
    widths (CLIP ViT-L/14-336; Phi-3-mini, 32 layers of 32 heads of 96, with
    a longrope scaling of 48 short factors, attention factor 1.19): phase
    3's 8 requests in one chunk at 16 crops (a 448x448 image is 4x4 crops and
    the global view, a 336x448 one 3x4; bucket 3072, decode cache 3136),
    64 greedy tokens: 8 tower calls of 23 K2 launches at head_dim 64, 32
    prefill launches at head_dim 96, 32 K3 per step (the Hopper instance at 96),
    each read around its call; the port's host stage timers on for the
    measured run, their table logged; prefill logits by phase 4's rule and
    ``loglikelihood`` by phase 10's. ``summary phi3v``. Phase 2 holds K2 at
    head_dim 96 (Hopper over phase 24's prefill, general in bf16 and f32)
    and at the tower's [17, 16, 577, 64], and K3 at head_dim 96 over phase
    24's cache in bf16 and f32.

25. Tensor parallelism: the card is one H100 and NCCL refuses two ranks on
    one device, so two processes on ``cuda:0`` each initialise a gloo group
    (the port's all-reduces run on CUDA tensors over gloo) and, through
    ``get_model(..., model_parallel=2)``: (a) ``qwen2-vl-7b`` (14 query and
    2 KV heads a rank, G = 7; 8 tower heads of 80; an MLP 9472 wide; half
    the vocabulary) answers phase 3's 8 requests in bf16, then in int8 +
    W8A8 + the int8 KV cache, (c) in int4 (K4 at the shards' shapes), each
    with its prefill logits held by phase 4's rule (bf16: against phase 4's
    f32-attention logits; the quantized forms: against phases 5's and 6's
    unsharded logits from the same seed), the share of tokens equal to the
    unsharded model's, images/s, phase times, peak memory per rank, and in
    bf16 the all-reduces' share of one decode step logged; (b) the
    ``qwen2-vl-flagship-dryrun`` preset in f32 with ``load_in_8bit``: the
    unsharded tokens on every row; (d) the judge with ``data_parallel``:
    phase 13's answers on every row. Phase 2 holds K1 at 8 heads, K2 at
    14/2 heads over phase 3's prefill, K3 at q [8, 14, 128] over a
    [28, 8, 2, 384, 128] cache and K4 on each rank's products at M = 8.
    ``summary tensor parallel``.

The host packages that the CLIs import (and those it must do without) are
logged as present or missing at the start, with whether the port's JPEG
loader builds (libjpeg).

Phases run in the order 1-3, 8, 3b, 9 (Qwen2-VL), 10, 11, 12, 13, 4, 5
(with 3b in int8), 6 (with 3b in int4), 7, 9 (Qwen2.5-VL), 7b, 14-24, 23
(phi3v), 25.
The second-to-last line is a JSON object with each kernel's launches, error
and times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import ExitStack, contextmanager, nullcontext
from pathlib import Path

import numpy as np

TOL = 2e-2  # bf16 kernel-vs-plain tolerance (the JAX kernel tests' bf16 bound)
LOGITS_REL_L2 = 2e-2
NUM_REQUESTS = 8
MAX_NEW_TOKENS = 64
PROMPT = "What type of object is in this photo?"
POOL_BATCH = 48
POOL_REQUESTS = 96
MIN_POOL_AGREEMENT = 1.0  # rows with the unpooled run's tokens: every row
# The pooled-vs-unpooled check (phase 3b, and phase 5 in weight-only int8): phase
# 3's 8 requests in prompt order at this batch (two chunks of 4, one pool of 8).
POOL_CHECK_BATCH = 4
# Phase 3 (bf16): launches per generate_until call.
MIN_LAUNCHES = {"vision_qkv_attention": 32, "flash_attention": 28, "gqa_decode_attention": 28}
# Phases 5 and 6: launches per decode step (28 layers; int4: 7 products each plus the head).
MIN_LAUNCHES_PER_DECODE_STEP = {"gqa_decode_attention_int8": 28, "int4_matmul": 7 * 28 + 1}
# Phase 7 (qwen2.5-vl-7b, bf16): six 448x448 and two 392x448 requests; launches
# per generate_until call: 32 tower layers for each of the two grids, the
# padded grid's with a tensor mask, 28 prefill layers, 28 per decode step.
V25_SIZES = [(448, 448)] * 6 + [(392, 448)] * 2
MIN_LAUNCHES_V25 = {
    "fused_qkv_attention": 64, "flash_attention_tensor_mask": 32,
    "flash_attention": 28, "gqa_decode_attention": 28,
}
PACKED_LAUNCHES = 32  # phase 8: one packed tower call, one launch per layer
# Phase 9: the checkpoint's shards hold at most this many bytes each.
SHARD_BYTES = 4 << 30
FIXTURE_TOKENIZER = Path("tests/fixtures/tokenizer/tokenizer.json")
# Phase 9's int8 load serves this many requests (two chunks of 8, one pool).
INT8_CKPT_REQUESTS = 16
# Phase 10: per loglikelihood call, one tower call and one prefill forward.
LOGLIKELIHOOD_LAUNCHES = {"vision_qkv_attention": 32, "flash_attention": 28}
CONTINUATIONS = [
    " a dog", " a golden retriever in the wild", " a cat sitting on a mat", " an aircraft",
    " a flower", " blue red green yellow", " cheese", " a photo of a cat",
]
# Phase 11: multi-round serving, two rounds under a decode pool of 2 (chunks of 4).
MULTI_ROUND_BATCH = 4
PACKED_REL_L2 = 5e-2  # the JAX packed-vs-unpacked tower test's bound
# Phase 12: the port's CLI on the toy tasks (12 documents each, 32x32 images).
TOY_TASKS = Path("tests/fixtures/tasks")
CLI_TASKS = ("toy", "toy_mc", "toy_multiround", "toy_semantic")
CLI_DOCS = 12
CLI_BATCH = 8
CLI_METRICS = {"toy": ("exact_match", "textual_inclusion"), "toy_mc": ("acc", "acc_norm", "acc_mutual_info"),
               "toy_multiround": ("exact_match",),
               "toy_semantic": ("semantic_similarity", "concept_semantic_similarity", "exact_match")}
CLI_LAUNCHES = ("vision_qkv_attention", "flash_attention", "gqa_decode_attention")
CLI_SUBPROCESS_LIMIT = 4
# The subprocess runs the toy_suite tag: toy, toy_mc and toy_semantic (scored).
CLI_SUITE = ("toy_suite", ("toy", "toy_mc", "toy_semantic"))
# The CLIs import the first seven; the port computes without the last three
# and runs concept extraction without spaCy when it is missing.
HOST_PACKAGES = ("yaml", "jinja2", "tqdm", "dill", "datasets", "pyarrow", "pandas", "spacy", "sklearn", "sacrebleu",
                 "Levenshtein")
# Phase 13: scoring on the card. (a) MiniLM-L6 at full width from a written
# checkpoint, f32, 4096 sentences at batch 1024: six flash launches (K2's
# general f32 instance, head_dim 32) per batch, held to the plain attention
# within SBERT_TOL (f32 both ways, TF32 off: the two differ by summation order).
SBERT_SENTENCES = 4096
SBERT_BATCH = 1024
SBERT_TOL = 1e-4
# The published MiniLM-L6 config (all-MiniLM-L6-v2's config.json).
MINILM_CONFIG = dict(model_type="bert", architectures=["BertModel"], vocab_size=30522, hidden_size=384,
                     num_hidden_layers=6, num_attention_heads=12, intermediate_size=1536, hidden_act="gelu",
                     max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0)
# (b) The judge at full Llama-3.2-3B width, random weights: 256 textual
# inclusion prompts at batch 64, bf16 and int8 (+ int8 KV cache), each
# unpooled and under a decode pool of 2; 28 prefill launches per chunk, 28
# decode launches per step.
JUDGE_PROMPTS = 256
JUDGE_BATCH = 64
JUDGE_POOL = 2
# (c) The offline CLIs from checkpoints: the judge's checkpoint is written at
# full width with its depth cut to this many layers (the smoke's time limit).
JUDGE_CKPT_LAYERS = 2
SCORING_METRICS = ("semantic_similarity", "mean_average_semantic_similarity", "concept_semantic_similarity",
                   "textual_inclusion_llama32")
RANKING_GAMES = 512
RANKING_ROUNDS = 16
# The Llama-3 special tokens at their published ids (128000-128255).
LLAMA3_SPECIAL_IDS = {
    "<|begin_of_text|>": 128000, "<|end_of_text|>": 128001, "<|reserved_special_token_0|>": 128002,
    "<|reserved_special_token_1|>": 128003, "<|finetune_right_pad_id|>": 128004,
    "<|reserved_special_token_2|>": 128005, "<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
    "<|eom_id|>": 128008, "<|eot_id|>": 128009, "<|python_tag|>": 128010,
    **{f"<|reserved_special_token_{k}|>": 128008 + k for k in range(3, 248)},
}
# A Llama-3 Instruct chat template (the published one without its tool and date blocks).
LLAMA3_CHAT_TEMPLATE = (
    "{{- bos_token }}{% for message in messages %}{{ '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\\n\\n' + message['content'] | trim + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}{% endif %}"
)
# Words that the LLaVA checkpoints' tokenizer merges whole (the prompts' words).
LLAVA_WORDS = ("USER:", "ASSISTANT:", "What", "type", "of", "object", "is", "in", "this", "photo?", "a", "the",
               "cat", "dog", "photo", "[INST]", "[/INST]")
# Phase 14: the CLIP scorer at openai/clip-vit-large-patch14's published config
# (its config.json), random f32 weights drawn on the card, 64 images of mixed
# sizes against 16 prompts; logits held to the plain attention within
# CLIP_TOL (f32 both ways, TF32 off: they differ by summation order only).
CLIP_CONFIG = dict(
    model_type="clip", architectures=["CLIPModel"], projection_dim=768, logit_scale_init_value=2.6592,
    vision_config=dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
                       image_size=224, patch_size=14, projection_dim=768, hidden_act="quick_gelu"),
    text_config=dict(vocab_size=49408, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                     intermediate_size=3072, max_position_embeddings=77, projection_dim=768, bos_token_id=49406,
                     eos_token_id=49407, pad_token_id=1, hidden_act="quick_gelu"),
)
CLIP_IMAGES = 64
CLIP_SIZES = [(224, 224), (300, 400), (480, 320), (97, 211), (640, 480), (256, 256), (333, 501), (501, 333)]
CLIP_CLASSES = ("cat", "dog", "red panda", "blue jay", "golden retriever", "sea turtle", "airliner", "tabby cat",
                "goldfish", "tree frog", "school bus", "pizza", "volcano", "daisy", "strawberry", "teapot")
CLIP_TOL = 1e-4
CLIP_TEXT_LEN = 16  # the 16 prompts' padded length (start and end tokens included)
# K2 launches per scorer call: one vision call (24 layers), one text call (12).
CLIP_VISION_LAUNCHES = 24
CLIP_TEXT_LAUNCHES = 12
# Phases 15-17: LLaVA at llava-1.5-7b / llava-next-vicuna-7b (Vicuna-7B, 32
# layers, 32/32 heads of 128, vocab 32064; CLIP ViT-L/14-336 to layer 23 of
# 24). Per chunk: 23 tower launches per tower call and 32 prefill launches;
# 32 decode launches per step.
LLAVA_TOWER_LAUNCHES = 23
LLAVA_LAYERS = 32
# Prompt lengths in tokens (the fallback tokenizer, images expanded): phase
# 15's requests, and phase 17's two anyres images (packed tiles and newlines).
LLAVA_PROMPT_TOKENS = 587
LLAVA_NEXT_PROMPT_TOKENS = (2939, 2339)
# Phase 16's checkpoint: full width, the decoder cut to this many layers.
LLAVA_CKPT_LAYERS = 2
# Phase 17: one 672x672 and one 1008-wide 336-tall image (H, W): 5 and 4 tiles,
# prompts of about 2,950 and 2,330 tokens, prompt bucket 3072.
LLAVA_NEXT_SIZES = [(672, 672), (336, 1008)]
# The released llava-hf checkpoints' tensor prefixes (transformers writes them).
LLAVA_HF_PREFIXES = ("language_model.model.", "language_model.lm_head.", "vision_tower.", "multi_modal_projector.",
                     "image_newline")
CLIP_HF_PREFIXES = ("vision_model.", "text_model.", "visual_projection.", "text_projection.", "logit_scale")
# Phases 18-20: the SigLIP families at their published widths. LLaVA-OneVision
# 7B: SigLIP-SO400M at 384 px (26 layers, 16 heads of 72, 729 patches a tile)
# over Qwen2-7B (28 layers, 28/4 heads of 128); phase 3's requests: a 448x448
# image takes 5 anyres tiles and a 3712-token prompt, a 336x448 one 3 tiles
# and 1741 tokens (prompt bucket 4096, decode cache 4160 positions).
ONEVISION_PRESET = "llava-onevision-qwen2-7b-ov"
ONEVISION_TOWER_LAUNCHES = 26
ONEVISION_LAYERS = 28
ONEVISION_PROMPT_TOKENS = {(448, 448): 3712, (336, 448): 1741}
ONEVISION_TILES = {(448, 448): 5, (336, 448): 3}
# Idefics2-8B: SigLIP at 980 px (27 layers, 16 heads of 72), the perceiver (64
# latents), Mistral-7B (32 layers, 32/8 heads of 128: G = 4). Four images of
# mixed aspect, (H, W) before the processor's resize; padded to one 448 x 672
# grid of 32 x 48 patches, so every image's patch mask has gaps (K2's tensor
# form). Prompts of 78 tokens, bucket 128, decode cache 192.
IDEFICS2_PRESET = "idefics2-8b"
IDEFICS2_TOWER_LAUNCHES = 27
IDEFICS2_LAYERS = 32
IDEFICS2_SIZES = [(448, 448), (336, 448), (448, 336), (378, 672)]
IDEFICS2_PROMPT_TOKENS = 78
# Phase 20's checkpoints: full width, the decoder cut to this many layers.
SIGLIP_CKPT_LAYERS = 2
# The published checkpoints' tensor prefixes (transformers writes them).
ONEVISION_HF_PREFIXES = ("model.language_model.", "model.vision_tower.", "model.multi_modal_projector.",
                         "model.image_newline", "lm_head.")
IDEFICS2_HF_PREFIXES = ("model.text_model.", "model.vision_model.", "model.connector.", "lm_head.")
IDEFICS2_SPECIAL_IDS = {"<fake_token_around_image>": 32000, "<image>": 32001, "<end_of_utterance>": 32002}
ONEVISION_IMAGE_ID = 151646
# Phase 7b: qwen2.5-vl-7b quantized on phase 7's requests, at batch 4 (two
# chunks unpooled, one pool of 8 rows under LMMS_OWC_DECODE_POOL=2).
V25_QUANT_BATCH = 4
# Phases 21-23. InternVL2-2B: InternViT-300M at 448 px (24 layers, 16 heads of
# 64, 1025 tokens a tile, 256 after the pixel shuffle) over Qwen2-1.5B (28
# layers, 12/2 heads of 128: G = 6). Phase 3's requests: a 448x448 image is one
# tile (a 279-token prompt), a 336x448 one 6 tiles and a thumbnail (1815
# tokens): 20 tiles in one tower call, prompt bucket 2048, decode cache 2112
# (K3 past 2048 positions).
INTERNVL_PRESET = "internvl2-2b"
INTERNVL_TOWER_LAUNCHES = 24
INTERNVL_LAYERS = 28
INTERNVL_TILES = {(448, 448): 1, (336, 448): 7}
INTERNVL_PROMPT_TOKENS = {(448, 448): 279, (336, 448): 1815}
# InstructBLIP-Vicuna-7B: BLIP ViT-g at 224 px (39 layers, 16 heads of 88, 257
# tokens), the Q-Former (12 layers, 32 queries; plain attention, no kernel),
# Vicuna-7B (32 layers, 32/32 heads of 128). Prompts of 32 queries + 9 text
# tokens, bucket 128, decode cache 192.
BLIP_PRESET = "instructblip-vicuna-7b"
BLIP_TOWER_LAUNCHES = 39
BLIP_LAYERS = 32
BLIP_PROMPT_TOKENS = 41
# Phase 23's checkpoints: full width, the decoder cut to this many layers.
FAMILY_CKPT_LAYERS = 2
INTERNVL_HF_PREFIXES = ("language_model.model.", "language_model.lm_head.", "vision_tower.", "multi_modal_projector.")
BLIP_HF_PREFIXES = ("language_model.model.", "language_model.lm_head.", "vision_model.", "qformer.", "query_tokens",
                    "language_projection.")
INTERNVL_SPECIAL_IDS = {"<img>": 151665, "</img>": 151666, "<IMG_CONTEXT>": 151667}
# Phi-3-Vision (phase 24): CLIP ViT-L/14-336 (24 layers, 16 heads of 64; the
# features of its second-to-last layer: 23 K2 launches per tower call, one call
# per image over the global view and its crops) and Phi-3-mini (32 layers,
# 32/32 heads of 96, vocab 32064) with a longrope scaling of 48 short factors
# over 131072 / 4096 positions (attention factor 1.19). At 16 crops a 448x448
# image is 4x4 crops and the global view ([17, 16, 577, 64] per tower call),
# a 336x448 one 3x4 and the global view; their prompt lengths, bucket and
# decode cache are computed by :func:`phi3v_prompt_tokens`.
PHI3V_PRESET = "phi3v"
PHI3V_SMOKE_PRESET = "phi3v-longrope"  # phi3v's widths with the longrope scaling, registered by the smoke
PHI3V_TOWER_LAUNCHES = 23
PHI3V_LAYERS = 32
PHI3V_CROPS = 16
# Synthetic short and long factors of the released config's form (48 = head_dim / 2).
PHI3V_SHORT_FACTORS = [round(1.0 + 0.025 * i, 3) for i in range(48)]
PHI3V_LONG_FACTORS = [round(1.0 + 0.5 * i, 3) for i in range(48)]
PHI3V_HF_PREFIXES = ("model.", "lm_head.")
# The Phi-3 chat specials at their published ids, and the image placeholder.
PHI3V_SPECIAL_IDS = {"<|endoftext|>": 32000, "<|assistant|>": 32001, "<|end|>": 32007, "<|user|>": 32010,
                     "<|image_1|>": 32044}
FAMILY_3D_TENSORS = ("embeddings.cls_token", "embeddings.position_embeddings", "embeddings.class_embedding",
                     "embeddings.position_embedding", "query_tokens")
KERNELS = {
    "vision_qkv_attention": ("lmms_owc_tpu_torch/csrc/flash_attn.cu", "lmms_owc_tpu/ops/attention.py:1025"),
    "flash_attention": ("lmms_owc_tpu_torch/csrc/flash_attn.cu", "lmms_owc_tpu/ops/attention.py:139"),
    "fused_qkv_attention": ("lmms_owc_tpu_torch/csrc/flash_attn.cu", "lmms_owc_tpu/ops/attention.py:139"),
    "packed_vision_attention": ("lmms_owc_tpu_torch/csrc/flash_attn.cu", "lmms_owc_tpu/ops/attention.py:630"),
    "gqa_decode_attention": ("lmms_owc_tpu_torch/csrc/decode_attn.cu", "lmms_owc_tpu/ops/attention.py:838"),
    "int4_matmul": ("lmms_owc_tpu_torch/csrc/int4_matmul.cu", "lmms_owc_tpu/ops/int4_matmul.py:72"),
    "gqa_decode_attention_int8": ("lmms_owc_tpu_torch/csrc/decode_attn.cu", "lmms_owc_tpu/ops/attention.py:838"),
}
# The Qwen2 special tokens at their published ids (the adapter's SPECIAL_IDS).
QWEN2_SPECIAL_IDS = {
    "<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645, "<|vision_start|>": 151652,
    "<|vision_end|>": 151653, "<|image_pad|>": 151655, "<|video_pad|>": 151656,
}
_SAFETENSORS_DTYPES = {"bfloat16": "BF16", "float16": "F16", "float32": "F32", "int8": "I8", "int32": "I32",
                       "int64": "I64", "uint8": "U8", "bool": "BOOL"}
# K4 parity: the 7B decode products (K -> N) at the pooled and unpooled row counts.
INT4_SHAPES = {
    "q/o": (3584, 3584), "k/v": (3584, 512), "gate/up": (3584, 18944),
    "down": (18944, 3584), "lm_head": (3584, 152064),
}
INT4_ROWS = (96, 8)
# The longest decode cache the adapter builds: prompt bucket 8192 + generation bucket 512.
LONG_CACHE = 8192 + 512
# K3 at that cache against its plain version, per cache type: (max abs error,
# with no relative term, and relative L2), a few times what an H100 measured
# (max abs 2.4e-4 bf16, 4.3e-8 f32, 4.9e-4 int8). The outputs are small (about
# 0.018 std over some 8100 valid keys): a kernel that drops 256 valid keys is
# off by about 0.18 in relative L2 and by about 2e-2 at its worst element,
# inside the bf16 rows' 2e-2.
LONG_CACHE_TOL = {"bf16": (2e-3, 1e-2), "f32": (1e-4, 1e-5), "int8": (2e-3, 2e-2)}
# Published H100 SXM peaks (NVIDIA data sheet; dense bf16 tensor cores, HBM3),
# at the full 700 W power limit: the bounds of phase 2.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores (K3's f32 form)
# The f32 flash kernel runs three TF32 tensor-core products per product
# (3xTF32, f32 accuracy): a third of the 494.7 TFLOP/s TF32 rate.
PEAK_TF32_FLOPS = 494.7e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
F32_FLASH = "the 3xTF32 instance; bound at 494.7 / 3 TFLOP/s"
PEAK_BYTES_PER_S = 3.35e12
# The entries whose rows run the flash kernel (csrc/flash_attn.cu), and the decode kernel (csrc/decode_attn.cu).
FLASH_KERNELS = ("vision_qkv_attention", "flash_attention", "fused_qkv_attention", "packed_vision_attention",
                 "flash_attention_tensor_mask")
DECODE_KERNELS = ("gqa_decode_attention", "gqa_decode_attention_int8")
# Keys of each kernel row on the kernels line (and of its "also"/"all" rows).
# Phase 25: tensor parallelism on the one card, two processes over gloo.
TP_RANKS = 2
TP_TIMEOUT = 900  # seconds for both processes, their model loads included
TP_WARMUP_TOKENS = 4  # each form's warm-up call: the measured shapes, a few gloo-bound decode steps
FLAGSHIP_DRYRUN = "qwen2-vl-flagship-dryrun"
# (label, get_model arguments, environment) of the qwen2-vl-7b forms at tp = 2.
TP_FORMS = (
    ("bf16", {}, {"LMMS_OWC_DECODE_POOL": "1", "LMMS_OWC_KV_INT8": ""}),
    ("int8_w8a8_kv_int8", {"load_in_8bit": True, "int8_activations": True},
     {"LMMS_OWC_DECODE_POOL": "1", "LMMS_OWC_KV_INT8": "1"}),
    ("int4", {"load_in_4bit": True}, {"LMMS_OWC_DECODE_POOL": "1", "LMMS_OWC_KV_INT8": ""}),
)
# K4 at one rank's products of qwen2-vl-7b at tp = 2 (K -> N).
TP_INT4_SHAPES = {"q": (3584, 1792), "o": (1792, 3584), "k/v": (3584, 256), "gate/up": (3584, 9472),
                  "down": (9472, 3584), "lm_head": (3584, 76032)}
ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms", "bound_by",
            "bound_share", "library_ms", "library_device_ms", "library", "shape")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _reset_counts() -> None:
    from lmms_owc_tpu_torch.ops import attention as att
    from lmms_owc_tpu_torch.ops import int4_matmul as i4

    att.reset_launch_counts()
    i4.reset_launch_counts()


def _counts() -> dict[str, int]:
    from lmms_owc_tpu_torch.ops import attention as att
    from lmms_owc_tpu_torch.ops import int4_matmul as i4

    return {**att.launch_counts, **i4.launch_counts}


def _median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_time_us(event) -> float:
    return getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0))


def _device_kernels_ms(fn, iters: int = 20) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` runs (profiler, mean of
    ``iters``), by kernel name cut to 60 characters."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: _device_time_us(e) / 1000 / iters for e in prof.key_averages() if _device_time_us(e) > 0}


def _device_ms(fn, iters: int = 20, symbols: list | None = None) -> float | None:
    """Device time per call, summed over the kernels ``torch.profiler`` records
    (launch overhead excluded); None when the profiler sees no device time.
    The names of the kernels that ran go to ``symbols`` when it is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total_us = sum(_device_time_us(e) for e in events)
    if symbols is not None:
        symbols.extend(e.key for e in events if _device_time_us(e) > 0)
    return total_us / 1000 / iters if total_us > 0 else None


def _timings(kernel, plain, library=None) -> dict:
    """Kernel, plain-version and (when given) library-call times on the same
    operands, and the names of the kernels the kernel's call ran."""
    from lmms_owc_tpu_torch.ops import attention as att

    def launches() -> int:
        return sum(att.launch_counts[name] for name in FLASH_KERNELS + DECODE_KERNELS)

    symbols: list[str] = []
    before = launches()
    device_ms = _device_ms(kernel, symbols=symbols)
    launched = launches() > before
    for _ in range(2):  # the profiler can drop a window's events: read the call again
        if symbols and (not launched or _flash_instances(symbols) or _decode_instances(symbols)):
            break
        symbols.clear()
        device_ms = _device_ms(kernel, symbols=symbols)
    return dict(
        ms=_median_ms(kernel), plain_ms=_median_ms(plain),
        device_ms=device_ms, plain_device_ms=_device_ms(plain),
        library_ms=_median_ms(library) if library is not None else None,
        library_device_ms=_device_ms(library) if library is not None else None,
        kernel_symbols=sorted(set(symbols)),
    )


def _flash_instances(symbols) -> set[str]:
    """The flash kernel's instances among kernel names (demangled or not):
    ``sm90`` (the Hopper bf16 kernel), ``tf32`` (the 3xTF32 f32 kernel) or
    ``general`` (the general bf16 kernel)."""
    found = set()
    for name in symbols:
        if "flash_kernel" in name:
            found.add("sm90" if "sm90::" in name or "4sm90" in name
                      else "tf32" if "tf32::" in name or "4tf32" in name else "general")
    return found


def _decode_instances(symbols) -> set[str]:
    """The decode kernel's instances among kernel names (demangled or not):
    ``sm90`` (the Hopper kernel) or ``general`` (the general kernel)."""
    return {"sm90" if "sm90::" in name or "4sm90" in name else "general"
            for name in symbols if "decode_kernel" in name}


def _check_instance(shape: str, symbols) -> str | None:
    """The flash or decode instance a row's timed call ran, held to its
    label. Flash: an f32 row runs the 3xTF32 instance, a row labelled
    "general instance" the general one, every other bf16 row the Hopper one.
    Decode: a row with an f32 query (``q [...] f32``) runs the general kernel,
    every bf16 query the Hopper one. None for a row that ran neither."""
    ran, kernel = _flash_instances(symbols), "flash"
    if ran:
        want = "tf32" if " f32" in shape else "general" if "general instance" in shape else "sm90"
    else:
        ran, kernel = _decode_instances(symbols), "decode"
        if not ran:
            return None
        want = "general" if re.match(r"q \[[^]]*\] f32", shape) else "sm90"
    if ran != {want}:
        raise AssertionError(f"{shape}: ran the {kernel} kernel's {sorted(ran)} instance(s) ({symbols}), "
                             f"labelled {want}")
    return want


def _flash_plan(heads: int, kv_heads: int, lq: int, d: int) -> list[int] | None:
    """[warpgroups per CTA, CTAs per (batch row, KV head)] of the flash
    kernel's Hopper instance at a launch, from ``flash_plan``, held to the
    CUDA library's own plan (``owc_flash_plan``); None in a checkout that has
    neither (this file copied into an older one to time its kernels)."""
    import ctypes

    from lmms_owc_tpu_torch.ops import _build
    from lmms_owc_tpu_torch.ops import attention as att

    lib = _build.load_library()
    if not hasattr(att, "flash_plan"):
        return None
    plan = att.flash_plan(heads, kv_heads, lq, d)
    out = (ctypes.c_int * 2)()
    lib.owc_flash_plan(heads, kv_heads, lq, d, out)
    if tuple(out) != plan:
        raise AssertionError(f"flash plan at heads {heads}/{kv_heads}, lq {lq}, D = {d}: flash_plan {plan}, "
                             f"the CUDA plan {tuple(out)}")
    return list(plan)


def _row(shape: str, err: float, timings: dict, bound: dict, library: str,
         plan: tuple[int, int, int, int] | None = None) -> dict:
    """One kernel row: parity, times, the bound and its share of the device
    time; for a flash row, the instance the profiler saw it run and, on the
    Hopper instance, its plan (:func:`_flash_plan` of ``plan`` = (heads,
    KV heads, Lq, head_dim))."""
    device = timings["device_ms"]
    symbols = timings.pop("kernel_symbols", [])
    instance = _check_instance(shape, symbols)
    row = dict(shape=shape, max_abs_err=err, **timings, **bound, library=library,
               bound_share=bound["bound_ms"] / device if device else None,
               **({"instance": instance} if instance else {}))
    if plan is not None and instance == "sm90" and (found := _flash_plan(*plan)) is not None:
        row["plan"] = found
    return row


def _per_head_equal(label: str, q, k, v, got, **kw) -> None:
    """Holds a GQA flash row's output bit for bit to per-head launches of the
    same kernel: ``q[:, h:h+1]`` against its KV head's k and v, each launch at
    G = 1, so no CTA folds two heads."""
    import torch

    from lmms_owc_tpu_torch.ops import attention as att

    heads, group = q.shape[1], q.shape[1] // k.shape[1]
    for h in range(heads):
        kv = slice(h // group, h // group + 1)
        one = att.flash_attention(q[:, h:h + 1], k[:, kv], v[:, kv], kv_mask_contiguous=True, **kw)
        if not torch.equal(one, got[:, h:h + 1]):
            bad = int((one != got[:, h:h + 1]).sum())
            raise AssertionError(f"flash_attention {label}: head {h} (G = {group}) differs from its per-head "
                                 f"launch in {bad} elements")


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations over the
    peak of their type (bf16 tensor cores unless given) and the bytes over the
    memory rate."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                work_flops=flops, work_bytes=nbytes)


def _attention_bound(keys, heads: int, kv_heads: int, lq: int, d: int, *, causal: bool,
                     extra_bytes: float = 0, elt: int = 2, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """Bound of attention whose rows attend to the valid keys ``keys`` [B, Lk]
    (bool), causal or not: 4*d flops per (query head, valid key) pair that the
    masks leave; q read and the output written once, and each valid key's k and
    v rows read once (a masked key need not be read)."""
    import torch

    b, lk = keys.shape
    keys = keys.bool()
    if causal:  # query i (aligned to the end) sees the valid keys at or before i + lk - lq
        pairs = int(torch.cumsum(keys.int(), 1)[:, torch.arange(lq, device=keys.device) + lk - lq].sum())
    else:
        pairs = int(keys.sum()) * lq
    nbytes = elt * (2 * b * heads * lq * d + 2 * kv_heads * d * int(keys.sum())) + extra_bytes
    return _bound(4.0 * d * heads * pairs, nbytes, peak_flops)


SDPA = ("torch.nn.functional.scaled_dot_product_attention, boolean attn_mask with the same valid keys"
        " (and the causal diagonal), q and k rotated and k/v expanded to every query head before the timer")


def _sdpa(q, k, v, keep):
    """One library call computing the same attention: q [B, H, Lq, D], k/v
    [B, KVH, Lk, D] already rotated, ``keep`` a bool mask broadcast to
    [B, H, Lq, Lk]; k/v are expanded to H heads here, outside the timed call."""
    import torch

    h = q.shape[1]
    if k.shape[1] != h:
        k, v = (t.repeat_interleave(h // t.shape[1], dim=1) for t in (k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=keep)


def _causal_keep(keys, lq: int):
    """[B, 1, Lq, Lk] bool: valid key and at or before the query (aligned to the end)."""
    import torch

    lk = keys.shape[1]
    diag = torch.arange(lk, device=keys.device)[None, :] <= torch.arange(lq, device=keys.device)[:, None] + lk - lq
    return keys.bool()[:, None, None, :] & diag[None, None]


def _compare(name: str, got, want, rows=None, atol: float = TOL, rtol: float = TOL,
             rel_l2: float | None = None) -> float:
    """Max abs error over ``rows`` (a bool mask broadcast over the output); raises
    past ``atol + rtol * |want|`` on any element, or past ``rel_l2`` when given."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    rel = _rel_l2(got, want)
    if bool(bad.any()) or (rel_l2 is not None and rel > rel_l2):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside atol={atol} rtol={rtol}, "
            f"max abs err {float(err.max()):.3e}; relative L2 {rel:.3e} (bound {rel_l2})"
        )
    return float(err.max())

INT8_LIBRARY = "none: no single PyTorch call attends over an int8 cache with per-position scales"


def _decode_rows(dev, gen, rows: dict, label: str, shape: tuple, lengths, forms=("bf16",), model: str = "") -> None:
    """K3 at one decoder's decode shape in each of ``forms``, each held to its
    plain version with its bound and (bf16, f32) SDPA's time, into
    ``rows[kernel][label]`` (``label + "_f32"`` for f32): q [B, H, D] against a
    [L, B, KVH, S, D] cache, ``shape`` = (L, B, H, KVH, D, prompt bucket, S),
    whose rows hold the bucket's keys from each row's start (``prompt -
    lengths``), then 5 generated, at layers 0 and L - 1. "int8" quantizes the
    bf16 cache with per-position scales (``gqa_decode_attention_int8``). Past
    2048 positions a bf16 or f32 row is held to ``LONG_CACHE_TOL``; an int8
    row to ``TOL`` element-wise with ``LONG_CACHE_TOL``'s relative L2 (the
    bound that catches dropped keys): the plain version rounds the dequantized
    cache to bf16 where the kernel folds the scales into f32 rows (as the TPU
    kernel does), and where few keys are valid (InternVL2's 279-token
    prompts) outputs near 1 differ by a bf16 ulp, 3.9e-3 to 7.8e-3, past
    ``LONG_CACHE_TOL``'s 2e-3 (the general kernel gave the Hopper instance's
    1.95e-3 at that shape). The instance each row ran is read from the
    profiler (``_row``)."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att

    layers, b, nh, kvh, hd, prompt, s = shape
    last = layers - 1
    spos = torch.arange(s, device=dev)
    dstarts = prompt - torch.tensor(lengths, device=dev)
    dmask = ((spos[None, :] >= dstarts[:, None]) & (spos[None, :] < prompt + 5)).to(torch.int32)
    valid = int(dmask.sum())

    def randn(dtype, *dims):
        return torch.randn(dims, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    tensors: dict = {}
    for form in forms:
        dtype = torch.float32 if form == "f32" else torch.bfloat16
        if dtype not in tensors:
            tensors.clear()
            torch.cuda.empty_cache()
            tensors[dtype] = (randn(dtype, b, nh, hd), *(randn(dtype, layers, b, kvh, s, hd) for _ in range(2)))
        qd, ck, cv = tensors[dtype]
        int8 = form == "int8"
        cache = quantize_kv_cache(ck, cv) if int8 else (ck, cv)
        name = "gqa_decode_attention_int8" if int8 else "gqa_decode_attention"
        tol = {}
        if s > 2048:  # an int8 row: TOL element-wise, as below 2048, and the long-cache relative L2 (see above)
            tol = dict(rel_l2=LONG_CACHE_TOL[form][1],
                       **(dict(atol=TOL, rtol=TOL) if int8 else dict(atol=LONG_CACHE_TOL[form][0], rtol=0.0)))
        errs = [_compare(f"{name} {label} {form}[layer {layer}]",
                         att.gqa_decode_attention(qd, cache[0], cache[1], layer, dmask, *cache[2:]),
                         att.gqa_decode_attention_plain(qd, cache[0], cache[1], layer, dmask, *cache[2:]), **tol)
                for layer in (0, last)]
        qtype = "f32" if form == "f32" else "bf16"
        if int8:  # q and the output in bf16, each valid key's int8 k and v rows and two f32 scales, the mask
            nbytes = 2 * 2 * b * nh * hd + kvh * valid * (2 * hd + 2 * 4) + 4 * b * s
            library, lib_label, ctype = None, INT8_LIBRARY, "int8 + f32 scales"
        else:
            elt = ck.element_size()
            nbytes = elt * (2 * b * nh * hd + 2 * kvh * hd * valid) + 4 * b * s
            library, lib_label, ctype = _sdpa(qd[:, :, None], ck[last], cv[last], dmask.bool()[:, None, None, :]), SDPA, qtype
        rows.setdefault(name, {})[label + ("_f32" if form == "f32" else "")] = _row(
            f"q [{b}, {nh}, {hd}] {qtype}, cache [{layers}, {b}, {kvh}, {s}, {hd}] {ctype}, G = {nh // kvh}, "
            f"layers 0 and {last} ({model})", max(errs),
            _timings(lambda: att.gqa_decode_attention(qd, cache[0], cache[1], last, dmask, *cache[2:]),
                     lambda: att.gqa_decode_attention_plain(qd, cache[0], cache[1], last, dmask, *cache[2:]),
                     library),
            _bound(4.0 * hd * nh * valid, nbytes, PEAK_F32_FLOPS if form == "f32" else PEAK_BF16_FLOPS), lib_label,
        )
        del cache, library
    del tensors
    torch.cuda.empty_cache()


def check_kernels(dev) -> dict[str, dict]:
    """Phase 2: every kernel against its plain version at the main path's shapes."""
    import torch

    from lmms_owc_tpu_torch.nn.layers import apply_rope
    from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLVisionConfig, quantize_kv_cache, vision_rope_cos_sin
    from lmms_owc_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    results = {}

    # Vision (K1): [8, 16, 1024, 80], rope from a 32x32 patch grid, the last
    # four rows masked to their first 768 patches (a 336x448 image's run).
    n, p, h, d = 8, 1024, 16, 80
    vcfg = Qwen2VLVisionConfig()
    qkv = randn(n, p, 3 * h * d)
    freqs = torch.from_numpy(vision_rope_cos_sin([(1, 32, 32)], vcfg)).to(dev)
    cos, sin = torch.cos(freqs)[None].expand(n, p, d // 2), torch.sin(freqs)[None].expand(n, p, d // 2)
    vmask = torch.ones((n, p), dtype=torch.int32, device=dev)
    vmask[n // 2 :, 768:] = 0
    kw = dict(kv_mask=vmask, rope_cos=cos, rope_sin=sin)
    got = att.vision_qkv_attention(qkv, h, d, **kw)
    want = att.vision_qkv_attention_plain(qkv, h, d, **kw)
    err = _compare("vision_qkv_attention", got, want)
    vq, vk, vv = qkv.view(n, p, 3, h, d).permute(2, 0, 3, 1, 4)
    library = _sdpa(apply_rope(vq, cos, sin), apply_rope(vk, cos, sin), vv, vmask.bool()[:, None, None, :])
    results["vision_qkv_attention"] = _row(
        f"qkv [{n}, {p}, {3 * h * d}] bf16, rope, mask (0, 768) on {n // 2} rows (the Hopper instance)", err,
        _timings(lambda: att.vision_qkv_attention(qkv, h, d, **kw),
                 lambda: att.vision_qkv_attention_plain(qkv, h, d, **kw), library),
        _attention_bound(vmask, h, h, p, d, causal=False, extra_bytes=2 * 4 * n * p * d // 2 + 8 * n), SDPA,
        plan=(h, h, p, d),
    )
    del library

    # Prefill (K2): q [8, 28, 320, 128], k/v [8, 4, 320, 128], causal, left padding.
    b, nh, kvh, l, hd = 8, 28, 4, 320, 128
    q, k, v = randn(b, nh, l, hd), randn(b, kvh, l, hd), randn(b, kvh, l, hd)
    starts = torch.tensor([0, 3, 17, 40, 64, 100, 191, 250], device=dev)
    pos = torch.arange(l, device=dev)
    pmask = (pos[None, :] >= starts[:, None]).to(torch.int32)
    kw = dict(causal=True, kv_mask=pmask)
    got = att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw)
    want = att.flash_attention_plain(q, k, v, **kw)
    valid_rows = (pos[None, :] >= starts[:, None])[:, None, :].expand(b, nh, l)  # rows with a key
    err = _compare("flash_attention", got, want, valid_rows)
    _per_head_equal("prefill", q, k, v, got, **kw)
    results["flash_attention"] = _row(
        f"q [{b}, {nh}, {l}, {hd}], k/v [{b}, {kvh}, {l}, {hd}] bf16, causal, left-padded (the Hopper instance; "
        "equal to per-head launches)", err,
        _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                 lambda: att.flash_attention_plain(q, k, v, **kw), _sdpa(q, k, v, _causal_keep(pmask, l))),
        _attention_bound(pmask, nh, kvh, l, hd, causal=True, extra_bytes=8 * b), SDPA, plan=(nh, kvh, l, hd),
    )

    # Decode (K3): q [8, 28, 128] against cache [28, 8, 4, 384, 128] at two layers.
    layers, s = 28, 384
    qd = randn(b, nh, hd)
    ck, cv = randn(layers, b, kvh, s, hd), randn(layers, b, kvh, s, hd)
    spos = torch.arange(s, device=dev)
    dmask = ((spos[None, :] >= starts[:, None]) & (spos[None, :] < l + 5)).to(torch.int32)
    errs = []
    for layer in (0, layers - 1):
        got = att.gqa_decode_attention(qd, ck, cv, layer, dmask)
        want = att.gqa_decode_attention_plain(qd, ck, cv, layer, dmask)
        errs.append(_compare(f"gqa_decode_attention[layer {layer}]", got, want))
    results["gqa_decode_attention"] = _row(
        f"q [{b}, {nh}, {hd}], cache [{layers}, {b}, {kvh}, {s}, {hd}] bf16, layers 0 and {layers - 1}",
        max(errs),
        _timings(lambda: att.gqa_decode_attention(qd, ck, cv, layers - 1, dmask),
                 lambda: att.gqa_decode_attention_plain(qd, ck, cv, layers - 1, dmask),
                 _sdpa(qd[:, :, None], ck[layers - 1], cv[layers - 1], dmask.bool()[:, None, None, :])),
        _attention_bound(dmask, nh, kvh, 1, hd, causal=False, extra_bytes=4 * b * s), SDPA,
    )
    # Decode, int8 cache (K3 int8): the pooled shape, q [96, 28, 128] against
    # cache [28, 96, 4, 384, 128] int8 with [28, 96, 4, 384] scales.
    pb = POOL_BATCH * 2
    qp = randn(pb, nh, hd)
    kq, vq, sk, sv = quantize_kv_cache(randn(layers, pb, kvh, s, hd), randn(layers, pb, kvh, s, hd))
    pstarts = torch.arange(pb, device=dev) % 64
    pmask = ((spos[None, :] >= pstarts[:, None]) & (spos[None, :] < l + 5)).to(torch.int32)
    errs = []
    for layer in (0, layers - 1):
        got = att.gqa_decode_attention(qp, kq, vq, layer, pmask, sk, sv)
        want = att.gqa_decode_attention_plain(qp, kq, vq, layer, pmask, sk, sv)
        errs.append(_compare(f"gqa_decode_attention_int8[layer {layer}]", got, want))
    # Bytes: q and the output in bf16, each valid key's int8 k and v rows and
    # their two f32 scales, the int32 mask.
    valid = int(pmask.sum())
    results["gqa_decode_attention_int8"] = _row(
        f"q [{pb}, {nh}, {hd}] bf16, cache [{layers}, {pb}, {kvh}, {s}, {hd}] int8 + f32 scales, "
        f"layers 0 and {layers - 1}",
        max(errs),
        _timings(lambda: att.gqa_decode_attention(qp, kq, vq, layers - 1, pmask, sk, sv),
                 lambda: att.gqa_decode_attention_plain(qp, kq, vq, layers - 1, pmask, sk, sv)),
        _bound(4.0 * hd * nh * valid, 2 * 2 * pb * nh * hd + kvh * valid * (2 * hd + 2 * 4) + 4 * pb * s),
        "none: no single PyTorch call attends over an int8 cache with per-position scales "
        "(scaled_dot_product_attention needs the cache dequantized first)",
    )
    del kq, vq, sk, sv
    for name, rows in check_long_decode(dev, gen).items():
        results[name]["also"] = rows
        results[name]["max_abs_err"] = max([results[name]["max_abs_err"]] + [r["max_abs_err"] for r in rows.values()])
    results.update(check_tower_entries(dev, gen))
    for name, rows in [*check_scoring_shapes(dev, gen).items(), *check_llava_shapes(dev, gen).items(),
                       *check_siglip_shapes(dev, gen).items(), *check_internvl_blip_shapes(dev, gen).items(),
                       *check_phi3v_shapes(dev, gen).items()]:
        results[name].setdefault("also", {}).update(rows)
        results[name]["max_abs_err"] = max([results[name]["max_abs_err"]] + [r["max_abs_err"] for r in rows.values()])
    results["int4_matmul"] = check_int4(dev, gen)
    tp_rows = check_tp_shapes(dev, gen)  # phase 25's sharded shapes
    results["int4_matmul"]["all"].update(tp_rows.pop("int4_matmul"))
    results["int4_matmul"]["max_abs_err"] = max(r["max_abs_err"] for r in results["int4_matmul"]["all"].values())
    for label, row in results["int4_matmul"]["all"].items():
        if label.startswith("tp "):
            log(f"parity int4_matmul {label}: {row['shape']}: max abs err {row['max_abs_err']:.3e}; per call "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']} ms; device "
                f"kernel {row['device_ms']} ms, library {row['library_device_ms']} ms; bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
    for name, rows in tp_rows.items():
        results[name].setdefault("also", {}).update(rows)
        results[name]["max_abs_err"] = max([results[name]["max_abs_err"]] + [r["max_abs_err"] for r in rows.values()])
    for name, r in results.items():
        for label, row in [(name, r)] + [(f"{name} ({k})", v) for k, v in r.get("also", {}).items()]:
            log(f"parity {label}: {row['shape']}: max abs err {row['max_abs_err']:.3e}; per call "
                f"(median of 20, CUDA events) kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"library {row['library_ms']} ms; device time (profiler) kernel {row['device_ms']} ms, "
                f"plain {row['plain_device_ms']} ms, library {row['library_device_ms']} ms; bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {row['bound_share']} of the device time; "
                f"library call: {row['library']}{'; instance ' + row['instance'] if 'instance' in row else ''}"
                f"{'; plan %d warpgroups x %d CTAs per KV head' % tuple(row['plan']) if 'plan' in row else ''}")
    for name in FLASH_KERNELS + DECODE_KERNELS:  # every attention row's instance was read from the profiler
        for label, row in [(name, results[name])] + list(results[name].get("also", {}).items()):
            if "instance" not in row:
                raise AssertionError(f"parity {name} {label}: the profiler named no attention kernel for this row")
    # The gappy-mask prefill is K2's tensor-mask form through flash_attention.
    gappy = results.pop("flash_attention_tensor_mask")
    results["flash_attention"].setdefault("also", {})["tensor_mask"] = gappy
    results["flash_attention"]["max_abs_err"] = max(results["flash_attention"]["max_abs_err"], gappy["max_abs_err"])
    check_f32_kernels(dev, gen)
    check_ragged_bf16(dev, gen)
    return results


def check_scoring_shapes(dev, gen) -> dict[str, dict]:
    """Phase 2 at phase 13's shapes: K2's 3xTF32 f32 instance at MiniLM's
    (q [1024, 12, 32, 32], right-padded rows of 3 to 32 tokens), K2's Hopper
    instance at the judge's prefill (q [64, 24, 128, 128] over k/v
    [64, 8, 128, 128], causal, left-padded), and K3 in bf16 and with the int8
    cache at the judge's pooled decode (q [128, 24, 128] against
    [28, 128, 8, 160, 128]: pool 2 x batch 64, cache 128 + 16 rounded up to
    32), each held to its plain version with its bound and SDPA's time.
    Returns ``{kernel: {label: row}}``."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att

    rows: dict[str, dict] = {"flash_attention": {}, "gqa_decode_attention": {}, "gqa_decode_attention_int8": {}}

    # SBERT: f32, D = 32, 12 heads, non-causal, one valid run per row from 0.
    b, h, l, d = SBERT_BATCH, 12, 32, 32
    q, k, v = (torch.randn((b, h, l, d), generator=gen, device=dev) for _ in range(3))
    lengths = torch.randint(3, l + 1, (b,), generator=gen, device=dev)
    smask = (torch.arange(l, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
    kw = dict(kv_mask=smask)
    err = _compare("flash_attention sbert", att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                   att.flash_attention_plain(q, k, v, **kw), atol=SBERT_TOL, rtol=SBERT_TOL)
    rows["flash_attention"]["sbert"] = _row(
        f"q/k/v [{b}, {h}, {l}, {d}] f32, rows of 3 to {l} valid keys from 0 (MiniLM-L6; {F32_FLASH})", err,
        _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                 lambda: att.flash_attention_plain(q, k, v, **kw), _sdpa(q, k, v, smask.bool()[:, None, None, :])),
        _attention_bound(smask, h, h, l, d, causal=False, extra_bytes=8 * b, elt=4, peak_flops=PEAK_3XTF32_FLOPS),
        SDPA,
    )
    del q, k, v

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    # Judge prefill: bf16, 24 query heads over 8 KV heads (G = 3), causal, left-padded.
    b, nh, kvh, l, hd = JUDGE_BATCH, 24, 8, 128, 128
    q, k, v = randn(b, nh, l, hd), randn(b, kvh, l, hd), randn(b, kvh, l, hd)
    starts = torch.randint(0, 40, (b,), generator=gen, device=dev)
    pos = torch.arange(l, device=dev)
    pmask = (pos[None, :] >= starts[:, None]).to(torch.int32)
    kw = dict(causal=True, kv_mask=pmask)
    valid_rows = (pos[None, :] >= starts[:, None])[:, None, :].expand(b, nh, l)
    got = att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw)
    err = _compare("flash_attention judge prefill", got, att.flash_attention_plain(q, k, v, **kw), valid_rows)
    _per_head_equal("judge prefill", q, k, v, got, **kw)
    rows["flash_attention"]["judge_prefill"] = _row(
        f"q [{b}, {nh}, {l}, {hd}], k/v [{b}, {kvh}, {l}, {hd}] bf16, causal, left-padded (Llama-3.2-3B; equal to "
        "per-head launches)", err,
        _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                 lambda: att.flash_attention_plain(q, k, v, **kw), _sdpa(q, k, v, _causal_keep(pmask, l))),
        _attention_bound(pmask, nh, kvh, l, hd, causal=True, extra_bytes=8 * b), SDPA, plan=(nh, kvh, l, hd),
    )
    del q, k, v

    # Judge decode, pooled: the prompt bucket's keys from each row's start, then 5 generated.
    layers, b, s = 28, JUDGE_POOL * JUDGE_BATCH, 160
    qd = randn(b, nh, hd)
    ck, cv = randn(layers, b, kvh, s, hd), randn(layers, b, kvh, s, hd)
    spos = torch.arange(s, device=dev)
    dstarts = torch.randint(0, 40, (b,), generator=gen, device=dev)
    dmask = ((spos[None, :] >= dstarts[:, None]) & (spos[None, :] < l + 5)).to(torch.int32)
    valid = int(dmask.sum())
    for name, cache in (("gqa_decode_attention", (ck, cv)), ("gqa_decode_attention_int8", quantize_kv_cache(ck, cv))):
        int8 = len(cache) == 4
        errs = [_compare(f"{name} judge decode[layer {layer}]",
                         att.gqa_decode_attention(qd, cache[0], cache[1], layer, dmask, *cache[2:]),
                         att.gqa_decode_attention_plain(qd, cache[0], cache[1], layer, dmask, *cache[2:]))
                for layer in (0, layers - 1)]
        last = layers - 1
        if int8:
            nbytes = 2 * 2 * b * nh * hd + kvh * valid * (2 * hd + 2 * 4) + 4 * b * s
            library, label = None, "none: no single PyTorch call attends over an int8 cache with per-position scales"
        else:
            nbytes = 2 * (2 * b * nh * hd + 2 * kvh * hd * valid) + 4 * b * s
            library, label = _sdpa(qd[:, :, None], ck[last], cv[last], dmask.bool()[:, None, None, :]), SDPA
        rows[name]["judge_decode"] = _row(
            f"q [{b}, {nh}, {hd}] bf16, cache [{layers}, {b}, {kvh}, {s}, {hd}] "
            f"{'int8 + f32 scales' if int8 else 'bf16'}, G = 3, layers 0 and {last} (Llama-3.2-3B, pool 2)",
            max(errs),
            _timings(lambda: att.gqa_decode_attention(qd, cache[0], cache[1], last, dmask, *cache[2:]),
                     lambda: att.gqa_decode_attention_plain(qd, cache[0], cache[1], last, dmask, *cache[2:]),
                     library),
            _bound(4.0 * hd * nh * valid, nbytes), label,
        )
        del library
    return rows


def check_llava_shapes(dev, gen) -> dict[str, dict]:
    """Phase 2 at phases 14-17's shapes, each held to its plain version with
    its bound and SDPA's time: K2's Hopper instance at head_dim 64 in bf16
    over 577 keys (the LLaVA tower, non-causal, no mask), its 3xTF32 f32
    instance at the CLIP scorer's tower ([64, 16, 257, 64]) and text tower
    (causal, [16, 12, 16, 64]); K2's Hopper instance at G = 1 for the Vicuna prefill (32/32 heads
    of 128, causal, left-padded to phases 15 and 17's prompt lengths) at
    llava-1.5's bucket 640 and llava-next's 3072; K3 at G = 1 in bf16 and
    int8 against the llava-1.5 cache [32, 8, 32, 704, 128] and llava-next's
    [32, 2, 32, 3136, 128] (:func:`_decode_rows`). Returns ``{kernel: {label: row}}``."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att

    rows: dict[str, dict] = {"flash_attention": {}, "gqa_decode_attention": {}, "gqa_decode_attention_int8": {}}

    def randn(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    for label, dtype, (b, h, l, d), causal in (
        ("llava_tower", torch.bfloat16, (8, 16, 577, 64), False),
        ("clip_vision", torch.float32, (CLIP_IMAGES, 16, 257, 64), False),
        ("clip_text", torch.float32, (len(CLIP_CLASSES), 12, CLIP_TEXT_LEN, 64), True),
    ):
        q, k, v = (randn(dtype, b, h, l, d) for _ in range(3))
        f32 = dtype == torch.float32
        tol = dict(atol=CLIP_TOL, rtol=CLIP_TOL) if f32 else {}
        err = _compare(f"flash_attention {label}", att.flash_attention(q, k, v, causal=causal),
                       att.flash_attention_plain(q, k, v, causal=causal), **tol)
        keys = torch.ones((b, l), dtype=torch.int32, device=dev)
        rows["flash_attention"][label] = _row(
            f"q/k/v [{b}, {h}, {l}, {d}] {'f32' if f32 else 'bf16'}, {'causal' if causal else 'non-causal'}, no mask "
            f"({F32_FLASH if f32 else 'the Hopper instance'})",
            err,
            _timings(lambda: att.flash_attention(q, k, v, causal=causal),
                     lambda: att.flash_attention_plain(q, k, v, causal=causal),
                     _sdpa(q, k, v, _causal_keep(keys, l) if causal else None)),
            _attention_bound(keys, h, h, l, d, causal=causal, elt=4 if f32 else 2,
                             peak_flops=PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS),
            SDPA, plan=(h, h, l, d),
        )
        del q, k, v

    # The Vicuna prefill: G = 1, causal, left-padded.
    nh, hd = 32, 128
    for label, b, l, lengths in (("llava_prefill", 8, 640, [LLAVA_PROMPT_TOKENS] * 8),
                                 ("llava_next_prefill", 2, 3072, list(LLAVA_NEXT_PROMPT_TOKENS))):
        q, k, v = (randn(torch.bfloat16, b, nh, l, hd) for _ in range(3))
        starts = l - torch.tensor(lengths, device=dev)
        pos = torch.arange(l, device=dev)
        pmask = (pos[None, :] >= starts[:, None]).to(torch.int32)
        kw = dict(causal=True, kv_mask=pmask)
        valid_rows = (pos[None, :] >= starts[:, None])[:, None, :].expand(b, nh, l)
        err = _compare(f"flash_attention {label}", att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                       att.flash_attention_plain(q, k, v, **kw), valid_rows)
        rows["flash_attention"][label] = _row(
            f"q/k/v [{b}, {nh}, {l}, {hd}] bf16, G = 1, causal, left-padded (Vicuna-7B)", err,
            _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                     lambda: att.flash_attention_plain(q, k, v, **kw), _sdpa(q, k, v, _causal_keep(pmask, l))),
            _attention_bound(pmask, nh, nh, l, hd, causal=True, extra_bytes=8 * b), SDPA, plan=(nh, nh, l, hd),
        )
        del q, k, v

    # The Vicuna decode: G = 1, prompt bucket + 64, layers 0 and 31.
    for label, b, prompt, s, lengths in (("llava_decode", 8, 640, 704, [LLAVA_PROMPT_TOKENS] * 8),
                                         ("llava_next_decode", 2, 3072, 3136, list(LLAVA_NEXT_PROMPT_TOKENS))):
        _decode_rows(dev, gen, rows, label, (LLAVA_LAYERS, b, nh, nh, hd, prompt, s), lengths, ("bf16", "int8"),
                     "Vicuna-7B")
    return rows


def idefics2_patch_mask(sizes=IDEFICS2_SIZES, longest: int = 980, patch: int = 14):
    """[N, gh*gw] int32 patch masks of ``sizes`` (H, W) as the Idefics2
    adapter's variable-aspect preprocessing lays them out (resize within the
    edge budget, pad to one grid rounded to 8 patches)."""
    from lmms_owc_tpu_torch.models.idefics2 import Idefics2
    from lmms_owc_tpu_torch.nn.idefics2 import variable_patch_layout

    dims = []
    for h, w in sizes:
        rw, rh = Idefics2._hf_resize_dims(w, h, max(patch, round(longest * 378 / 980)), longest)
        dims.append((rh, rw))
    step = 8 * patch
    gh = max(min(-(-max(h for h, _ in dims) // step) * step, longest), max(h for h, _ in dims)) // patch
    gw = max(min(-(-max(w for _, w in dims) // step) * step, longest), max(w for _, w in dims)) // patch
    return variable_patch_layout(dims, (gh, gw), longest // patch, patch)[1]


def check_siglip_shapes(dev, gen) -> dict[str, dict]:
    """Phase 2 at phases 18-20's shapes, each held to its plain version with
    its bound and SDPA's time: K2 at head_dim 72 (its tiles padded to 80
    columns in bf16; the Hopper instance in bf16, the 3xTF32 one in f32), in bf16
    over LLaVA-OneVision's anyres tiles ([5, 16, 729, 72], no mask: the
    contiguous form's full run) and over
    Idefics2's padded batch (the tensor-mask form, [4, 16, 1536, 72] with the
    adapter's patch masks), and in f32 in both mask forms; K2's Hopper
    instance at Mistral's G = 4 (q [4, 32, 128, 128] over 8 KV heads, 78-token
    prompts) and at Qwen2-7B's G = 7 over onevision's 4096-position bucket;
    K3 at G = 4 ([32, 4, 8, 192, 128]) and at onevision's 4160-position cache
    in bf16 and int8 (:func:`_decode_rows`). Returns ``{kernel: {label: row}}``."""
    import torch

    from lmms_owc_tpu_torch.ops import attention as att

    rows: dict[str, dict] = {"flash_attention": {}, "gqa_decode_attention": {}}

    def randn(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    d = 72
    imask = torch.from_numpy(idefics2_patch_mask()).to(dev)
    b, l = 2, 729
    runs = torch.tensor([[0, l], [0, 500]], device=dev)
    cmask = ((torch.arange(l, device=dev)[None] >= runs[:, :1]) & (torch.arange(l, device=dev)[None] < runs[:, 1:]))
    gmask = (torch.rand((b, l), generator=gen, device=dev) < 0.6).to(torch.int32)
    gmask[:, 0] = 1
    for label, dtype, shape, mask, contiguous in (
        ("onevision_tower", torch.bfloat16, (5, 16, 729), None, False),
        ("idefics2_tower", torch.bfloat16, (imask.shape[0], 16, imask.shape[1]), imask, False),
        ("d72_contiguous_f32", torch.float32, (b, 16, l), cmask.to(torch.int32), True),
        ("d72_tensor_f32", torch.float32, (b, 16, l), gmask, False),
    ):
        n, h, length = shape
        q, k, v = (randn(dtype, n, h, length, d) for _ in range(3))
        f32 = dtype == torch.float32
        tol = dict(atol=CLIP_TOL, rtol=CLIP_TOL) if f32 else {}
        kw = dict(kv_mask=mask)
        err = _compare(f"flash_attention {label}", att.flash_attention(q, k, v, kv_mask_contiguous=contiguous, **kw),
                       att.flash_attention_plain(q, k, v, **kw), **tol)
        keys = mask if mask is not None else torch.ones((n, length), dtype=torch.int32, device=dev)
        form = "no mask" if mask is None else ("(start, end) runs" if contiguous else "gappy int32 tensor mask")
        rows["flash_attention"][label] = _row(
            f"q/k/v [{n}, {h}, {length}, {d}] {'f32' if f32 else 'bf16'}, non-causal, {form} (SigLIP, D = 72; "
            f"{F32_FLASH if f32 else 'the Hopper instance'})", err,
            _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=contiguous, **kw),
                     lambda: att.flash_attention_plain(q, k, v, **kw),
                     _sdpa(q, k, v, None if mask is None else keys.bool()[:, None, None, :])),
            _attention_bound(keys, h, h, length, d, causal=False, elt=4 if f32 else 2,
                             extra_bytes=0 if mask is None else 4 * keys.numel(),
                             peak_flops=PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS),
            SDPA, plan=(h, h, length, d),
        )
        del q, k, v

    # The decoders' prefill: Mistral at G = 4, Qwen2-7B at G = 7 (two rows of the bucket).
    hd = 128
    for label, (b, nh, kvh, l), lengths in (
        ("mistral_prefill", (4, 32, 8, 128), [IDEFICS2_PROMPT_TOKENS] * 4),
        ("onevision_prefill", (2, 28, 4, 4096), list(ONEVISION_PROMPT_TOKENS.values())),
    ):
        q, k, v = randn(torch.bfloat16, b, nh, l, hd), randn(torch.bfloat16, b, kvh, l, hd), randn(torch.bfloat16, b, kvh, l, hd)
        starts = l - torch.tensor(lengths, device=dev)
        pos = torch.arange(l, device=dev)
        pmask = (pos[None, :] >= starts[:, None]).to(torch.int32)
        kw = dict(causal=True, kv_mask=pmask)
        valid_rows = (pos[None, :] >= starts[:, None])[:, None, :].expand(b, nh, l)
        got = att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw)
        err = _compare(f"flash_attention {label}", got, att.flash_attention_plain(q, k, v, **kw), valid_rows)
        _per_head_equal(label, q, k, v, got, **kw)
        rows["flash_attention"][label] = _row(
            f"q [{b}, {nh}, {l}, {hd}], k/v [{b}, {kvh}, {l}, {hd}] bf16, G = {nh // kvh}, causal, left-padded "
            f"({'Mistral-7B' if kvh == 8 else 'Qwen2-7B'}; the Hopper instance; equal to per-head launches)", err,
            _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                     lambda: att.flash_attention_plain(q, k, v, **kw), _sdpa(q, k, v, _causal_keep(pmask, l))),
            _attention_bound(pmask, nh, kvh, l, hd, causal=True, extra_bytes=8 * b), SDPA, plan=(nh, kvh, l, hd),
        )
        del q, k, v
        torch.cuda.empty_cache()

    # The decoders' decode: the prompt bucket's keys from each row's start, then 5 generated.
    for label, (layers, b, nh, kvh, prompt, s), lengths, forms, model in (
        ("mistral_decode", (IDEFICS2_LAYERS, 4, 32, 8, 128, 192), [IDEFICS2_PROMPT_TOKENS] * 4, ("bf16",),
         "Mistral-7B"),
        ("onevision_decode", (ONEVISION_LAYERS, 8, 28, 4, 4096, 4160),
         [ONEVISION_PROMPT_TOKENS[(448, 448)]] * 6 + [ONEVISION_PROMPT_TOKENS[(336, 448)]] * 2, ("bf16", "int8"),
         "Qwen2-7B"),
    ):
        _decode_rows(dev, gen, rows, label, (layers, b, nh, kvh, hd, prompt, s), lengths, forms, model)
    return rows


def check_internvl_blip_shapes(dev, gen) -> dict[str, dict]:
    """Phase 2 at phases 21-23's shapes, each held to its plain version with
    its bound and SDPA's time: K2 at head_dim 88 (BLIP ViT-g, tiles 96 columns
    wide) in bf16 over the tower's [8, 16, 257, 88], once through the Hopper
    instance (head-offset views of the fused qkv projection, as the tower
    passes them) and once through the general one (views with a 90-element
    row stride, which the Hopper instance does not take), and in f32 (the
    3xTF32 instance) at a ragged [2, 16, 200, 88] with (start, end) runs
    (block_k < L); K2 at head_dim 64, the Hopper instance over InternViT's
    [20, 16, 1025, 64] (phase 21's 20 tiles) and the general one over views
    of [8, 16, 577, 64] with a 66-element row stride; K2's Hopper instance at G = 6
    (Qwen2-1.5B: 12/2 heads of 128) over phase 21's prompts in the 2048
    bucket and at G = 1 over the Vicuna prefill's bucket 128; K3 at G = 6
    over a 352-position cache (a chunk of 448x448 images) and over phase 21's
    2112 positions in bf16 and int8, and at G = 1 over phase 22's 192
    (:func:`_decode_rows`). Returns ``{kernel: {label: row}}``."""
    import torch

    from lmms_owc_tpu_torch.ops import attention as att

    rows: dict[str, dict] = {"flash_attention": {}, "gqa_decode_attention": {}}

    def randn(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    b, h, l, d = 8, 16, 257, 88
    qkv = randn(torch.bfloat16, b, l, 3, h, d)
    wide = [randn(torch.bfloat16, b, h, l, d + 2)[..., :d] for _ in range(3)]
    runs = torch.tensor([[0, 200], [37, 170]], device=dev)
    pos = torch.arange(200, device=dev)
    cmask = ((pos[None] >= runs[:, :1]) & (pos[None] < runs[:, 1:])).to(torch.int32)
    for label, (q, k, v), mask, form in (
        ("blip_tower", [qkv[:, :, i].transpose(1, 2) for i in range(3)], None,
         "bf16, head-offset views of the fused qkv [8, 257, 3, 16, 88] (the Hopper instance)"),
        ("blip_tower_general", wide, None, "bf16, views with a 90-element row stride (the general instance)"),
        ("d88_ragged_f32", [randn(torch.float32, 2, h, 200, d) for _ in range(3)], cmask,
         f"f32, (start, end) runs (0, 200) and (37, 170) ({F32_FLASH})"),
        ("internvit_tower", [randn(torch.bfloat16, 20, 16, 1025, 64) for _ in range(3)], None,
         "bf16, InternViT-300M's 20 tiles (the Hopper instance at D = 64)"),
        ("d64_general", [randn(torch.bfloat16, 8, 16, 577, 66)[..., :64] for _ in range(3)], None,
         "bf16, views with a 66-element row stride (the general instance at D = 64)"),
    ):
        n, nh, length, dim = q.shape
        f32 = q.dtype == torch.float32
        kw = dict(kv_mask=mask)
        tol = dict(atol=CLIP_TOL, rtol=CLIP_TOL) if f32 else {}
        valid = None
        if mask is not None:  # rows before the run's start have no valid key
            valid = (torch.arange(length, device=dev)[None] >= runs[:, :1])[:, None, :].expand(n, nh, length)
        err = _compare(f"flash_attention {label}", att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                       att.flash_attention_plain(q, k, v, **kw), valid, **tol)
        keys = mask if mask is not None else torch.ones((n, length), dtype=torch.int32, device=dev)
        rows["flash_attention"][label] = _row(
            f"q/k/v [{n}, {nh}, {length}, {dim}] {form}, non-causal", err,
            _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                     lambda: att.flash_attention_plain(q, k, v, **kw),
                     _sdpa(q, k, v, None if mask is None else keys.bool()[:, None, None, :])),
            _attention_bound(keys, nh, nh, length, dim, causal=False, elt=4 if f32 else 2,
                             extra_bytes=0 if mask is None else 8 * n,
                             peak_flops=PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS),
            SDPA, plan=(nh, nh, length, dim),
        )
        del q, k, v
    del qkv, wide
    torch.cuda.empty_cache()

    # The decoders' prefill: Qwen2-1.5B at G = 6 over phase 21's bucket, Vicuna at G = 1.
    hd = 128
    internvl_lengths = [INTERNVL_PROMPT_TOKENS[(448, 448)]] * 6 + [INTERNVL_PROMPT_TOKENS[(336, 448)]] * 2
    for label, (b, nh, kvh, l), lengths, model in (
        ("internvl_prefill", (8, 12, 2, 2048), internvl_lengths, "Qwen2-1.5B"),
        ("blip_prefill", (8, 32, 32, 128), [BLIP_PROMPT_TOKENS] * 8, "Vicuna-7B"),
    ):
        q, k, v = randn(torch.bfloat16, b, nh, l, hd), randn(torch.bfloat16, b, kvh, l, hd), randn(torch.bfloat16, b, kvh, l, hd)
        starts = l - torch.tensor(lengths, device=dev)
        pos = torch.arange(l, device=dev)
        pmask = (pos[None, :] >= starts[:, None]).to(torch.int32)
        kw = dict(causal=True, kv_mask=pmask)
        valid_rows = (pos[None, :] >= starts[:, None])[:, None, :].expand(b, nh, l)
        got = att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw)
        err = _compare(f"flash_attention {label}", got, att.flash_attention_plain(q, k, v, **kw), valid_rows)
        if nh != kvh:
            _per_head_equal(label, q, k, v, got, **kw)
        rows["flash_attention"][label] = _row(
            f"q [{b}, {nh}, {l}, {hd}], k/v [{b}, {kvh}, {l}, {hd}] bf16, G = {nh // kvh}, causal, left-padded "
            f"({model}; the Hopper instance{'; equal to per-head launches' if nh != kvh else ''})", err,
            _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                     lambda: att.flash_attention_plain(q, k, v, **kw), _sdpa(q, k, v, _causal_keep(pmask, l))),
            _attention_bound(pmask, nh, kvh, l, hd, causal=True, extra_bytes=8 * b), SDPA, plan=(nh, kvh, l, hd),
        )
        del q, k, v
        torch.cuda.empty_cache()

    # The decoders' decode: the prompt bucket's keys from each row's start, then 5 generated.
    for label, (layers, b, nh, kvh, prompt, s), lengths, forms, model in (
        ("internvl_decode_short", (INTERNVL_LAYERS, 8, 12, 2, 288, 352), [INTERNVL_PROMPT_TOKENS[(448, 448)]] * 8,
         ("bf16",), "Qwen2-1.5B"),
        ("internvl_decode", (INTERNVL_LAYERS, 8, 12, 2, 2048, 2112), internvl_lengths, ("bf16", "int8"),
         "Qwen2-1.5B"),
        ("blip_decode", (BLIP_LAYERS, 8, 32, 32, 128, 192), [BLIP_PROMPT_TOKENS] * 8, ("bf16",), "Vicuna-7B"),
    ):
        _decode_rows(dev, gen, rows, label, (layers, b, nh, kvh, hd, prompt, s), lengths, forms, model)
    return rows


def check_phi3v_shapes(dev, gen) -> dict[str, dict]:
    """Phase 2 at phase 24's shapes, each held to its plain version with its
    bound and SDPA's time: K2's Hopper instance at head_dim 96 (Phi-3-mini,
    MHA) over phase 24's prompts, causal and left-padded in their bucket
    (:func:`phi3v_prompt_tokens`); K2's general instance at head_dim 96 in
    bf16 (views with a 98-element row stride, which the Hopper instance does
    not take) and its 3xTF32 f32 instance at a ragged [2, 32, 200, 96] with
    (start, end) runs (block_k < L: the multi-block online softmax); K2's
    Hopper instance at head_dim 64 over the Phi-3 tower's [17, 16, 577, 64]
    (a 448x448 image's global view and 16 crops); K3 at head_dim 96, G = 1,
    over phase 24's decode cache in bf16, int8 and f32, held to ``LONG_CACHE_TOL``
    (:func:`_decode_rows`).
    Returns ``{kernel: {label: row}}``."""
    import torch

    from lmms_owc_tpu_torch.ops import attention as att
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    rows: dict[str, dict] = {"flash_attention": {}, "gqa_decode_attention": {}}

    def randn(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    hd, nh = 96, 32
    lengths = phi3v_prompt_tokens()
    bucket = pad_to_bucket(max(lengths))
    cache_len = bucket + MAX_NEW_TOKENS

    def left_padded(b, l, lens):
        starts = l - torch.tensor(lens, device=dev)
        pos = torch.arange(l, device=dev)
        return (pos[None, :] >= starts[:, None]).to(torch.int32)

    # The prefill (Hopper, the decoder's shapes) and the general bf16 instance on unaligned views.
    for label, (b, l), lens, form in (
        ("phi3_prefill", (8, bucket), lengths, "bf16 (the Hopper instance)"),
        ("d96_general", (8, 512), [512, 480, 400, 333, 256, 200, 97, 1],
         "bf16, views with a 98-element row stride (the general instance)"),
    ):
        if label == "d96_general":
            q, k, v = (randn(torch.bfloat16, b, nh, l, hd + 2)[..., :hd] for _ in range(3))
        else:
            q, k, v = (randn(torch.bfloat16, b, nh, l, hd) for _ in range(3))
        pmask = left_padded(b, l, lens)
        kw = dict(causal=True, kv_mask=pmask)
        valid_rows = pmask.bool()[:, None, :].expand(b, nh, l)
        err = _compare(f"flash_attention {label}", att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                       att.flash_attention_plain(q, k, v, **kw), valid_rows)
        rows["flash_attention"][label] = _row(
            f"q/k/v [{b}, {nh}, {l}, {hd}] {form}, MHA, causal, left-padded (Phi-3-mini)", err,
            _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                     lambda: att.flash_attention_plain(q, k, v, **kw), _sdpa(q, k, v, _causal_keep(pmask, l))),
            _attention_bound(pmask, nh, nh, l, hd, causal=True, extra_bytes=8 * b), SDPA, plan=(nh, nh, l, hd),
        )
        del q, k, v
        torch.cuda.empty_cache()

    # f32 at a ragged shape, and the tower, non-causal.
    runs = torch.tensor([[0, 200], [37, 170]], device=dev)
    pos = torch.arange(200, device=dev)
    cmask = ((pos[None] >= runs[:, :1]) & (pos[None] < runs[:, 1:])).to(torch.int32)
    for label, (q, k, v), mask, form in (
        ("d96_ragged_f32", [randn(torch.float32, 2, nh, 200, hd) for _ in range(3)], cmask,
         f"f32, (start, end) runs (0, 200) and (37, 170) ({F32_FLASH})"),
        ("phi3_tower", [randn(torch.bfloat16, 17, 16, 577, 64) for _ in range(3)], None,
         "bf16, a 448x448 image's global view and 16 crops through CLIP-L/336 (the Hopper instance at D = 64)"),
    ):
        n, heads, length, dim = q.shape
        f32 = q.dtype == torch.float32
        kw = dict(kv_mask=mask)
        tol = dict(atol=CLIP_TOL, rtol=CLIP_TOL) if f32 else {}
        valid = None
        if mask is not None:  # rows before the run's start have no valid key
            valid = (torch.arange(length, device=dev)[None] >= runs[:, :1])[:, None, :].expand(n, heads, length)
        err = _compare(f"flash_attention {label}", att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                       att.flash_attention_plain(q, k, v, **kw), valid, **tol)
        keys = mask if mask is not None else torch.ones((n, length), dtype=torch.int32, device=dev)
        rows["flash_attention"][label] = _row(
            f"q/k/v [{n}, {heads}, {length}, {dim}] {form}, non-causal", err,
            _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                     lambda: att.flash_attention_plain(q, k, v, **kw),
                     _sdpa(q, k, v, None if mask is None else keys.bool()[:, None, None, :])),
            _attention_bound(keys, heads, heads, length, dim, causal=False, elt=4 if f32 else 2,
                             extra_bytes=0 if mask is None else 8 * n,
                             peak_flops=PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS),
            SDPA, plan=(heads, heads, length, dim),
        )
        del q, k, v
        torch.cuda.empty_cache()

    # The decode: the prompt bucket's keys from each row's start, then 5 generated.
    _decode_rows(dev, gen, rows, "phi3_decode", (PHI3V_LAYERS, 8, nh, nh, hd, bucket, cache_len), lengths,
                 ("bf16", "int8", "f32"), "Phi-3-mini")
    return rows


def _v25_window_layout(grid):
    """(slot_src, valid [W*S] int32, tok_idx, W, S) of one image in the
    Qwen2.5-VL-7B window layout, as the adapter builds it."""
    from lmms_owc_tpu_torch.nn.qwen2_5_vl import Qwen25VisionConfig, get_window_layout

    v25 = Qwen25VisionConfig()
    mu = v25.spatial_merge_size**2
    slot_src, wn, s = get_window_layout(grid, v25)
    valid_units = slot_src >= 0
    tok_idx = (np.where(valid_units, slot_src, 0)[:, None] * mu + np.arange(mu)).reshape(-1)
    return slot_src, np.repeat(valid_units, mu).astype(np.int32), tok_idx, wn, s


def check_tower_entries(dev, gen) -> dict[str, dict]:
    """Phase 2, the entries of this slice: K2's combined-qkv entry at the
    Qwen2.5-VL tower's global and window shapes, K2's tensor mask at the
    prefill shape, and K5's packed entry at the Qwen2-VL tower's shape."""
    import torch

    from lmms_owc_tpu_torch.nn.layers import apply_rope
    from lmms_owc_tpu_torch.nn.qwen2_5_vl import Qwen25VisionConfig, vision25_rope_freqs
    from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLVisionConfig, vision_rope_cos_sin
    from lmms_owc_tpu_torch.ops import attention as att

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    results = {}
    # Qwen2.5-VL tower: 8 images of 392x448 (28x32 patches; 14x16 merge units
    # in 4x4-unit windows, so the last window row pads: 896 of 1024 slots
    # valid, the gaps inside the global layers' key run), token-major qkv of
    # 16 heads of 80, rope in slot order, as the tower calls the entry.
    n, h, d = 8, 16, 80
    grid = (1, 28, 32)
    _, valid, tok_idx, wn, s = _v25_window_layout(grid)
    l = wn * s
    freqs = torch.from_numpy(vision25_rope_freqs(grid, Qwen25VisionConfig())[tok_idx] * valid[:, None]).to(dev)
    freqs = freqs.float()[None].expand(n, l, d // 2).reshape(n * l, d // 2)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    mask = torch.from_numpy(valid).to(dev)[None].expand(n, l).reshape(n * l)
    qkv = randn(n, l, 3 * h, d)
    shapes = {"global": (n, l), "window": (n * wn, s)}
    rows = {}
    for label, (b, length) in shapes.items():
        kw = dict(kv_mask=mask.view(b, length), rope_cos=cos.view(b, length, -1),
                  rope_sin=sin.view(b, length, -1), token_major=True)
        x = qkv.view(b, length, 3 * h, d)
        err = _compare(f"fused_qkv_attention[{label}]", att.fused_qkv_attention(x, h, h, **kw),
                       att.fused_qkv_attention_plain(x, h, h, **kw))
        keys = kw["kv_mask"]
        xq, xk, xv = x.view(b, length, 3, h, d).permute(2, 0, 3, 1, 4)
        c, sn = kw["rope_cos"], kw["rope_sin"]
        library = _sdpa(apply_rope(xq, c, sn), apply_rope(xk, c, sn), xv, keys.bool()[:, None, None, :])
        rows[label] = _row(
            f"qkvh [{b}, {3 * h}, {length}, {d}] bf16 (token-major view), rope, the window mask of "
            f"a 392x448 image ({int(valid.sum())} of {l} slots valid)", err,
            _timings(lambda: att.fused_qkv_attention(x, h, h, **kw),
                     lambda: att.fused_qkv_attention_plain(x, h, h, **kw), library),
            _attention_bound(keys, h, h, length, d, causal=False,
                             extra_bytes=4 * b * length * d + 4 * b * length), SDPA, plan=(h, h, length, d),
        )
        del library
    # The head-major [B, H + 2*KVH, L, D] form of the same entry, parity only.
    kw = dict(kv_mask=mask.view(n, l), rope_cos=cos.view(n, l, -1), rope_sin=sin.view(n, l, -1))
    head_major = qkv.permute(0, 2, 1, 3).contiguous()
    err = _compare("fused_qkv_attention[head-major]", att.fused_qkv_attention(head_major, h, h, **kw),
                   att.fused_qkv_attention_plain(head_major, h, h, **kw))
    results["fused_qkv_attention"] = dict(rows["global"], also={"window layers": rows["window"]})
    results["fused_qkv_attention"]["max_abs_err"] = max(err, rows["global"]["max_abs_err"], rows["window"]["max_abs_err"])
    del qkv, head_major

    # K2's tensor mask at the prefill shape: causal GQA with random holes and
    # a masked head run per row; query rows that see no valid key are skipped.
    b, nh, kvh, l, hd = 8, 28, 4, 320, 128
    q, k, v = randn(b, nh, l, hd), randn(b, kvh, l, hd), randn(b, kvh, l, hd)
    gmask = (torch.rand((b, l), generator=gen, device=dev) > 0.3).to(torch.int32)
    gmask[torch.arange(l, device=dev)[None, :] < torch.arange(b, device=dev)[:, None] * 20] = 0
    kw = dict(causal=True, kv_mask=gmask)
    seen = (torch.cumsum(gmask, dim=1) > 0)[:, None, :].expand(b, nh, l)
    err = _compare("flash_attention[tensor mask]", att.flash_attention(q, k, v, **kw),
                   att.flash_attention_plain(q, k, v, **kw), seen)
    results["flash_attention_tensor_mask"] = _row(
        f"q [{b}, {nh}, {l}, {hd}], k/v [{b}, {kvh}, {l}, {hd}] bf16, causal, gappy mask "
        f"({int(gmask.sum())} of {b * l} keys valid)", err,
        _timings(lambda: att.flash_attention(q, k, v, **kw), lambda: att.flash_attention_plain(q, k, v, **kw),
                 _sdpa(q, k, v, _causal_keep(gmask, l))),
        _attention_bound(gmask, nh, kvh, l, hd, causal=True, extra_bytes=4 * b * l), SDPA, plan=(nh, kvh, l, hd),
    )
    del q, k, v

    # K5: the Qwen2-VL tower's packed qkv, [8, 1024, 3*16*128] with each
    # head's 80 columns zero-padded to 128, rope freqs of a 32x32 patch grid,
    # every row masked to its first 768 patches.
    n, p, hp = 8, 1024, 128
    packed = torch.nn.functional.pad(randn(n, p, 3, h, d), (0, hp - d)).reshape(n, p, 3 * h * hp)
    pfreqs = torch.from_numpy(vision_rope_cos_sin([(1, 32, 32)], Qwen2VLVisionConfig())).to(dev)[None].expand(n, p, d // 2)
    pmask = torch.zeros((n, p), dtype=torch.int32, device=dev)
    pmask[:, :768] = 1
    kw = dict(kv_mask=pmask, freqs=pfreqs)
    got = att.packed_vision_attention(packed, h, d, **kw)
    err = _compare("packed_vision_attention", got, att.packed_attention_reference(packed, h, d, **kw))
    if bool(got.view(n, p, h, hp)[..., d:].any()):
        raise AssertionError("packed_vision_attention: padding columns are not zero")
    pq, pk, pv = packed.view(n, p, 3, h, hp)[..., :d].permute(2, 0, 3, 1, 4)
    pc, ps = torch.cos(pfreqs.float()), torch.sin(pfreqs.float())
    library = _sdpa(apply_rope(pq, pc, ps), apply_rope(pk, pc, ps), pv, pmask.bool()[:, None, None, :])
    # Bytes: the real columns of q, k and v read, the padded output written, the freqs.
    bound = _attention_bound(pmask, h, h, p, d, causal=False, extra_bytes=2 * n * p * h * (hp - d) + 4 * n * p * d // 2)
    results["packed_vision_attention"] = _row(
        f"qkv [{n}, {p}, 3*{h}*{hp}] bf16 (head_dim {d} padded to {hp}), freqs, mask (0, 768) on every row", err,
        _timings(lambda: att.packed_vision_attention(packed, h, d, **kw),
                 lambda: att.packed_attention_reference(packed, h, d, **kw), library),
        bound, SDPA, plan=(h, h, p, d),
    )
    del library
    return results


def check_long_decode(dev, gen) -> dict[str, dict]:
    """K3 at the longest cache the adapter builds (prompt bucket 8192 + generation
    bucket 512): q [8, 28, 128] against two layers of [8, 4, 8704, 128] in bf16,
    f32 and int8 with scales. The Hopper instance serves bf16 and int8 (1088
    keys a split, streamed through its ring), the general kernel f32 with its
    score rows in a device-memory workspace; ``_row`` reads which from the
    profiler. Rows keyed by kernel name, then label."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att

    b, nh, kvh, hd, s, layers = 8, 28, 4, 128, LONG_CACHE, 2
    starts = torch.tensor([0, 3, 17, 40, 64, 100, 191, 250], device=dev)
    spos = torch.arange(s, device=dev)
    mask = ((spos[None, :] >= starts[:, None]) & (spos[None, :] < s - 300)).to(torch.int32)
    rows: dict[str, dict] = {"gqa_decode_attention": {}, "gqa_decode_attention_int8": {}}

    def randn(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32), ("int8", torch.bfloat16)):
        q, ck, cv = (randn(dtype, *shape) for shape in ((b, nh, hd), (layers, b, kvh, s, hd), (layers, b, kvh, s, hd)))
        cache = quantize_kv_cache(ck, cv) if label == "int8" else (ck, cv)
        del ck, cv
        kernel = lambda: att.gqa_decode_attention(q, *cache[:2], 1, mask, *cache[2:])  # noqa: E731
        plain = lambda: att.gqa_decode_attention_plain(q, *cache[:2], 1, mask, *cache[2:])  # noqa: E731
        name = "gqa_decode_attention_int8" if label == "int8" else "gqa_decode_attention"
        got, want = kernel(), plain()
        atol, rel_bound = LONG_CACHE_TOL[label]
        err = _compare(f"{name}[S={s} {label}]", got, want, atol=atol, rtol=0.0, rel_l2=rel_bound)
        rel = _rel_l2(got.float(), want.float())
        log(f"{name}[S={s} {label}]: max abs err {err:.3e} (bound {atol}), relative L2 {rel:.3e} (bound {rel_bound})")
        del got, want
        shape = f"q [{b}, {nh}, {hd}] {'bf16' if dtype == torch.bfloat16 else 'f32'}, cache [{layers}, {b}, {kvh}, {s}, {hd}] {label}"
        if label == "int8":
            valid = int(mask.sum())
            bound = _bound(4.0 * hd * nh * valid, 2 * 2 * b * nh * hd + kvh * valid * (2 * hd + 2 * 4) + 4 * b * s)
            library, call = INT8_LIBRARY, None
            shape += " + f32 scales"
        else:
            elt = cache[0].element_size()
            bound = _attention_bound(mask, nh, kvh, 1, hd, causal=False, extra_bytes=4 * b * s, elt=elt)
            library, call = SDPA, _sdpa(q[:, :, None], cache[0][1], cache[1][1], mask.bool()[:, None, None, :])
        rows[name][f"S={s} {label}"] = dict(
            _row(shape, err, _timings(kernel, plain, call), bound, library),
            rel_l2=rel, atol=atol, rel_l2_bound=rel_bound,
        )
        del q, cache, call
        torch.cuda.empty_cache()
    return rows


def check_int4(dev, gen) -> dict:
    """K4 against its plain version on every 7B decode product at M = 96 and 8.
    Returns the gate/up M = 96 entry (the largest per-layer product) for the
    kernels line, with every shape's numbers under ``all``."""
    import torch

    from lmms_owc_tpu_torch.ops import int4_matmul as i4
    from lmms_owc_tpu_torch.ops.quant import quantize_int4

    rows = {}
    for name, (k, n) in INT4_SHAPES.items():
        qp = quantize_int4(torch.randn((n, k), generator=gen, device=dev) * 0.02)
        q4, scale = qp["q4"], qp["scale"]
        library, described = _int4_library(qp)
        del qp
        for m in INT4_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            want = i4.int4_matmul_plain(x, q4, scale)
            err = _compare(f"int4_matmul[{name}, M={m}]", i4.int4_matmul(x, q4, scale), want)
            call, lib_desc = None, described
            if library is not None:
                call = lambda: library(x)  # noqa: E731
                lib_desc += f"; max abs err vs the plain version {float((call().float() - want.float()).abs().max()):.3e}"
            t = _timings(lambda: i4.int4_matmul(x, q4, scale), lambda: i4.int4_matmul_plain(x, q4, scale), call)
            # Bytes: x, the packed weight, its f32 scales, the bf16 output.
            bound = _bound(2.0 * m * n * k, 2 * m * k + n * k // 2 + 4 * n * (k // 128) + 2 * m * n)
            rows[f"{name} M={m}"] = _row(f"x [{m}, {k}] bf16, q4 [{n}, {k // 2}] int8, scale [{n}, {k // 128}]",
                                         err, t, bound, lib_desc)
            log(f"parity int4_matmul {name} (K={k}, N={n}) M={m}: max abs err {err:.3e}; per call kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']} ms; device kernel "
                f"{t['device_ms']} ms, plain {t['plain_device_ms']} ms, library {t['library_device_ms']} ms; "
                f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        # A row's bits do not depend on the rows beside it: the split plan is
        # a function of (K, N), so the pooled call's first rows equal the
        # unpooled call on those rows.
        x = torch.randn((max(INT4_ROWS), k), generator=gen, device=dev).to(torch.bfloat16)
        m = min(INT4_ROWS)
        if not torch.equal(i4.int4_matmul(x, q4, scale)[:m], i4.int4_matmul(x[:m].contiguous(), q4, scale)):
            raise AssertionError(f"int4_matmul[{name}]: rows 0-{m - 1} of an M = {len(x)} call differ from an M = {m} call")
        del q4, scale, library
        torch.cuda.empty_cache()
    head = dict(rows["gate/up M=96"])
    head["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    head["shape"] = "gate/up " + head["shape"] + " (max abs err over all shapes)"
    head["all"] = rows
    head["decode_step_m8"] = _int4_step(rows, min(INT4_ROWS))
    log(f"int4_matmul: rows bit-equal between M = {max(INT4_ROWS)} and M = {min(INT4_ROWS)} calls on every product; "
        f"one decode step at M = {min(INT4_ROWS)}: {json.dumps(head['decode_step_m8'])}")
    return head


def _int4_step(rows: dict, m: int) -> dict:
    """Device ms of one int4 decode step's K4 calls at ``m`` rows: each of the
    28 layers runs q, o, k, v, gate, up and down, then the head runs once
    (``MIN_LAUNCHES_PER_DECODE_STEP``), with the library's and the bound's sums."""
    per_layer = {"q/o": 2, "k/v": 2, "gate/up": 2, "down": 1}
    calls = {**{f"{p} M={m}": 28 * c for p, c in per_layer.items()}, f"lm_head M={m}": 1}
    assert sum(calls.values()) == MIN_LAUNCHES_PER_DECODE_STEP["int4_matmul"]

    def total(key):
        vals = [rows[r][key] for r in calls]
        return None if None in vals else sum(c * v for c, v in zip(calls.values(), vals))

    return dict(launches=sum(calls.values()), device_ms=total("device_ms"),
                library_device_ms=total("library_device_ms"), bound_ms=total("bound_ms"))


def _int4_library(qp: dict):
    """``(fn, description)``: ``fn(x)`` is one ``torch._weight_int4pack_mm`` call on
    the weight repacked once by ``torch._convert_weight_to_int4pack`` (unsigned
    nibbles q + 8 with zero point 0, bf16 scales, group 128); ``(None, reason)``
    when the installed torch does not take that form."""
    import torch

    from lmms_owc_tpu_torch.ops.quant import unpack_int4

    try:
        w = unpack_int4(qp).to(torch.int32) + 8  # [N, K] in [1, 15]
        n, k = w.shape
        packed = torch._convert_weight_to_int4pack((w[:, ::2] << 4 | w[:, 1::2]).to(torch.uint8), 8)
        scales = qp["scale"].t().to(torch.bfloat16)  # [K/128, N]
        scale_zeros = torch.stack([scales, torch.zeros_like(scales)], dim=-1).contiguous()
        fn = lambda x: torch._weight_int4pack_mm(x, packed, 128, scale_zeros)  # noqa: E731
        fn(torch.zeros((8, k), dtype=torch.bfloat16, device=w.device))
    except (RuntimeError, AttributeError, TypeError) as err:
        return None, f"none: torch._weight_int4pack_mm at group 128 with zero points 0 failed here ({err})"[:300]
    return fn, "torch._weight_int4pack_mm on the weight repacked once (bf16 scales, zero points 0, group 128)"


def check_ragged_bf16(dev, gen) -> None:
    """The Hopper instances at ragged bf16 shapes the main paths also reach
    (prompt buckets such as 288 are not multiples of the 64-key tile; the
    decode cache splits unevenly; head_dim 72 padded to 80 columns), and K3's
    at head_dim 64 in bf16 and int8, within TOL of the plain versions."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    errs = {}
    # Prefill at a 288-key bucket, causal GQA with left padding (D = 128).
    b, l = 3, 288
    q, k, v = randn(b, 28, l, 128), randn(b, 4, l, 128), randn(b, 4, l, 128)
    starts = torch.tensor([0, 37, 200], device=dev)
    pos = torch.arange(l, device=dev)
    keys = (pos[None, :] >= starts[:, None]).to(torch.int32)
    got = att.flash_attention(q, k, v, causal=True, kv_mask=keys, kv_mask_contiguous=True)
    rows = (pos[None, :] >= starts[:, None])[:, None, :].expand(b, 28, l)
    errs["prefill L=288"] = _compare("flash_attention[L=288]", got,
                                     att.flash_attention_plain(q, k, v, causal=True, kv_mask=keys), rows)
    # Vision at 200 patches (D = 80, one 192-row block and a 8-row tail), rope, a short row.
    qkv = randn(2, 200, 3 * 16 * 80)
    cos, sin = torch.cos(randn(2, 200, 40).float()), torch.sin(randn(2, 200, 40).float())
    vmask = torch.ones((2, 200), dtype=torch.int32, device=dev)
    vmask[1, 130:] = 0
    kw = dict(kv_mask=vmask, rope_cos=cos, rope_sin=sin)
    errs["vision L=200"] = _compare("vision_qkv_attention[L=200]", att.vision_qkv_attention(qkv, 16, 80, **kw),
                                    att.vision_qkv_attention_plain(qkv, 16, 80, **kw))
    # Vision at 16 patches (phase 12's 56x56 toy images: one short q block), 12 images.
    qkv = randn(12, 16, 3 * 16 * 80)
    kw = dict(kv_mask=torch.ones((12, 16), dtype=torch.int32, device=dev), rope_cos=cos[:1, :16].expand(12, 16, 40),
              rope_sin=sin[:1, :16].expand(12, 16, 40))
    errs["vision L=16"] = _compare("vision_qkv_attention[L=16]", att.vision_qkv_attention(qkv, 16, 80, **kw),
                                   att.vision_qkv_attention_plain(qkv, 16, 80, **kw))
    # The tensor mask with holes: one 64-row q block (keys rotated in the kernel), and two blocks.
    for length in (64, 200):
        x = randn(2, length, 48, 80)
        gappy = (torch.rand((2, length), generator=gen, device=dev) > 0.3).to(torch.int32)
        gappy[:, 0] = 1
        c, s_ = cos[:, :length], sin[:, :length]
        kw = dict(kv_mask=gappy, rope_cos=c, rope_sin=s_, token_major=True)
        errs[f"combined L={length}"] = _compare(
            f"fused_qkv_attention[L={length}]", att.fused_qkv_attention(x, 16, 16, **kw),
            att.fused_qkv_attention_plain(x, 16, 16, **kw))
    # Head_dims 72 (the SigLIP towers) and 88 (BLIP ViT-g): the Hopper instance
    # over 200 keys with a gappy mask (a 192-row block and a tail) and over one
    # short block; with rope, which the Hopper instance does not take at 72 or
    # 88, the general one. Head_dim 96 (Phi-3-mini) takes rope in the Hopper
    # instance: in the kernel over one short block, through the keys'
    # pre-pass over two blocks.
    cases = ((200, True, False), (50, False, False), (50, False, True))
    for d, length, masked, rope in [(d, *case) for d in (72, 88, 96)
                                    for case in cases + (((200, False, True),) if d == 96 else ())]:
        q, k, v = (randn(2, 16, length, d) for _ in range(3))
        kw = {}
        if masked:
            kw["kv_mask"] = (torch.rand((2, length), generator=gen, device=dev) > 0.3).to(torch.int32)
            kw["kv_mask"][:, 0] = 1
        if rope:
            angles = randn(2, length, d // 2).float()
            kw.update(rope_cos=torch.cos(angles), rope_sin=torch.sin(angles))
        label = f"D={d} L={length}{' gappy' if masked else ''}{' rope' if rope else ''}"
        errs[label] = _compare(f"flash_attention[{label}]", att.flash_attention(q, k, v, **kw),
                               att.flash_attention_plain(q, k, v, **kw))
    # Decode with uneven splits: S = 100 (2 x 64) in bf16, S = 520 (7 x 80) with an int8 cache, and
    # head_dim 64 (no main path decodes at 64) at 520 and at 2112 (8 x 272: five tiles a split).
    for s, int8, d in ((100, False, 128), (520, True, 128), (520, False, 64), (2112, True, 64)):
        qd, ck, cv = randn(5, 28, d), randn(2, 5, 4, s, d), randn(2, 5, 4, s, d)
        dmask = (torch.rand((5, s), generator=gen, device=dev) > 0.2).to(torch.int32)
        cache = quantize_kv_cache(ck, cv) if int8 else (ck, cv)
        errs[f"decode D={d} S={s}{' int8' if int8 else ''}"] = _compare(
            f"gqa_decode_attention[S={s}]", att.gqa_decode_attention(qd, *cache[:2], 1, dmask, *cache[2:]),
            att.gqa_decode_attention_plain(qd, *cache[:2], 1, dmask, *cache[2:]))
    log(f"ragged bf16 shapes (decode splits {att.decode_split_plan(100)} and {att.decode_split_plan(520)}): "
        f"max abs errs {errs}")


def check_f32_kernels(dev, gen) -> None:
    """The kernels' f32 forms at small, ragged shapes (not on the bf16 main path)."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att
    from lmms_owc_tpu_torch.ops import int4_matmul as i4
    from lmms_owc_tpu_torch.ops.quant import quantize_int4

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    tol = 1e-4  # f32 in, f32 out: summation order only
    qkv = randn(2, 200, 3 * 4 * 80)
    cos, sin = torch.cos(randn(2, 200, 40)), torch.sin(randn(2, 200, 40))
    vmask = torch.ones((2, 200), dtype=torch.int32, device=dev)
    vmask[1, 150:] = 0
    kw = dict(kv_mask=vmask, rope_cos=cos, rope_sin=sin)
    errs = [(att.vision_qkv_attention(qkv, 4, 80, **kw) - att.vision_qkv_attention_plain(qkv, 4, 80, **kw)).abs().max()]
    q, k, v = randn(2, 4, 130, 64), randn(2, 2, 130, 64), randn(2, 2, 130, 64)
    pmask = torch.ones((2, 130), dtype=torch.int32, device=dev)
    pmask[1, :70] = 0
    got = att.flash_attention(q, k, v, causal=True, kv_mask=pmask, kv_mask_contiguous=True)
    want = att.flash_attention_plain(q, k, v, causal=True, kv_mask=pmask)
    errs.append(torch.cat([(got - want)[0].flatten(), (got - want)[1, :, 70:].flatten()]).abs().max())
    gappy = (randn(2, 130) > -0.5).to(torch.int32)  # K2's tensor mask, non-causal
    gappy[:, 3] = 1
    errs.append((att.flash_attention(q, k, v, kv_mask=gappy) - att.flash_attention_plain(q, k, v, kv_mask=gappy)).abs().max())
    qkvh = randn(2, 100, 3 * 2 * 80)
    fmask = (randn(2, 100) > -0.5).to(torch.int32)
    fmask[:, 0] = 1
    kw = dict(kv_mask=fmask, rope_cos=cos[:, :100], rope_sin=sin[:, :100], token_major=True)
    errs.append((att.fused_qkv_attention(qkvh.view(2, 100, 6, 80), 2, 2, **kw)
                 - att.fused_qkv_attention_plain(qkvh.view(2, 100, 6, 80), 2, 2, **kw)).abs().max())
    # The 3xTF32 instance's 4-byte copies (rows with a 65-element stride, not
    # 16-byte aligned), causal over two key tiles, and head_dim 16 with runs.
    q, k, v = (randn(2, 4, 130, 65)[..., :64] for _ in range(3))
    errs.append((att.flash_attention(q, k, v, causal=True) - att.flash_attention_plain(q, k, v, causal=True)).abs().max())
    q, k, v = (randn(3, 4, 40, 16) for _ in range(3))
    rmask = torch.ones((3, 40), dtype=torch.int32, device=dev)
    rmask[1, 33:] = 0
    rmask[2, :9] = 0
    got = att.flash_attention(q, k, v, kv_mask=rmask, kv_mask_contiguous=True)
    errs.append((got - att.flash_attention_plain(q, k, v, kv_mask=rmask)).abs().max())
    qd, ck, cv = randn(2, 8, 64), randn(3, 2, 2, 100, 64), randn(3, 2, 2, 100, 64)
    dmask = torch.ones((2, 100), dtype=torch.int32, device=dev)
    dmask[0, :30] = 0
    errs.append((att.gqa_decode_attention(qd, ck, cv, 1, dmask) - att.gqa_decode_attention_plain(qd, ck, cv, 1, dmask)).abs().max())
    cache8 = quantize_kv_cache(ck, cv)
    errs.append((att.gqa_decode_attention(qd, *cache8[:2], 1, dmask, *cache8[2:])
                 - att.gqa_decode_attention_plain(qd, *cache8[:2], 1, dmask, *cache8[2:])).abs().max())
    x = randn(5, 512)
    for group in (128, 64, 8):  # 8: scales change inside a 16-byte weight load
        qp = quantize_int4(randn(256, 512) * 0.02, group=group)
        errs.append((i4.int4_matmul(x, qp["q4"], qp["scale"]) - i4.int4_matmul_plain(x, qp["q4"], qp["scale"])).abs().max())
    errs = [float(e) for e in errs]
    log(f"f32 forms (vision D=80, prefill D=64 L=130, the same with a gappy mask, combined qkv D=80 "
        f"L=100 with a gappy mask, D=64 L=130 causal on a 65-element row stride, D=16 L=40 with runs, "
        f"decode D=64 with an f32 and an int8 cache, "
        f"int4 M=5 K=512 N=256 in groups of 128, 64, 8): max abs errs {errs}")
    if not all(e <= tol for e in errs):
        raise AssertionError(f"f32 kernel forms disagree with their plain versions beyond {tol}: {errs}")


def _requests(model, sizes=None, max_new_tokens: int = MAX_NEW_TOKENS):
    """Image requests as the JAX bench builds them; by default 8: six 448x448
    and two 336x448 images, ``MAX_NEW_TOKENS`` greedy tokens."""
    from PIL import Image

    rng = np.random.RandomState(0)
    sizes = sizes or [(448, 448)] * 6 + [(336, 448)] * 2
    docs = [
        {"image": Image.fromarray(rng.randint(0, 255, (hh, ww, 3), dtype=np.uint8))}
        for hh, ww in sizes
    ]

    class _Task:
        dataset = {"test": docs}

    model.task_dict["smoke"] = _Task()
    gen_kwargs = {"max_new_tokens": max_new_tokens, "do_sample": False, "until": None}

    class _Req:
        def __init__(self, doc_id):
            self.args = (PROMPT, gen_kwargs, lambda doc: [doc["image"]], doc_id, "smoke", "test")

    return [_Req(i) for i in range(len(docs))]


def serve_bf16(dev, model_id: str, sizes, min_launches: dict[str, int], label: str,
               per_call=(), host_timers: bool = False, **model_kwargs) -> tuple[object, list, dict]:
    """The registered model ``model_id`` with random bf16 weights drawn on
    the card answers 8 image requests through generate_until (a warm-up
    call, then the measured one, with :func:`_serve`'s ``per_call`` and
    ``host_timers``); each kernel in ``min_launches`` must have run at least
    that often. ``model_kwargs`` go to ``get_model``."""
    import torch

    from lmms_owc_tpu_torch.models import get_model

    t0 = time.perf_counter()
    model = get_model(
        model_id, random_init=True, dtype="bfloat16", batch_size=NUM_REQUESTS,
        device=str(dev), time_phases=True, **model_kwargs,
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.model.parameters())
    log(f"{model_id}: {n_params / 1e9:.3f} B parameters drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = _requests(model, sizes)
    model.generate_until(requests)  # warm-up: cuBLAS handles, allocator, kernel library
    run = _serve(model, requests, per_call=per_call, host_timers=host_timers)
    _log_run(label, run)
    for name, least in min_launches.items():
        if run["counts"][name] < least:
            raise AssertionError(f"{name} launched {run['counts'][name]} times in the {model_id} run, expected >= {least}")
    return model, requests, run


def run_main_path(dev) -> tuple[object, list, dict[str, int]]:
    """Phase 3: Qwen2-VL-7B random bf16 weights, 8 requests through generate_until."""
    model, requests, run = serve_bf16(dev, "qwen2-vl-7b", None, MIN_LAUNCHES, "bf16, unpooled")
    return model, requests, run["counts"]


def run_v25(dev) -> tuple[dict, object, list]:
    """Phase 7: Qwen2.5-VL-7B random bf16 weights, six 448x448 and two 392x448
    requests through generate_until, then phase 4's bf16 logits rule. Returns
    the run, the model and its requests (phase 9 writes the model out)."""
    model, requests, run = serve_bf16(
        dev, "qwen2.5-vl-7b", V25_SIZES, MIN_LAUNCHES_V25, "qwen2.5-vl-7b bf16, unpooled"
    )
    run["logits"] = check_bf16_logits(model, requests, "qwen2.5-vl-7b bf16")
    return run, model, requests


def _exact_flash(q, k, v, **kw):
    """Plain attention in f32 on the given (bf16) operands, rounded once on the way out."""
    return _plain_flash(q.float(), k.float(), v.float(), **kw).to(q.dtype)


def _exact_vision(qkv, num_heads, head_dim, **kw):
    from lmms_owc_tpu_torch.ops import attention as att

    return att.vision_qkv_attention_plain(qkv.float(), num_heads, head_dim, **kw).to(qkv.dtype)


def _exact_fused(qkvh, num_q_heads, num_kv_heads, **kw):
    from lmms_owc_tpu_torch.ops import attention as att

    return att.fused_qkv_attention_plain(qkvh.float(), num_q_heads, num_kv_heads, **kw).to(qkvh.dtype)


def _plain_flash(*args, kv_mask_contiguous=False, **kw):
    from lmms_owc_tpu_torch.ops import attention as att

    return att.flash_attention_plain(*args, **kw)


@contextmanager
def _attention(**fns):
    """Route the model's attention entries, by name, through other functions
    (``flash_attention`` in the decoder, the CLIP towers, the SigLIP tower,
    InternViT and BLIP ViT)."""
    from lmms_owc_tpu_torch.nn import clip as nnclip
    from lmms_owc_tpu_torch.nn import idefics2 as nnidf
    from lmms_owc_tpu_torch.nn import instructblip as nnib
    from lmms_owc_tpu_torch.nn import internvl as nniv
    from lmms_owc_tpu_torch.nn import qwen2_5_vl as nnq25
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    with ExitStack() as stack:
        for name, fn in fns.items():
            stack.enter_context(_route(nnq25 if name == "fused_qkv_attention" else nnq, name, fn))
            if name == "flash_attention":
                for module in (nnclip, nnidf, nniv, nnib):
                    stack.enter_context(_route(module, name, fn))
        yield


def _plain_attention():
    from lmms_owc_tpu_torch.ops import attention as att

    return _attention(
        flash_attention=_plain_flash, vision_qkv_attention=att.vision_qkv_attention_plain,
        fused_qkv_attention=att.fused_qkv_attention_plain,
        packed_vision_attention=att.packed_attention_reference,
    )


def _rel_l2(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _chunk_logits(model, requests):
    """Last-position prefill logits of one chunk of requests (vision tower, then prefill)."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import prefill

    rows, vision_flat = model._prepare_requests_batch([r.args for r in requests])
    embeds, pos, mask, _, bucket = model._build_batch_inputs(rows, vision_flat)
    out, _ = prefill(
        model.model, embeds, torch.from_numpy(pos).to(model.device),
        torch.from_numpy(mask.astype(np.int32)).to(model.device), bucket,
    )
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("prefill logits have non-finite values")
    return out


def check_bf16_logits(model, requests, label: str) -> dict[str, float]:
    """Phase 4's bf16 rule on one chunk's prefill logits (:func:`_bf16_logits_rule`)."""
    return _bf16_logits_rule(lambda: _chunk_logits(model, requests), label)


def _bf16_logits_rule(logits, label: str) -> dict[str, float]:
    """Phase 4's bf16 rule on the logits that ``logits()`` computes. The kernel
    and plain paths differ by bf16 rounding amplified through the random
    layers, and so does the plain path from the same model with its attention
    computed in f32 ("exact"); the kernel path must be no farther from exact
    than the plain path is (with 25% headroom)."""
    got = logits()
    with _plain_attention():
        plain = logits()
    with _attention(flash_attention=_exact_flash, vision_qkv_attention=_exact_vision,
                    fused_qkv_attention=_exact_fused):
        exact = logits()
    rel = {
        "kernel_vs_plain": _rel_l2(got, plain),
        "kernel_vs_exact": _rel_l2(got, exact),
        "plain_vs_exact": _rel_l2(plain, exact),
    }
    log(f"{label}: prefill logits {tuple(got.shape)} relative L2 {rel}")
    if rel["kernel_vs_exact"] > max(LOGITS_REL_L2, 1.25 * rel["plain_vs_exact"]):
        raise AssertionError(f"{label}: kernel path farther from f32 attention than the plain path: {rel}")
    return rel


def check_whole_model(model, requests) -> dict[str, float]:
    """Phase 4: last-position prefill logits of one chunk (vision tower, then
    prefill), through the kernels and through the plain versions: in bf16 by
    :func:`check_bf16_logits`, then with the weights in f32, kernel path
    against plain path within LOGITS_REL_L2.
    """
    rel = check_bf16_logits(model, requests, "whole model bf16")
    model.model.float()
    got = _chunk_logits(model, requests)
    with _plain_attention():
        plain = _chunk_logits(model, requests)
    rel["f32_kernel_vs_plain"] = _rel_l2(got, plain)
    log(f"whole model f32: relative L2 kernel vs plain {rel['f32_kernel_vs_plain']:.3e} "
        f"(bound {LOGITS_REL_L2}), argmax agreement {float((got.argmax(-1) == plain.argmax(-1)).float().mean()):.3f}")
    if rel["f32_kernel_vs_plain"] > LOGITS_REL_L2:
        raise AssertionError(f"f32 prefill logits relative L2 {rel['f32_kernel_vs_plain']:.3e} > {LOGITS_REL_L2}")
    return rel


def check_packed_tower(model, requests) -> dict:
    """Phase 8: the Qwen2-VL tower packed (K5) and unpacked (K1) on the same
    images, through the kernels and through the plain versions."""
    import torch

    images = [model._fetch_visuals(r.args)[0] for r in requests]

    def encode(mode: str):
        with _env(LMMS_OWC_VISION_PACKED=mode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flat, spans, _ = model._encode_images_flat(images)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        real = torch.cat([flat[off : off + count] for off, count in spans]).float()  # rows of real patches
        if not bool(torch.isfinite(real).all()):
            raise AssertionError(f"packed={mode!r}: vision embeddings have non-finite values")
        return real, seconds

    encode("1")  # builds the padded weights once
    runs = {}
    for mode in ("1", "", "1", ""):  # packed, unpacked, packed, unpacked: the second pair is kept
        _reset_counts()
        out, seconds = encode(mode)
        runs[mode] = (out, seconds, _counts())
    (packed, packed_s, packed_counts), (unpacked, unpacked_s, unpacked_counts) = runs["1"], runs[""]
    if packed_counts["packed_vision_attention"] != PACKED_LAUNCHES or packed_counts["vision_qkv_attention"]:
        raise AssertionError(f"packed tower launches {packed_counts}, expected {PACKED_LAUNCHES} packed")
    if unpacked_counts["vision_qkv_attention"] != PACKED_LAUNCHES or unpacked_counts["packed_vision_attention"]:
        raise AssertionError(f"unpacked tower launches {unpacked_counts}, expected {PACKED_LAUNCHES} unpacked")
    with _plain_attention():
        plain_packed, _ = encode("1")
        plain_unpacked, _ = encode("")
    rel = {
        "kernel_packed_vs_unpacked": _rel_l2(packed, unpacked),
        "plain_packed_vs_unpacked": _rel_l2(plain_packed, plain_unpacked),
        "packed_kernel_vs_plain": _rel_l2(packed, plain_packed),
    }
    bound = max(PACKED_REL_L2, 1.25 * rel["plain_packed_vs_unpacked"])
    log(f"packed tower ({len(images)} images, {tuple(packed.shape)} real rows): relative L2 {rel} (bound "
        f"{bound:.3e}); vision seconds packed {packed_s:.4f}, unpacked {unpacked_s:.4f}; "
        f"launches {packed_counts['packed_vision_attention']}")
    if rel["kernel_packed_vs_unpacked"] > bound:
        raise AssertionError(f"packed tower disagrees with the unpacked one beyond {bound:.3e}: {rel}")
    return dict(rel, bound=bound, packed_seconds=packed_s, unpacked_seconds=unpacked_s,
                launches=packed_counts["packed_vision_attention"])


@contextmanager
def _env(**values):
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


@contextmanager
def _route(module, name, fn):
    """Point ``module.name`` at ``fn`` for the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextmanager
def _per_call(*entries):
    """Wrap each ``(module, name)`` of ``entries``: every call appends the
    launches it made (the counters' difference across it, non-zero kernels
    only) to a list; yields {name: [per-call launches]}."""
    calls: dict[str, list] = {}
    with ExitStack() as stack:
        for module, name in entries:
            real, seen = getattr(module, name), calls.setdefault(name, [])

            def spy(*args, _real=real, _seen=seen, **kw):
                before = _counts()
                out = _real(*args, **kw)
                after = _counts()
                _seen.append({k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)})
                return out

            stack.enter_context(_route(module, name, spy))
        yield calls


@contextmanager
def _decode_steps(capture: dict | None = None):
    """Counts decode steps (yields the list of calls); with ``capture``, keeps a
    copy of the first step's inputs."""
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    real = nnq.decode_step
    calls = []

    def spy(model, token_ids, position_ids, cache, cache_pos, kv_mask, *rest):
        if capture is not None and not capture:
            capture.update(
                token_ids=token_ids.clone(), position_ids=position_ids.clone(),
                cache=tuple(c.clone() for c in cache), cache_pos=cache_pos, kv_mask=kv_mask.clone(),
            )
        calls.append(1)
        return real(model, token_ids, position_ids, cache, cache_pos, kv_mask, *rest)

    with _route(nnq, "decode_step", spy):
        yield calls


@contextmanager
def _tokens(model, out: list):
    """Collects the token arrays ``generate_until`` detokenizes, in order."""
    detok = model._detokenize
    model._detokenize = lambda tokens: out.append(np.asarray(tokens).copy()) or detok(tokens)
    try:
        yield out
    finally:
        del model._detokenize


@contextmanager
def _host_timers():
    """The port's host stage timers (``LMMS_OWC_HOST_PROF``) on for the block,
    from zero; yields a list that receives the lines of their table."""
    import io
    from contextlib import redirect_stdout

    from lmms_owc_tpu_torch.utils import _hostprof

    saved, table = _hostprof.ENABLED, []
    _hostprof.ENABLED = True
    _hostprof.hostprof_reset()
    try:
        yield table
        out = io.StringIO()
        with redirect_stdout(out):
            _hostprof.hostprof_dump("generate_until")
        table.extend(line.strip() for line in out.getvalue().splitlines())
    finally:
        _hostprof.ENABLED = saved
        _hostprof.hostprof_reset()


def _serve(model, requests, tokens: list | None = None, require_text: bool = True, per_call=(),
           host_timers: bool = False) -> dict:
    """One measured generate_until with the counts set to 0 just before it.
    ``require_text``: every answer must be a non-empty string (off where a
    checkpoint's tokenizer decodes the random model's tokens, which may all
    lie past its vocabulary; the tokens are compared instead). ``per_call``:
    ``(module, name)`` entries whose launches are read around each call
    (:func:`_per_call`), returned as ``per_call``. ``host_timers``: the port's
    host stage timers run for the call, and their table is returned as
    ``hostprof`` (host time only: no span waits for the device)."""
    import torch

    model.phase_seconds.clear()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with ExitStack() as stack:
        table = stack.enter_context(_host_timers()) if host_timers else None
        calls = stack.enter_context(_per_call(*per_call))
        steps = stack.enter_context(_decode_steps())
        stack.enter_context(_tokens(model, tokens if tokens is not None else []))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs = model.generate_until(requests)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = _counts()
    if len(outputs) != len(requests) or not all(isinstance(o, str) and (o or not require_text) for o in outputs):
        raise AssertionError(f"expected {len(requests)} non-empty strings, got {outputs[:4]!r}...")
    return dict(
        images=len(requests), seconds=seconds, images_per_s=len(requests) / seconds,
        phase_seconds={k: round(v, 4) for k, v in model.phase_seconds.items()},
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, decode_steps=len(steps), counts=counts,
        sample=outputs[0][:60], **({"per_call": calls} if per_call else {}),
        **({"hostprof": table} if host_timers else {}),
    )


def _check_min_per_step(run: dict, name: str) -> None:
    least = MIN_LAUNCHES_PER_DECODE_STEP[name] * run["decode_steps"]
    if run["decode_steps"] == 0 or run["counts"][name] < least:
        raise AssertionError(
            f"{name} launched {run['counts'][name]} times over {run['decode_steps']} decode steps, "
            f"expected >= {least}"
        )


def _step_logits(model, cap):
    """One decode step on a fresh copy of captured inputs -> logits [B, vocab] f32."""
    import torch

    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    cache = tuple(c.clone() for c in cap["cache"])
    out = nnq.decode_step(model.model, cap["token_ids"], cap["position_ids"], cache, cap["cache_pos"],
                          cap["kv_mask"].clone())
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("decode-step logits have non-finite values")
    return out


def check_decode_step(model, cap, module, name, plain, exact, label: str) -> dict:
    """Phase 4's rule on one decode step: the kernel path's logits may be no
    farther from the f32 ("exact") path than the plain path is (+25%), or
    within LOGITS_REL_L2 of it."""
    got = _step_logits(model, cap)
    with _route(module, name, plain):
        want = _step_logits(model, cap)
    with _route(module, name, exact):
        ref = _step_logits(model, cap)
    rel = {
        "kernel_vs_plain": _rel_l2(got, want),
        "kernel_vs_exact": _rel_l2(got, ref),
        "plain_vs_exact": _rel_l2(want, ref),
        "argmax_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
    }
    log(f"{label}: one decode step, logits {tuple(got.shape)}: {rel}")
    if rel["kernel_vs_exact"] > max(LOGITS_REL_L2, 1.25 * rel["plain_vs_exact"]):
        raise AssertionError(f"{label}: kernel path farther from the f32 path than the plain path: {rel}")
    return rel


def _log_run(label: str, run: dict) -> None:
    log(f"{label}: {run['images']} images in {run['seconds']:.3f} s = {run['images_per_s']:.3f} images/s; "
        f"phase seconds {run['phase_seconds']}; peak device memory {run['peak_gb']:.3f} GB; "
        f"{run['decode_steps']} decode steps; launches {run['counts']}; sample {run['sample']!r}")


def _free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def run_quantized_pool(dev) -> dict:
    """Phase 5: int8 weights, W8A8, a decode pool of 2 and the int8 KV cache."""
    import torch

    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq
    from lmms_owc_tpu_torch.nn.layers import set_int8_activations
    from lmms_owc_tpu_torch.ops import attention as att

    with _env(LMMS_OWC_DECODE_POOL="2", LMMS_OWC_KV_INT8="1"):
        t0 = time.perf_counter()
        model = get_model(
            "qwen2-vl-7b", random_init=True, dtype="bfloat16", batch_size=POOL_BATCH, device=str(dev),
            time_phases=True, load_in_8bit=True, int8_activations=True,
        )
        torch.cuda.synchronize()
        log(f"qwen2-vl-7b int8: weights drawn and quantized on the card in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
        set_int8_activations(False)  # phase 3b's check in weight-only int8 first
        try:
            weight_only = check_pool_rows(model, "int8 weight-only")
        finally:
            set_int8_activations(True)
        requests = _requests(model, [(448, 448)] * POOL_REQUESTS)
        capture: dict = {}
        with _decode_steps(capture):
            model.generate_until(requests)  # warm-up; keeps one pooled decode step's inputs
        pooled_tokens: list = []
        run = _serve(model, requests, pooled_tokens)
        _log_run("int8 + W8A8 + pool 2 + int8 KV", run)
        _check_min_per_step(run, "gqa_decode_attention_int8")
        if len(pooled_tokens) != 1 or pooled_tokens[0].shape[0] != POOL_REQUESTS:
            raise AssertionError(f"expected one pool of {POOL_REQUESTS} rows, got {[t.shape for t in pooled_tokens]}")

        os.environ["LMMS_OWC_DECODE_POOL"] = "1"
        unpooled_tokens: list = []
        unpooled = _serve(model, requests, unpooled_tokens)
        _log_run("int8 + W8A8 + int8 KV, unpooled", unpooled)
        same = (np.concatenate(pooled_tokens) == np.concatenate(unpooled_tokens)).all(axis=1)
        run["unpooled_same_rows"] = float(same.mean())
        log(f"rows with the same tokens pooled and unpooled: {int(same.sum())} of {same.size} = "
            f"{run['unpooled_same_rows']:.4f} (required >= {MIN_POOL_AGREEMENT})")
        if run["unpooled_same_rows"] < MIN_POOL_AGREEMENT:
            raise AssertionError(f"pooled and unpooled tokens agree on {run['unpooled_same_rows']:.4f} of the rows")
        run["tp_reference"] = tp_reference(model, _requests(model))  # phase 25's W8A8 bar, unpooled

        def exact(q, ck, cv, i, mask, *scales):
            return att.gqa_decode_attention_plain(q.float(), ck, cv, i, mask, *scales).to(q.dtype)

        run["decode_step"] = check_decode_step(
            model, capture, nnq, "gqa_decode_attention", att.gqa_decode_attention_plain, exact,
            "int8 pool decode step (int8 decode kernel vs plain)",
        )
    set_int8_activations(False)
    run["pool_rows_int8_weight_only"] = weight_only
    del model, capture
    _free()
    return run


def _pool_pair(model, requests, label: str, kv_int8: bool = False, per_call=()):
    """``requests`` decoded unpooled and under ``LMMS_OWC_DECODE_POOL=2`` (the
    bf16 cache, or with ``kv_int8`` the int8 one; prompt order): (rows with
    the same tokens [bool], unpooled run, pooled run)."""
    tokens: dict[str, list] = {}
    runs = {}
    with _env(LMMS_OWC_SORT_BY_VISION="0", LMMS_OWC_KV_INT8="1" if kv_int8 else ""):
        for pool in ("1", "2"):
            with _env(LMMS_OWC_DECODE_POOL=pool):
                tokens[pool] = []
                runs[pool] = _serve(model, requests, tokens[pool], **({"per_call": per_call} if per_call else {}))
    if len(tokens["1"]) != 2 or len(tokens["2"]) != 1:
        raise AssertionError(f"{label}: expected two chunks unpooled and one pool, got {len(tokens['1'])} and "
                             f"{len(tokens['2'])} decodes")
    return (np.concatenate(tokens["1"]) == tokens["2"][0]).all(axis=1), runs["1"], runs["2"]


def check_pool_rows(model, label: str, sizes=None) -> dict:
    """Phase 3b (ROADMAP Queue 3): phase 3's 8 requests (or 8 of ``sizes``)
    in prompt order at batch ``POOL_CHECK_BATCH`` (two chunks of 4), decoded
    unpooled and under ``LMMS_OWC_DECODE_POOL=2`` (one pool of 8 rows); every
    row must give the same tokens. The adapter passes ``DECODE_ROWS`` to the
    decode, which pads to those row blocks the products whose bits depend on
    the row count."""
    from lmms_owc_tpu_torch.models.qwen2_vl import DECODE_ROWS

    if model.decode_rows != DECODE_ROWS:
        raise AssertionError(f"{label}: the adapter decodes on {model.decode_rows}-row blocks, not {DECODE_ROWS}")
    requests = _requests(model, sizes)
    saved = model.batch_size
    model.batch_size = POOL_CHECK_BATCH
    try:
        same, unpooled, pooled = _pool_pair(model, requests, label)
    finally:
        model.batch_size = saved
    out = dict(rows=int(same.size), same_rows=int(same.sum()), decode_rows=DECODE_ROWS,
               seconds={"unpooled": unpooled["seconds"], "pool2": pooled["seconds"]},
               decode_seconds={"unpooled": unpooled["phase_seconds"].get("decode"),
                               "pool2": pooled["phase_seconds"].get("decode")},
               decode_steps={"unpooled": unpooled["decode_steps"], "pool2": pooled["decode_steps"]})
    log(f"pooled vs unpooled ({label}): {json.dumps(out)}")
    if not same.all():
        raise AssertionError(f"{label}: pooled tokens differ from unpooled ones on rows {np.nonzero(~same)[0].tolist()}")
    return out


def run_int4(dev, preset: str = "qwen2-vl-7b", sizes=None) -> dict:
    """Phase 6 (and phase 7b's int4 half with ``qwen2.5-vl-7b`` on phase 7's
    sizes): int4 weights, 8 requests unpooled; K4 on every decode-step
    product (197 in every step) and one step's logits through K4 held to the
    plain version; then phase 3b's check that pooled tokens equal unpooled ones."""
    import torch

    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.nn import layers
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq
    from lmms_owc_tpu_torch.ops import int4_matmul as i4
    from lmms_owc_tpu_torch.ops.quant import dequantize_int4

    label = f"{preset} int4"
    with _env(LMMS_OWC_DECODE_POOL="1", LMMS_OWC_KV_INT8=""):
        t0 = time.perf_counter()
        model = get_model(
            preset, random_init=True, dtype="bfloat16", batch_size=NUM_REQUESTS, device=str(dev),
            time_phases=True, load_in_4bit=True,
        )
        torch.cuda.synchronize()
        log(f"{label}: weights drawn and quantized on the card in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
        requests = _requests(model, sizes)
        capture: dict = {}
        with _decode_steps(capture):
            model.generate_until(requests)  # warm-up; keeps one decode step's inputs
        run = _serve(model, requests, per_call=((nnq, "decode_step"),))
        _log_run(f"{label}, unpooled", run)
        _check_every_step(run, label, {"int4_matmul": MIN_LAUNCHES_PER_DECODE_STEP["int4_matmul"],
                                       "gqa_decode_attention": 28})

        def exact(x, q4, scale):
            w = dequantize_int4({"q4": q4, "scale": scale})
            return (x.float() @ w.t()).to(x.dtype)

        run["decode_step"] = check_decode_step(
            model, capture, layers, "int4_matmul", i4.int4_matmul_plain, exact,
            f"{label} decode step (K4 vs plain)",
        )
        run["pool_rows"] = check_pool_rows(model, label, sizes)  # K4 keeps the batch's rows
        if preset == "qwen2-vl-7b":
            run["tp_reference"] = tp_reference(model, _requests(model))  # phase 25's int4 bar
    del model, capture
    _free()
    return run


def _check_every_step(run: dict, label: str, want: dict[str, int]) -> None:
    """Every decode step of ``run`` (read around each call) launched exactly
    ``want`` of the kernels ``want`` names. Other kernels are not compared:
    with two chunks, the next chunk's tower runs on the pipeline's helper
    thread while a step of this one decodes, and the counters are global."""
    steps = run["per_call"]["decode_step"]
    if not steps or any({name: step.get(name, 0) for name in want} != want for step in steps):
        raise AssertionError(f"{label}: decode-step launches {_call_summary({'decode_step': steps})}, "
                             f"expected {want} in every step")


def run_v25_quantized(dev, preset: str = "qwen2.5-vl-7b") -> dict:
    """Phase 7b: qwen2.5-vl-7b with weights drawn and quantized on the card,
    on phase 7's 8 requests (the 392x448 images pad their windows: the tower
    takes K2's tensor mask). int8: weight-only, unpooled against pool 2 at
    batch 4, every row equal; then W8A8 + pool 2 + the int8 KV cache against
    the same requests unpooled, every row equal, K3-int8 28 times in every
    decode step, and one pooled decode step's logits by phase 4's rule. int4:
    8 requests unpooled (K4 on every decode-step product, 197 per step, one
    step's logits through K4 held to the plain version), then unpooled
    against pool 2, every row equal. Images/s, phase seconds and peak memory
    of each run are logged and returned."""
    import torch

    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq
    from lmms_owc_tpu_torch.nn.layers import set_int8_activations
    from lmms_owc_tpu_torch.ops import attention as att

    steps = ((nnq, "decode_step"),)
    out: dict = {}
    with _env(LMMS_OWC_DECODE_POOL="1", LMMS_OWC_KV_INT8=""):
        t0 = time.perf_counter()
        model = get_model(preset, random_init=True, dtype="bfloat16", device=str(dev), time_phases=True,
                          batch_size=V25_QUANT_BATCH, load_in_8bit=True, int8_activations=True)
        torch.cuda.synchronize()
        log(f"{preset} int8: weights drawn and quantized on the card in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    try:
        set_int8_activations(False)  # weight-only int8 first
        out["pool_rows_int8_weight_only"] = check_pool_rows(model, f"{preset} int8 weight-only", V25_SIZES)
        set_int8_activations(True)
        requests = _requests(model, V25_SIZES)
        capture: dict = {}
        with _env(LMMS_OWC_DECODE_POOL="2", LMMS_OWC_KV_INT8="1", LMMS_OWC_SORT_BY_VISION="0"), \
                _decode_steps(capture):
            model.generate_until(requests)  # warm-up; keeps one pooled decode step's inputs
        label = f"{preset} int8 + W8A8 + int8 KV"
        same, unpooled, pooled = _pool_pair(model, requests, label, kv_int8=True, per_call=steps)
        for name, run in (("unpooled", unpooled), ("pool 2", pooled)):
            _log_run(f"{label}, {name}", run)
            _check_every_step(run, f"{label}, {name}", {"gqa_decode_attention_int8": 28})
        out["int8_w8a8_kv_int8"] = dict(pooled, unpooled=unpooled, rows=int(same.size), same_rows=int(same.sum()))
        log(f"{label}: rows with the same tokens pooled and unpooled {int(same.sum())} of {same.size}")
        if not same.all():
            raise AssertionError(f"{label}: pooled tokens differ from unpooled ones on rows {np.nonzero(~same)[0].tolist()}")

        def exact(q, ck, cv, i, mask, *scales):
            return att.gqa_decode_attention_plain(q.float(), ck, cv, i, mask, *scales).to(q.dtype)

        with _env(LMMS_OWC_KV_INT8="1"):
            out["int8_w8a8_kv_int8"]["decode_step"] = check_decode_step(
                model, capture, nnq, "gqa_decode_attention", att.gqa_decode_attention_plain, exact,
                f"{label} pooled decode step (int8 decode kernel vs plain)")
    finally:
        set_int8_activations(False)
    del model, capture
    _free()

    out["int4"] = run_int4(dev, preset, V25_SIZES)
    return out


# ------------------------------------------------------------- checkpoints


def write_safetensors(path, tensors: dict) -> int:
    """Write CPU tensors as one safetensors file: the 8-byte little-endian
    header length, the JSON header padded with spaces to 8 bytes, then each
    tensor's bytes in order. Returns the bytes written."""
    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[str(t.dtype).removeprefix("torch.")],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def pinned_tokenizer(blob: dict, pinned: dict[str, int]) -> dict:
    """The fixture tokenizer with each token of ``pinned`` at its id. An added
    token of the same content gives up its old id to a placeholder; the ids
    below the pinned block become vocabulary fillers and the free ids inside it
    added fillers, so that every id up to the block exists (the filler scheme
    of ``tests/test_checkpoint_matrix.py``)."""
    blob = copy.deepcopy(blob)
    vocab = blob["model"]["vocab"]
    for tok in blob["added_tokens"]:
        if tok["content"] in pinned:
            placeholder = f"<|fixture_{tok['id']}|>"
            if vocab.get(tok["content"]) == tok["id"]:
                vocab[placeholder] = vocab.pop(tok["content"])
            tok["content"] = placeholder
    taken = set(vocab.values()) | {t["id"] for t in blob["added_tokens"]} | set(pinned.values())
    lo, hi = min(pinned.values()), max(pinned.values())
    to_add = dict(pinned)
    for idx in range(hi):
        if idx not in taken:
            if idx < lo:
                vocab[f"�filler{idx}�"] = idx
            else:
                to_add[f"�addfill{idx}�"] = idx
    for content, idx in sorted(to_add.items(), key=lambda kv: kv[1]):
        blob["added_tokens"].append({"id": idx, "content": content, "single_word": False, "lstrip": False,
                                     "rstrip": False, "normalized": False, "special": True})
    return blob


class _NameProbe(dict):
    """Answers ``hf_tensor``'s lookups under the published checkpoints'
    prefixes (``model.``, ``visual.``, ``lm_head.``; a BERT's ``embeddings.``
    and ``encoder.``; or the ``prefixes`` given) and keeps the name asked."""

    def __init__(self, prefixes=("model.", "visual.", "lm_head.", "embeddings.", "encoder.")) -> None:
        super().__init__()
        self.prefixes = tuple(prefixes)

    def __contains__(self, key) -> bool:
        return key.startswith(self.prefixes)

    def __getitem__(self, key):
        import torch

        self.asked = key
        return torch.empty((1, 1), device="meta")


def _hf_layout(model, probe=None) -> list[tuple[str, object]]:
    """(checkpoint name, tensor) of every parameter of a port model in the
    published HF layout: the names its own ``hf_tensor`` looks up (under the
    prefixes ``probe`` accepts), the patch kernel back in its Conv3d shape
    ``[embed, 3, t, p, p]`` (CLIP's, SigLIP's, InternViT's and BLIP's in their
    Conv2d shape ``[embed, 3, p, p]``)."""
    probe = probe if probe is not None else _NameProbe()
    out = []
    for name, param in model.named_parameters():
        model.hf_tensor(probe, name)
        t = param.detach()
        if probe.asked.endswith("patch_embed.proj.weight"):
            v = model.vision.config
            t = t.reshape(t.shape[0], v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)
        elif probe.asked.endswith(("embeddings.patch_embedding.weight", "patch_embeddings.projection.weight")):
            p = round((t.shape[1] // 3) ** 0.5)
            t = t.reshape(t.shape[0], 3, p, p)
        out.append((probe.asked, t))
    return out


def write_tensors(layout: list, path: Path, label: str) -> dict:
    """Write (name, tensor) pairs as safetensors shards of at most
    ``SHARD_BYTES`` with ``model.safetensors.index.json`` (each shard copied
    from the card and written in turn). Prints the free disk space and the
    bytes to write first, and fails when the space is short."""
    total = sum(t.numel() * t.element_size() for _, t in layout)
    free = shutil.disk_usage(path).free
    log(f"checkpoint {label} -> {path}: {total / 1e9:.3f} GB of tensors to write, {free / 1e9:.3f} GB free")
    if free < total + (1 << 30):
        raise AssertionError(f"not enough disk space for the {label} checkpoint: {free} bytes free, {total} needed")
    shards, size = [[]], 0
    for name, t in layout:
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append((name, t))
        size += n
    t0 = time.perf_counter()
    written, weight_map = 0, {}
    for k, shard in enumerate(shards):
        file = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        written += write_safetensors(path / file, {name: t.cpu() for name, t in shard})
        weight_map.update({name: file for name, _ in shard})
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    seconds = time.perf_counter() - t0
    log(f"checkpoint {label}: {written} bytes in {len(shards)} shards written in {seconds:.3f} s "
        f"({written / seconds / 1e9:.3f} GB/s)")
    return dict(bytes=written, shards=len(shards), write_seconds=seconds)


def write_checkpoint(model, preset: str, path: Path) -> dict:
    """Write a port model as an HF checkpoint (:func:`write_tensors`),
    ``config.json`` from the preset and the fixture tokenizer with the Qwen2
    specials pinned."""
    from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS

    out = write_tensors(_hf_layout(model), path, preset)
    hf = dict(PRESET_CONFIGS[preset])
    hf.setdefault("model_type", "qwen2_vl")
    hf.update(eos_token_id=QWEN2_SPECIAL_IDS["<|im_end|>"], pad_token_id=QWEN2_SPECIAL_IDS["<|endoftext|>"],
              image_token_id=QWEN2_SPECIAL_IDS["<|image_pad|>"], video_token_id=QWEN2_SPECIAL_IDS["<|video_pad|>"],
              vision_start_token_id=QWEN2_SPECIAL_IDS["<|vision_start|>"])
    (path / "config.json").write_text(json.dumps(hf))
    blob = pinned_tokenizer(json.loads(FIXTURE_TOKENIZER.read_text()), QWEN2_SPECIAL_IDS)
    (path / "tokenizer.json").write_text(json.dumps(blob))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>", "clean_up_tokenization_spaces": False}))
    return out


def _load(dev, preset: str, path: Path, **kw):
    """``get_model(preset, pretrained=path)`` on the card, timed, with its peak
    memory above what was allocated before."""
    import torch

    from lmms_owc_tpu_torch.models import get_model

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(preset, pretrained=str(path), dtype="bfloat16", device=str(dev), time_phases=True, **kw)
    torch.cuda.synchronize()
    load = dict(load_seconds=time.perf_counter() - t0,
                load_peak_above_gb=(torch.cuda.max_memory_allocated() - before) / 1e9,
                model_gb=sum(t.numel() * t.element_size()
                             for t in list(model.model.parameters()) + list(model.model.buffers())) / 1e9)
    log(f"{preset} loaded from the checkpoint ({kw or 'bf16'}): {json.dumps(load)}")
    return model, load


def _same_parameters(got, want, label: str) -> int:
    """Every parameter of ``got`` bit-equal to ``want``'s; returns the count."""
    import torch

    ref = dict(want.named_parameters())
    names = [name for name, _ in got.named_parameters()]
    if sorted(names) != sorted(ref):
        raise AssertionError(f"{label}: parameter names differ from the served model's")
    for name, p in got.named_parameters():
        if p.dtype != ref[name].dtype or not torch.equal(p, ref[name]):
            raise AssertionError(f"{label}: parameter {name} differs from the served model's")
    return len(names)


def _same_quantized(got, want, bits: int) -> int:
    """Every int8/int4 module of ``got`` equals ``quantize_int8``/``quantize_int4``
    of ``want``'s bf16 weight bit for bit (bias too); every other parameter is
    bit-equal. Returns the number of quantized modules."""
    import torch

    from lmms_owc_tpu_torch.nn.layers import Int4Linear, Int8Linear
    from lmms_owc_tpu_torch.ops.quant import quantize_int4, quantize_int8

    n = 0
    quantized = set()
    for name, mod in got.named_modules():
        if not isinstance(mod, (Int8Linear, Int4Linear)):
            continue
        ref = want.get_submodule(name)
        qp = quantize_int8(ref.weight) if bits == 8 else quantize_int4(ref.weight)
        leaf = mod.q if bits == 8 else mod.q4
        if not (torch.equal(leaf, qp["q" if bits == 8 else "q4"]) and torch.equal(mod.scale, qp["scale"])):
            raise AssertionError(f"int{bits} load: {name} differs from the quantization of the served weight")
        if mod.bias is not None and not torch.equal(mod.bias, ref.bias):
            raise AssertionError(f"int{bits} load: {name}.bias differs")
        quantized.add(name)
        n += 1
    ref = dict(want.named_parameters())
    for name, p in got.named_parameters():
        if name.rsplit(".", 1)[0] not in quantized and not torch.equal(p, ref[name]):
            raise AssertionError(f"int{bits} load: parameter {name} differs from the served model's")
    if n == 0:
        raise AssertionError(f"int{bits} load: no quantized module")
    return n


def _same_tokens(label: str, got: list, want: list) -> None:
    if len(got) != len(want) or any(a.shape != b.shape or not (a == b).all() for a, b in zip(got, want)):
        raise AssertionError(f"{label}: generated tokens differ")


def check_checkpoint(dev, served, requests, preset: str, path: Path, quantized: bool) -> dict:
    """Phase 9 for one model: write ``served`` (random bf16 weights drawn on the
    card) as a checkpoint, load it in bf16 (parameters bit-equal; the same
    tokens as ``served`` with the loaded tokenizer on ``requests``) and, with
    ``quantized``, with ``load_in_8bit`` (W8A8, pool 2, int8 KV cache) and
    ``load_in_4bit``. Returns the loaded bf16 model and the phase's numbers."""
    import torch

    out = write_checkpoint(served.model, preset, path)
    model, out["bf16"] = _load(dev, preset, path, batch_size=served.batch_size)
    model.task_dict.update(served.task_dict)  # the requests' images
    out["bf16"]["parameters_bit_equal"] = _same_parameters(model.model, served.model, f"{preset} bf16 load")
    fallback = served.tokenizer
    served.tokenizer = model.tokenizer
    try:
        want: list = []
        _serve(served, requests, want, require_text=False)
    finally:
        served.tokenizer = fallback
    got: list = []
    run = _serve(model, requests, got, require_text=False)
    _same_tokens(f"{preset} bf16 load", got, want)
    _log_run(f"{preset} bf16 from the checkpoint", run)
    out["bf16"].update(run, tokens_identical=True)
    if not quantized:
        return model, out
    with _env(LMMS_OWC_DECODE_POOL="2", LMMS_OWC_KV_INT8="1"):
        q8, load = _load(dev, preset, path, batch_size=NUM_REQUESTS, load_in_8bit=True, int8_activations=True)
        largest = max(p.numel() * p.element_size() for p in served.model.parameters()) / 1e9
        load["peak_bound_gb"] = load["model_gb"] + 2 * largest
        if load["load_peak_above_gb"] > load["peak_bound_gb"]:
            raise AssertionError(f"int8 load peak {load['load_peak_above_gb']:.3f} GB above the bound "
                                 f"{load['peak_bound_gb']:.3f} GB (int8 model + twice the largest bf16 tensor)")
        load["int8_modules_bit_equal"] = _same_quantized(q8.model, served.model, 8)
        run = _serve(q8, _requests(q8, [(448, 448)] * INT8_CKPT_REQUESTS), require_text=False)
        _log_run(f"{preset} int8 + W8A8 + pool 2 + int8 KV from the checkpoint", run)
        _check_min_per_step(run, "gqa_decode_attention_int8")
        out["int8"] = dict(load, **run)
    from lmms_owc_tpu_torch.nn.layers import set_int8_activations

    set_int8_activations(False)
    del q8
    _free()
    with _env(LMMS_OWC_DECODE_POOL="1", LMMS_OWC_KV_INT8=""):
        q4, load = _load(dev, preset, path, batch_size=NUM_REQUESTS, load_in_4bit=True)
        load["int4_modules_bit_equal"] = _same_quantized(q4.model, served.model, 4)
        run = _serve(q4, _requests(q4), require_text=False)
        _log_run(f"{preset} int4 from the checkpoint", run)
        _check_min_per_step(run, "int4_matmul")
        out["int4"] = dict(load, **run)
    del q4
    _free()
    torch.cuda.synchronize()
    return model, out


def _loglikelihood_requests(model):
    """Phase 3's eight images, each with a multi-token continuation."""
    base = _requests(model)

    class _Req:
        def __init__(self, args):
            self.args = args

    return [_Req((PROMPT, CONTINUATIONS[i], r.args[2], r.args[3], "smoke", "test")) for i, r in enumerate(base)]


def check_loglikelihood(model, launches: dict[str, int] = LOGLIKELIHOOD_LAUNCHES) -> dict:
    """Phase 10: the bf16 model scores 8 image requests through the kernels,
    through the plain versions and with f32 attention; the kernel path's
    losses may be no farther from f32 attention than the plain path's (+25%),
    by phase 4's rule. Each call runs one tower and one prefill forward, with
    the ``launches`` they take."""
    import torch

    requests = _loglikelihood_requests(model)
    model.loglikelihood(requests)  # warm-up
    model.phase_seconds.clear()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.loglikelihood(requests)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    phase_seconds = {k: round(v, 4) for k, v in model.phase_seconds.items()}
    for name, want in launches.items():
        if counts[name] != want:
            raise AssertionError(f"loglikelihood: {name} launched {counts[name]} times, expected {want}")
    with _plain_attention():
        plain = model.loglikelihood(requests)
    with _attention(flash_attention=_exact_flash, vision_qkv_attention=_exact_vision,
                    fused_qkv_attention=_exact_fused):
        exact = model.loglikelihood(requests)
    losses = {k: torch.tensor([loss for loss, _ in v]) for k, v in (("kernel", got), ("plain", plain), ("exact", exact))}
    if not bool(torch.isfinite(losses["kernel"]).all()) or not bool((losses["kernel"] > 0).all()):
        raise AssertionError(f"loglikelihood losses not finite and positive: {got}")
    rel = {
        "kernel_vs_plain": _rel_l2(losses["kernel"], losses["plain"]),
        "kernel_vs_exact": _rel_l2(losses["kernel"], losses["exact"]),
        "plain_vs_exact": _rel_l2(losses["plain"], losses["exact"]),
    }
    out = dict(requests=len(requests), seconds=seconds, requests_per_s=len(requests) / seconds, peak_gb=peak,
               phase_seconds=phase_seconds, counts=counts, losses=[round(x, 6) for x in losses["kernel"].tolist()], is_greedy=[g for _, g in got],
               is_greedy_plain=[g for _, g in plain], rel_l2=rel)
    log(f"loglikelihood: {json.dumps(out)}")
    if rel["kernel_vs_exact"] > max(LOGITS_REL_L2, 1.25 * rel["plain_vs_exact"]):
        raise AssertionError(f"loglikelihood: kernel losses farther from f32 attention than the plain path: {rel}")
    return out


def _multi_round_requests(model):
    """Phase 3's eight images as two-round conversations: round 1 asks again
    with round 0's answer in the prompt."""
    base = _requests(model)

    def doc_to_text(doc, round_idx, previous_round_results, last_round_info):
        if round_idx >= 2:
            return None, None, True, previous_round_results, last_round_info
        return (None, f"{PROMPT} You said: {previous_round_results[-1][:48]} Name it again.", False,
                previous_round_results, round_idx)

    class _Req:
        def __init__(self, args):
            self.args = args

    return [_Req((r.args[0], r.args[1], r.args[2], doc_to_text, *r.args[3:6])) for r in base]


def check_multi_round(model) -> dict:
    """Phase 11: 8 requests run two rounds in chunks of 4 under a decode pool
    of 2; round 0's tokens must equal ``generate_until``'s on the same prompts."""
    import torch

    requests = _multi_round_requests(model)
    single = _requests(model)
    saved = model.batch_size
    model.batch_size = MULTI_ROUND_BATCH
    try:
        with _env(LMMS_OWC_DECODE_POOL="2", LMMS_OWC_SORT_BY_VISION="0", LMMS_OWC_KV_INT8=""):
            want: list = []
            with _tokens(model, want):
                model.generate_until(single)
            model.phase_seconds.clear()
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            got: list = []
            with _decode_steps() as steps, _tokens(model, got):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rounds = model.generate_until_multi_round(requests)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
    finally:
        model.batch_size = saved
    if len(got) != 2 or len(want) != 1:
        raise AssertionError(f"multi-round: expected one pooled decode per round, got {len(got)} (generate_until {len(want)})")
    _same_tokens("multi-round round 0 vs generate_until", got[:1], want)
    if len(rounds) != len(requests) or not all(len(r) == 2 for r in rounds):
        raise AssertionError(f"multi-round: expected two rounds per request, got {[len(r) for r in rounds]}")
    out = dict(requests=len(requests), rounds=2, seconds=seconds, images_per_s=2 * len(requests) / seconds,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, decode_steps=len(steps), counts=_counts(),
               phase_seconds={k: round(v, 4) for k, v in model.phase_seconds.items()},
               round0_tokens_identical=True, sample=[r[1][:40] for r in rounds[:2]])
    log(f"multi-round: {json.dumps(out)}")
    return out


def ensure_toy_dataset() -> Path:
    """The toy tasks' dataset (not committed), written by the fixture's own
    recipe (``_toy_utils.download``, with ``datasets``) when the checkout lacks it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("owc_toy_recipe", TOY_TASKS / "toy" / "assets" / "_toy_utils.py")
    toy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(toy)
    toy.download()
    return Path(toy.data_dir())


def cli_reference(model, preset: str) -> list[str]:
    """Phase 12's reference: the toy task's generate_until requests, built by the
    port's TaskManager, answered in-process by ``model`` at the CLI's batch."""
    from lmms_owc_tpu_torch.tasks import TaskManager, get_tasks_as_dict

    ensure_toy_dataset()
    task = get_tasks_as_dict(["toy"], TaskManager(include_path=str(TOY_TASKS.resolve()), model_name=preset))["toy"]
    task.build_all_requests(rank=0, world_size=1)
    model.task_dict["toy"] = task
    saved, model.batch_size = model.batch_size, CLI_BATCH
    try:
        return list(model.generate_until(task.instances))
    finally:
        model.batch_size = saved


def cli_argv(preset: str, ckpt: Path, model_args: str, tasks, out: Path, limit: int | None = None) -> list[str]:
    """The port CLI's arguments for ``preset`` from the checkpoint ``ckpt`` on ``tasks``."""
    argv = ["--model", preset, "--model_args", f"pretrained={ckpt},{model_args}", "--tasks", ",".join(tasks),
            "--include_path", str(TOY_TASKS.resolve()), "--batch_size", str(CLI_BATCH), "--log_samples",
            "--output_path", str(out), "--seed", "0,1234,1234,1234"]
    return argv + (["--limit", str(limit)] if limit else [])


def _cli_in_process(dev, argv: list[str]) -> dict:
    """``main(argv)`` of the port's CLI with the launch counts set to 0 just
    before it: its results, the launches, seconds and peak device GB."""
    import torch

    from lmms_owc_tpu_torch.eval_model import main as cli_main

    cuda = dev.type == "cuda"
    _reset_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    (results,) = cli_main(argv)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    _free()  # the CLI's model is garbage once main returns
    return dict(results=results, counts=counts, seconds=seconds, peak_gb=peak)


def check_cli_outputs(out: Path, tasks, results: dict, docs: int, reference: list[str] | None) -> dict:
    """One results file and a samples file of ``docs`` lines per task; every
    metric of ``CLI_METRICS`` finite; with ``reference``, the toy samples' raw
    responses equal to it string for string. Returns the metric values."""
    import math

    if len(list(out.rglob("*_results.json"))) != 1:
        raise AssertionError(f"CLI: expected one results file under {out}, found {list(out.rglob('*_results.json'))}")
    metrics = {}
    for task in tasks:
        files = list(out.rglob(f"*_samples_{task}.jsonl"))
        lines = [json.loads(line) for f in files for line in f.read_text().splitlines()]
        if len(files) != 1 or len(lines) != docs:
            raise AssertionError(f"CLI: {task}: {len(files)} samples files with {len(lines)} lines, expected 1 with {docs}")
        for metric in CLI_METRICS[task]:
            value = results["results"][task][f"{metric},none"]
            if not math.isfinite(value):
                raise AssertionError(f"CLI: {task} {metric} is {value}")
            metrics[f"{task}/{metric}"] = value
        if task == "toy" and reference is not None:
            got = [line["resps"][0][0] for line in sorted(lines, key=lambda x: x["doc_id"])]
            if got != reference[:docs]:
                bad = [i for i, (g, w) in enumerate(zip(got, reference)) if g != w]
                raise AssertionError(f"CLI: toy responses differ from the in-process adapter's at docs {bad}: "
                                     f"{got[bad[0]]!r} vs {reference[bad[0]]!r}")
    return metrics


def _cli_summary(run: dict, metrics: dict) -> dict:
    timings = run["results"]["timings"]
    timed = timings["build_requests"] + sum(timings["inference"].values()) + timings["scoring"]
    return dict(seconds=run["seconds"], timings=timings, load_seconds=run["seconds"] - timed, metrics=metrics,
                counts=run["counts"], peak_gb=run["peak_gb"])


def run_cli(dev, preset: str, ckpt: Path, reference: list[str], model_args: str = "dtype=bfloat16",
            pooled_int8: bool = True, min_launches=CLI_LAUNCHES, out_root: Path | None = None) -> dict:
    """Phase 12: the port's CLI from the checkpoint ``ckpt``. (a) ``main(argv)``
    in-process on the three toy tasks (all three request types, 36 documents):
    the files, finite metrics, the toy responses equal to ``reference``, and
    each of ``min_launches`` launched in the CLI's window; (b) with
    ``pooled_int8``, the JAX bench's serving configuration (int8 + W8A8, pool
    2, int8 KV cache) on ``toy``, which must launch the int8 decode kernel;
    (c) ``python -m lmms_owc_tpu_torch.eval_model --tasks toy_suite`` in a
    subprocess on four documents of each of its tasks (toy_semantic scored),
    which must exit 0 and write its results file. The runs
    write under ``out_root`` (a, b and c), which the caller keeps for phase
    13; without one, under a temporary directory removed at the end."""
    from lmms_owc_tpu_torch.nn.layers import set_int8_activations

    t0 = time.perf_counter()
    summary = {}
    root = out_root or Path(tempfile.mkdtemp(prefix="owc_cli_"))
    try:
        out = root / "a"
        run = _cli_in_process(dev, cli_argv(preset, ckpt, model_args, CLI_TASKS, out))
        metrics = check_cli_outputs(out, CLI_TASKS, run["results"], CLI_DOCS, reference)
        for name in min_launches:
            if run["counts"][name] <= 0:
                raise AssertionError(f"CLI: {name} was not launched in the CLI's run: {run['counts']}")
        summary["bf16"] = _cli_summary(run, metrics)
        if pooled_int8:
            out = root / "b"
            with _env(LMMS_OWC_DECODE_POOL="2", LMMS_OWC_KV_INT8="1"):
                try:
                    run = _cli_in_process(dev, cli_argv(
                        preset, ckpt, f"{model_args},load_in_8bit=True,int8_activations=True", ("toy",), out))
                finally:
                    set_int8_activations(False)
            metrics = check_cli_outputs(out, ("toy",), run["results"], CLI_DOCS, None)
            if run["counts"]["gqa_decode_attention_int8"] <= 0:
                raise AssertionError(f"CLI int8 pooled: the int8 decode kernel was not launched: {run['counts']}")
            summary["int8_w8a8_pool2_kv_int8"] = _cli_summary(run, metrics)
        out = root / "c"
        cmd = [sys.executable, "-m", "lmms_owc_tpu_torch.eval_model",
               *cli_argv(preset, ckpt, model_args, CLI_SUITE[:1], out, limit=CLI_SUBPROCESS_LIMIT)]
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                              env={**os.environ, "LMMS_OWC_TPU_LOG_LEVEL": "WARNING"})
        if proc.returncode != 0:
            raise AssertionError(f"CLI subprocess exited {proc.returncode}: {proc.stderr[-3000:]}")
        results = list(out.rglob("*_results.json"))
        if len(results) != 1:
            raise AssertionError(f"CLI subprocess wrote {len(results)} results files")
        metrics = check_cli_outputs(out, CLI_SUITE[1], json.loads(results[0].read_text()), CLI_SUBPROCESS_LIMIT, None)
        summary["subprocess"] = dict(seconds=time.perf_counter() - t1, returncode=proc.returncode, metrics=metrics)
    finally:
        if out_root is None:
            shutil.rmtree(root, ignore_errors=True)
    summary["phase_seconds"] = time.perf_counter() - t0
    log(f"CLI: {json.dumps(summary)}")
    return summary


# Phase 12's run of one of the paper's benchmarks: ``caltech101`` with its
# ``base`` prompt (64 tokens) from a synthesised image folder of a few classes
# of the vendored ``metadata.csv``.
BENCHMARK_TASK = "caltech101"
BENCHMARK_FOLDERS = ("Faces", "Leopards", "accordion", "airplanes")
BENCHMARK_PER_CLASS = 3  # one train image and two test images per class
BENCHMARK_METRICS = ("concept_semantic_similarity", "exact_match", "semantic_similarity", "textual_inclusion")
BENCHMARK_SIZES = [(300, 200), (180, 260), (224, 224)]
CLASSIFICATION_CONFIGS = Path(__file__).resolve().parent / "lmms_owc_tpu_torch" / "tasks" / "configs" / "classification"


def write_classification_folder(work: Path, name: str = BENCHMARK_TASK, folders=BENCHMARK_FOLDERS,
                                per_class: int = BENCHMARK_PER_CLASS) -> dict:
    """A synthesised ``name`` benchmark under ``work``: images in the layout
    of the extracted archive (``.cache/data/caltech101/caltech-101/
    101_ObjectCategories/<folder>/``, so the task's download finds its
    extraction root and fetches nothing) and split tables under
    ``assets/<name>/`` (the vendored ``metadata.csv``, and a
    ``split_coop.csv`` listing these images: the first of each class for
    train, the rest for test), which ``LMMS_OWC_ASSETS_DIR=<work>/assets``
    puts ahead of the vendored tables. Returns the paths and the test docs'
    class names in table order."""
    import csv

    from PIL import Image

    rng = np.random.RandomState(12)
    images = work / ".cache" / "data" / name / "caltech-101" / "101_ObjectCategories"
    assets = work / "assets" / name
    assets.mkdir(parents=True)
    shutil.copy(CLASSIFICATION_CONFIGS / name / "assets" / "metadata.csv", assets / "metadata.csv")
    with open(assets / "metadata.csv", newline="") as f:
        folder_to_class = {row["folder_name"]: row["class_name"] for row in csv.DictReader(f)}
    rows, test_classes = [], []
    for folder in folders:
        (images / folder).mkdir(parents=True)
        for i in range(per_class):
            h, w = BENCHMARK_SIZES[i % len(BENCHMARK_SIZES)]
            rel = f"{folder}/image_{i + 1:04d}.jpg"
            Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(images / rel)
            split = "train" if i == 0 else "test"
            rows.append((split, rel))
            if split == "test":
                test_classes.append(folder_to_class[folder].replace("_", " "))
    with open(assets / "split_coop.csv", "w", newline="") as f:
        csv.writer(f).writerows([("split", "filename"), *rows])
    return dict(work=work, assets_dir=work / "assets", cache_dir=work / ".cache", data_dir=work / "data",
                test_classes=test_classes)


def convert_classification_folder(folder: dict, name: str = BENCHMARK_TASK) -> Path:
    """The task's own download hook (the port's ``download_benchmark``) turns
    the synthesised folder into ``data/<name>`` under the folder's work
    directory, reading the split tables through ``LMMS_OWC_ASSETS_DIR``."""
    import importlib.util

    path = CLASSIFICATION_CONFIGS / name / "assets" / f"_{name}_utils.py"
    spec = importlib.util.spec_from_file_location(f"_{name}_utils", path)
    utils = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(utils)
    if not (folder["cache_dir"] / "data" / name).is_dir():  # never let the hook reach for the archive
        raise AssertionError(f"{name}: the synthesised extraction root is missing under {folder['cache_dir']}")
    with _env(LMMS_OWC_ASSETS_DIR=str(folder["assets_dir"])):
        utils.download(output_dir=str(folder["data_dir"]), cache_dir=str(folder["cache_dir"]))
    return folder["data_dir"] / name


def run_cli_benchmark(dev, preset: str, ckpt: Path, work: Path, model_args: str = "dtype=bfloat16") -> dict:
    """Phase 12, the paper's benchmark: a synthesised ``caltech101`` folder
    (:func:`write_classification_folder`) converted by the task's download
    hook, then ``python -m lmms_owc_tpu_torch.eval_model --tasks caltech101``
    (the ``base`` prompt, 64 tokens) from the checkpoint in a subprocess whose
    working directory is ``work``, so ``dataset_path: data/caltech101``
    resolves there, with ``LMMS_OWC_ASSETS_DIR`` naming the split tables.
    One results file and one samples line per test image, targets equal to
    the synthesised classes, the four metrics finite; ``semantic_similarity``
    must come from the MiniLM checkpoint that ``LMMS_OWC_SBERT_PATH`` names
    (the fallback encoder's warning fails the phase)."""
    import math

    t0 = time.perf_counter()
    folder = write_classification_folder(work)
    converted = convert_classification_folder(folder)
    out = work / "out"
    cmd = [sys.executable, "-m", "lmms_owc_tpu_torch.eval_model", "--model", preset,
           "--model_args", f"pretrained={ckpt},{model_args}", "--tasks", BENCHMARK_TASK,
           "--batch_size", str(CLI_BATCH), "--log_samples", "--output_path", str(out), "--seed", "0,1234,1234,1234"]
    root = str(Path(__file__).resolve().parent)
    env = {**os.environ, "LMMS_OWC_ASSETS_DIR": str(folder["assets_dir"]), "LMMS_OWC_TPU_LOG_LEVEL": "WARNING",
           "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, capture_output=True, text=True, timeout=900, env=env)
    seconds = time.perf_counter() - t1
    if proc.returncode != 0:
        raise AssertionError(f"CLI {BENCHMARK_TASK}: exited {proc.returncode}: {proc.stderr[-3000:]}")
    if "MiniLM weights not found" in proc.stderr:
        raise AssertionError(f"CLI {BENCHMARK_TASK}: semantic similarity took the fallback encoder")
    results = list(out.rglob("*_results.json"))
    samples = list(out.rglob(f"*_samples_{BENCHMARK_TASK}.jsonl"))
    if len(results) != 1 or len(samples) != 1:
        raise AssertionError(f"CLI {BENCHMARK_TASK}: {len(results)} results and {len(samples)} samples files")
    lines = sorted((json.loads(line) for line in samples[0].read_text().splitlines()), key=lambda x: x["doc_id"])
    targets = [line["target"] for line in lines]
    if targets != folder["test_classes"]:
        raise AssertionError(f"CLI {BENCHMARK_TASK}: targets {targets} != the synthesised classes "
                             f"{folder['test_classes']}")
    written = json.loads(results[0].read_text())
    metrics = {m: written["results"][BENCHMARK_TASK][f"{m},none"] for m in BENCHMARK_METRICS}
    if not all(isinstance(v, float) and math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"CLI {BENCHMARK_TASK}: metrics {metrics}")
    max_new = written["configs"][BENCHMARK_TASK]["generation_kwargs"]["max_new_tokens"]
    if max_new != MAX_NEW_TOKENS:
        raise AssertionError(f"CLI {BENCHMARK_TASK}: max_new_tokens {max_new}, the base prompt's is {MAX_NEW_TOKENS}")
    summary = dict(task=BENCHMARK_TASK, docs=len(lines), dataset=str(converted.relative_to(work)),
                   seconds=seconds, phase_seconds=time.perf_counter() - t0, metrics=metrics,
                   max_new_tokens=max_new, sample=lines[0]["resps"][0][0][:60])
    log(f"CLI {BENCHMARK_TASK}: {json.dumps(summary)}")
    return summary


# ------------------------------------------------------- CLIP and LLaVA


def _random_module(module, gen, scale: float = 0.02):
    """Fill a port module in place: linear weights and other tensors ~ N(0, 1)
    * ``scale`` (drawn from ``gen`` on its device), biases zero, norm scales one."""
    import torch

    from lmms_owc_tpu_torch.nn.layers import LayerNorm, RMSNorm

    norms = {id(m.weight) for m in module.modules() if isinstance(m, (LayerNorm, RMSNorm))}
    with torch.no_grad():
        for name, t in module.named_parameters():
            if name.endswith("bias"):
                t.zero_()
            elif id(t) in norms:
                t.fill_(1.0)
            else:
                t.copy_((torch.randn(t.shape, generator=gen, device=t.device) * scale).to(t.dtype))
    return module


def clip_vocab() -> tuple[dict, list[str]]:
    """CLIP's ``vocab.json`` layout at 49408 entries: the 256 byte characters,
    the same with ``</w>``, the tokens of merges that build each word of
    ``CLIP_CLASSES`` and "a photo of a", fillers, then ``<|startoftext|>`` and
    ``<|endoftext|>`` at 49406 and 49407."""
    from lmms_owc_tpu_torch.tokenizer import _BYTE_TO_CHAR

    chars = [_BYTE_TO_CHAR[b] for b in range(256)]
    vocab = {t: i for i, t in enumerate(chars + [c + "</w>" for c in chars])}
    merges = []
    for word in dict.fromkeys(" ".join(CLIP_CLASSES + ("a photo of a",)).split()):
        piece = word[0]
        for k, c in enumerate(word[1:], 1):
            c = c + "</w>" if k == len(word) - 1 else c
            if piece + c not in vocab:
                merges.append(f"{piece} {c}")
                vocab[piece + c] = len(vocab)
            piece += c
    while len(vocab) < 49406:
        vocab[f"fill{len(vocab)}</w>"] = len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    return vocab, merges


def write_clip_checkpoint(dev, path: Path, seed: int = 0) -> dict:
    """An HF ``CLIPModel`` checkpoint at ``CLIP_CONFIG`` with random f32 weights
    drawn on the card, CLIP's ``vocab.json`` + ``merges.txt`` (:func:`clip_vocab`)
    and a ``preprocessor_config.json`` at 224 px."""
    import math

    import torch

    from lmms_owc_tpu_torch.nn import clip
    from lmms_owc_tpu_torch.ops.image import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD

    gen = torch.Generator(device=dev).manual_seed(seed)
    vcfg, tcfg = clip.clip_configs_from_hf(CLIP_CONFIG)
    model = clip.ClipModel(clip.init_clip_vision_params(vcfg, gen),
                           _random_module(clip.ClipTextModel(tcfg, torch.float32, dev), gen),
                           torch.tensor(CLIP_CONFIG["logit_scale_init_value"], device=dev))
    out = write_tensors(_hf_layout(model, _NameProbe(CLIP_HF_PREFIXES)), path, "clip-vit-large-patch14")
    del model
    _free()
    vocab, merges = clip_vocab()
    (path / "config.json").write_text(json.dumps(CLIP_CONFIG))
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
        "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>", "model_max_length": 77}))
    (path / "preprocessor_config.json").write_text(json.dumps({
        "image_processor_type": "CLIPImageProcessor", "size": {"shortest_edge": 224},
        "crop_size": {"height": 224, "width": 224}, "do_resize": True, "do_center_crop": True, "do_rescale": True,
        "rescale_factor": 1 / 255, "do_normalize": True, "image_mean": list(OPENAI_CLIP_MEAN),
        "image_std": list(OPENAI_CLIP_STD), "resample": 3, "do_convert_rgb": True}))
    out["vocab"] = len(vocab)
    out["logit_scale"] = math.exp(CLIP_CONFIG["logit_scale_init_value"])
    return out


def run_clip(dev) -> dict:
    """Phase 14: ``pipelines.image.encode_clip`` through ``LMMS_OWC_CLIP_PATH``
    on a written checkpoint at openai/clip-vit-large-patch14's config: 64
    images of mixed sizes against 16 prompts, f32. The measured call must
    make one vision tower call that launches K2 24 times and one text tower
    call that launches it 12 times (read around each call); its
    logits are held to the same scorer on the plain attention within
    ``CLIP_TOL``."""
    import torch
    from PIL import Image

    from lmms_owc_tpu_torch.nn import clip as nnclip
    from lmms_owc_tpu_torch.pipelines import image

    rng = np.random.RandomState(14)
    images = [Image.fromarray(rng.randint(0, 255, (*CLIP_SIZES[i % len(CLIP_SIZES)], 3), dtype=np.uint8))
              for i in range(CLIP_IMAGES)]
    prompts = [f"a photo of a {c}." for c in CLIP_CLASSES]
    root = Path(tempfile.mkdtemp(prefix="owc_clip_"))
    try:
        out = write_clip_checkpoint(dev, root)
        image._clip = None
        with _env(LMMS_OWC_CLIP_PATH=str(root)):
            t0 = time.perf_counter()
            image.encode_clip(images, prompts)  # loads the scorer, then a warm-up call
            torch.cuda.synchronize()
            out["load_and_first_call_seconds"] = time.perf_counter() - t0
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _per_call((nnclip, "clip_vision_forward"), (nnclip, "clip_text_encode")) as calls:
                got = image.encode_clip(images, prompts)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            with _attention(flash_attention=_plain_flash):
                plain = image.encode_clip(images, prompts)
        scorer = image._clip
        text_len = int(scorer.tokenizer(prompts)["input_ids"].shape[1])
    finally:
        image._clip = None
        shutil.rmtree(root, ignore_errors=True)
        _free()
    if got.shape != (CLIP_IMAGES, len(prompts)) or not np.isfinite(got).all():
        raise AssertionError(f"CLIP logits: shape {got.shape}, finite {bool(np.isfinite(got).all())}")
    err = np.abs(got - plain)
    out.update(images=CLIP_IMAGES, prompts=len(prompts), text_len=text_len, seconds=seconds,
               images_per_s=CLIP_IMAGES / seconds, peak_gb=peak, counts=counts, per_call=calls,
               max_abs_err=float(err.max()),
               tol=CLIP_TOL, logits_mean=float(got.mean()), logits_std=float(got.std()))
    log(f"CLIP scorer: {json.dumps(out)}")
    if text_len != CLIP_TEXT_LEN:
        raise AssertionError(f"CLIP scorer: prompts padded to {text_len} tokens, phase 2 holds {CLIP_TEXT_LEN}")
    want = {"clip_vision_forward": [{"flash_attention": CLIP_VISION_LAUNCHES}],
            "clip_text_encode": [{"flash_attention": CLIP_TEXT_LAUNCHES}]}
    if calls != want or counts["flash_attention"] != CLIP_VISION_LAUNCHES + CLIP_TEXT_LAUNCHES:
        raise AssertionError(f"CLIP scorer: launches per tower call {calls} (total {counts}), expected {want}")
    if (err > CLIP_TOL + CLIP_TOL * np.abs(plain)).any():
        raise AssertionError(f"CLIP logits differ from the plain attention's beyond {CLIP_TOL}: {err.max():.3e}")
    return out


def _prefill_logits(model, embeds, pos, mask, bucket):
    """Last-position prefill logits of the adapter's decoder over one chunk's embeddings."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import prefill

    out, _ = prefill(model.model.text, embeds, torch.from_numpy(pos).to(model.device),
                     torch.from_numpy(mask.astype(np.int32)).to(model.device), bucket)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("prefill logits have non-finite values")
    return out


def _llava_chunk_logits(model, requests):
    """Last-position prefill logits of one chunk of LLaVA requests (tower, projector, prefill)."""
    from lmms_owc_tpu_torch.nn.llama import llama_positions

    prepared = [model._prepare_request(r.args[0], *r.args[2:6]) for r in requests]
    input_ids, mask = model._left_pad([ids for ids, _ in prepared])
    embeds = model._embed_sequence(input_ids, [payload for _, payload in prepared])
    pos, _ = llama_positions(mask)
    return _prefill_logits(model, embeds, pos, mask, input_ids.shape[1])


def _llava_per_call():
    """The LLaVA serving entries whose launches :func:`_serve` reads per call:
    the tower and projector, the prefill and each decode step."""
    from lmms_owc_tpu_torch.nn import llava as lv
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    return (lv, "encode_images"), (nnq, "prefill"), (nnq, "decode_step")


def _check_tower_launches(run: dict, label: str, tower: str, tower_calls: int, tower_launches: int, layers: int,
                          kv_int8: bool = False, tensor_mask: bool = False) -> None:
    """One chunk, read around each call (``run["per_call"]``): ``tower_calls``
    calls of the ``tower`` entry of ``tower_launches`` K2 launches each (each
    in the tensor-mask form with ``tensor_mask``), one prefill of ``layers``,
    and ``layers`` K3 (or K3-int8) launches in each decode step; the run's
    totals are their sums."""
    k3 = "gqa_decode_attention_int8" if kv_int8 else "gqa_decode_attention"
    steps = run["decode_steps"]
    per_tower = {"flash_attention": tower_launches,
                 **({"flash_attention_tensor_mask": tower_launches} if tensor_mask else {})}
    want = {tower: [per_tower] * tower_calls, "prefill": [{"flash_attention": layers}],
            "decode_step": [{k3: layers}] * steps}
    totals = {"flash_attention": tower_calls * tower_launches + layers, k3: layers * steps,
              **({"flash_attention_tensor_mask": tower_calls * tower_launches} if tensor_mask else {})}
    if steps == 0 or run["per_call"] != want or {k: n for k, n in run["counts"].items() if n} != totals:
        raise AssertionError(f"{label}: launches per call {_call_summary(run['per_call'])} (totals "
                             f"{run['counts']}) over {steps} decode steps, expected {_call_summary(want)}")


def _check_llava_launches(run: dict, label: str, tower_calls: int, kv_int8: bool = False) -> None:
    """Phases 15 and 17: CLIP tower calls of 23 K2 launches, a prefill of 32, 32 K3 (or K3-int8) per step."""
    _check_tower_launches(run, label, "encode_images", tower_calls, LLAVA_TOWER_LAUNCHES, LLAVA_LAYERS, kv_int8)


def _call_summary(per_call: dict) -> dict:
    """{name: {launches of one call as JSON: number of such calls}}, for a log line."""
    return {name: dict(Counter(json.dumps(c, sort_keys=True) for c in calls)) for name, calls in per_call.items()}


def run_llava(dev) -> dict:
    """Phase 15: llava-1.5-7b with random bf16 weights drawn on the card
    answers phase 3's 8 requests (six 448x448, two 336x448: the centre crop
    runs) in one chunk through ``generate_until``, 64 greedy tokens; one tower
    call (23 K2 launches), 32 prefill launches and 32 K3 launches per decode
    step; the chunk's prefill logits by phase 4's rule; ``loglikelihood`` on
    the same images (phase 10's check); then the same requests with
    ``load_in_8bit`` weights and the int8 KV cache (32 K3-int8 launches per step)."""
    import torch

    from lmms_owc_tpu_torch.models import get_model

    model, requests, run = serve_bf16(dev, "llava-1.5-7b", None, {}, "llava-1.5-7b bf16", _llava_per_call())
    _check_llava_launches(run, "llava-1.5-7b bf16", tower_calls=1)
    lengths = {len(model._prepare_request(r.args[0], *r.args[2:6])[0]) for r in requests}
    if lengths != {LLAVA_PROMPT_TOKENS}:
        raise AssertionError(f"llava-1.5-7b: prompts of {lengths} tokens, phase 2 holds {LLAVA_PROMPT_TOKENS}")
    run["logits"] = _bf16_logits_rule(lambda: _llava_chunk_logits(model, requests), "llava-1.5-7b bf16")
    run["loglikelihood"] = check_loglikelihood(
        model, {"flash_attention": LLAVA_TOWER_LAUNCHES + LLAVA_LAYERS, "gqa_decode_attention": 0})
    del model
    _free()
    with _env(LMMS_OWC_KV_INT8="1"):
        t0 = time.perf_counter()
        q8 = get_model("llava-1.5-7b", random_init=True, dtype="bfloat16", batch_size=NUM_REQUESTS,
                       device=str(dev), time_phases=True, load_in_8bit=True)
        torch.cuda.synchronize()
        log(f"llava-1.5-7b int8: weights drawn and quantized on the card in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
        requests = _requests(q8)
        q8.generate_until(requests)  # warm-up
        int8 = _serve(q8, requests, per_call=_llava_per_call())
        _log_run("llava-1.5-7b int8 + int8 KV", int8)
        _check_llava_launches(int8, "llava-1.5-7b int8 + int8 KV", tower_calls=1, kv_int8=True)
    run["int8_kv_int8"] = int8
    del q8
    _free()
    return run


def llava_checkpoint_config() -> dict:
    """``llava-1.5-7b``'s preset (full width) with the decoder cut to
    ``LLAVA_CKPT_LAYERS`` layers, in the released config.json's form."""
    from lmms_owc_tpu_torch.models.llava_hf import PRESET_CONFIGS

    cfg = json.loads(json.dumps(PRESET_CONFIGS["llava-1.5-7b"]))
    cfg["text_config"]["num_hidden_layers"] = LLAVA_CKPT_LAYERS
    cfg.update(model_type="llava", architectures=["LlavaForConditionalGeneration"], pad_token_id=32001,
               vision_feature_layer=-2, vision_feature_select_strategy="default")
    return cfg


def write_llava_checkpoint(model, cfg: dict, path: Path, label: str) -> dict:
    """Write a port ``LlavaModel`` as an HF LLaVA checkpoint (the released
    llava-hf checkpoints' tensor names, :func:`write_tensors`), ``cfg`` as its
    config.json and the Llama-2-form tokenizer of :func:`llama2_tokenizer`."""
    out = write_tensors(_hf_layout(model, _NameProbe(LLAVA_HF_PREFIXES)), path, label)
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "tokenizer.json").write_text(json.dumps(llama2_tokenizer()))
    (path / "tokenizer_config.json").write_text(json.dumps(LLAMA2_TOKENIZER_CONFIG))
    return out


def run_llava_checkpoint(dev) -> dict:
    """Phase 16: a LLaVA checkpoint at llava-1.5-7b's width with the decoder
    cut to ``LLAVA_CKPT_LAYERS`` layers (random bf16 weights drawn on the card,
    the released checkpoints' tensor names, the Llama-2-form
    ``byte_fallback`` tokenizer of :func:`llama2_tokenizer`). Loaded with
    ``pretrained=``, every parameter is bit-equal to what was written and
    phase 3's requests give the tokens of the model it was written from;
    then ``eval_model.main(argv)`` with ``--model llava-1.5-7b`` on ``toy``
    writes a results file whose responses equal the in-process ones."""
    import copy as _copy

    import torch

    from lmms_owc_tpu_torch.nn import llava as lv

    root = Path(tempfile.mkdtemp(prefix="owc_llava_"))
    try:
        ckpt = root / "ckpt"
        ckpt.mkdir()
        cfg = llava_checkpoint_config()
        written = lv.init_llava_params(lv.LlavaModel(lv.llava_config_from_hf(cfg), torch.bfloat16, "meta"),
                                       torch.Generator(device=dev).manual_seed(16))
        out = write_llava_checkpoint(written, cfg, ckpt, f"llava-1.5-7b width, {LLAVA_CKPT_LAYERS} layers")
        model, out["load"] = _load(dev, "llava-1.5-7b", ckpt, batch_size=NUM_REQUESTS)
        out["parameters_bit_equal"] = _same_parameters(model.model, written, "llava checkpoint load")
        served = _copy.copy(model)  # the same adapter (config, tokenizer) over the written modules
        served.model = written
        requests = _requests(model)
        served.task_dict = model.task_dict
        want: list = []
        _serve(served, requests, want, require_text=False)
        got: list = []
        run = _serve(model, requests, got, require_text=False)
        _same_tokens("llava checkpoint load", got, want)
        _log_run("llava-1.5-7b checkpoint", run)
        out["serve"] = dict(run, tokens_identical=True)
        del served, written
        _free()
        reference = cli_reference(model, "llava-1.5-7b")
        del model
        _free()
        cli_out = root / "cli"
        cli = _cli_in_process(dev, cli_argv("llava-1.5-7b", ckpt, "dtype=bfloat16", ("toy",), cli_out))
        out["cli"] = _cli_summary(cli, check_cli_outputs(cli_out, ("toy",), cli["results"], CLI_DOCS, reference))
        for name in ("flash_attention", "gqa_decode_attention"):
            if cli["counts"][name] <= 0:
                raise AssertionError(f"llava CLI: {name} was not launched: {cli['counts']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"llava checkpoint and CLI: {json.dumps(_phase_summary(out))}")
    return out


def run_llava_next(dev) -> dict:
    """Phase 17: llava-next-vicuna-7b with random bf16 weights answers one
    672x672 and one 1008-wide image (anyres: 5 and 4 tiles, prompt bucket
    3072, a decode cache of 3136 positions: K3's Hopper instance past 2048) in
    one chunk; two tower calls (46 K2 launches), 32 prefill launches and 32
    K3 launches per step; the chunk's prefill logits by phase 4's rule."""
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    model, requests, run = serve_bf16(dev, "llava-next-vicuna-7b", LLAVA_NEXT_SIZES, {}, "llava-next-vicuna-7b bf16",
                                      _llava_per_call())
    _check_llava_launches(run, "llava-next-vicuna-7b bf16", tower_calls=len(LLAVA_NEXT_SIZES))
    lengths = [len(model._prepare_request(r.args[0], *r.args[2:6])[0]) for r in requests]
    run.update(prompt_tokens=lengths, bucket=pad_to_bucket(max(lengths)),
               cache_len=pad_to_bucket(max(lengths)) + MAX_NEW_TOKENS)
    log(f"llava-next prompts: {lengths} tokens, bucket {run['bucket']}, decode cache {run['cache_len']} positions")
    if tuple(lengths) != LLAVA_NEXT_PROMPT_TOKENS or run["cache_len"] <= 2048:
        raise AssertionError(f"llava-next: prompts of {lengths} tokens (phase 2 holds {LLAVA_NEXT_PROMPT_TOKENS}), "
                             f"decode cache {run['cache_len']} positions (must pass 2048)")
    run["logits"] = _bf16_logits_rule(lambda: _llava_chunk_logits(model, requests), "llava-next-vicuna-7b bf16")
    del model
    _free()
    return run


# ------------------------------------------------------------ SigLIP families


def _siglip_per_call():
    """The SigLIP families' serving entries whose launches :func:`_serve` reads
    per call: the tower, the prefill and each decode step."""
    from lmms_owc_tpu_torch.nn import idefics2 as nnidf
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    return (nnidf, "siglip_vision_forward"), (nnq, "prefill"), (nnq, "decode_step")


def _onevision_chunk_logits(model, requests):
    """One chunk of LLaVA-OneVision requests: anyres tiles through the tower,
    packing, then the prefill."""
    from lmms_owc_tpu_torch.nn.llama import llama_positions

    prepared = [model._prepare(r.args[0], *r.args[2:6]) for r in requests]
    input_ids, mask = model._left_pad([ids for ids, _ in prepared])
    embeds = model._embed_sequence(input_ids, [feats for _, feats in prepared])
    pos, _ = llama_positions(mask)
    return _prefill_logits(model, embeds, pos, mask, input_ids.shape[1])


def _idefics2_chunk_logits(model, requests):
    """One chunk of Idefics2 requests: the padded batch through the tower and
    the perceiver, then the prefill."""
    embeds, pos, mask, _, bucket = model._prepare_chunk([r.args for r in requests])
    return _prefill_logits(model, embeds, pos, mask, bucket)


def run_onevision(dev) -> dict:
    """Phase 18: llava-onevision-qwen2-7b-ov with random bf16 weights drawn on
    the card answers phase 3's 8 requests in one chunk (anyres: 5 tiles for a
    448x448 image, 3 for a 336x448 one, prompts of 3712 and 1741 tokens,
    bucket 4096, decode cache 4160: K3's Hopper instance), 64 greedy tokens:
    one tower call per image (26 K2 launches at head_dim 72), 28 prefill
    launches and 28 K3 launches per step, read around each call; the prefill
    logits of a chunk of one image of each size by phase 4's rule;
    ``loglikelihood`` on the same images by phase 10's, at batch 2."""
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    label = f"{ONEVISION_PRESET} bf16"
    model, requests, run = serve_bf16(dev, ONEVISION_PRESET, None, {}, label, _siglip_per_call())
    _check_tower_launches(run, label, "siglip_vision_forward", len(requests), ONEVISION_TOWER_LAUNCHES,
                          ONEVISION_LAYERS)
    lengths = [len(model._prepare(r.args[0], *r.args[2:6])[0]) for r in requests]
    want = [ONEVISION_PROMPT_TOKENS[(448, 448)]] * 6 + [ONEVISION_PROMPT_TOKENS[(336, 448)]] * 2
    bucket = pad_to_bucket(max(lengths))
    run.update(prompt_tokens=lengths, bucket=bucket, cache_len=bucket + MAX_NEW_TOKENS,
               tiles=[ONEVISION_TILES[(448, 448)]] * 6 + [ONEVISION_TILES[(336, 448)]] * 2)
    log(f"{label}: prompts of {lengths} tokens, bucket {bucket}, decode cache {run['cache_len']} positions")
    if lengths != want or run["cache_len"] <= 2048:
        raise AssertionError(f"{label}: prompts of {lengths} tokens (phase 2 holds {want}), "
                             f"decode cache {run['cache_len']} positions (must pass 2048)")
    run["logits"] = _bf16_logits_rule(lambda: _onevision_chunk_logits(model, [requests[0], requests[-1]]), label)
    model.batch_size = 2  # the plain and f32 paths' [B, H, 4096, 4096] scores stay a few GB
    run["loglikelihood"] = check_loglikelihood(model, {
        "flash_attention": len(requests) * ONEVISION_TOWER_LAUNCHES + len(requests) // 2 * ONEVISION_LAYERS,
        "gqa_decode_attention": 0})
    del model
    _free()
    return run


def run_idefics2(dev) -> dict:
    """Phase 19: idefics2-8b with random bf16 weights drawn on the card
    answers four requests of mixed aspect in one chunk (the processor's
    variable-aspect resize, padded to one 448 x 672 grid: every image's patch
    mask has gaps), 64 greedy tokens: one tower call for the batch (27 K2
    launches at head_dim 72, all in the tensor-mask form), 32 prefill
    launches (K2's Hopper instance at G = 4) and 32 K3 launches per step,
    read around each call; the chunk's prefill logits by phase 4's rule;
    ``loglikelihood`` on phase 3's 8 images by phase 10's."""
    label = f"{IDEFICS2_PRESET} bf16"
    model, requests, run = serve_bf16(dev, IDEFICS2_PRESET, IDEFICS2_SIZES, {}, label, _siglip_per_call())
    _check_tower_launches(run, label, "siglip_vision_forward", 1, IDEFICS2_TOWER_LAUNCHES, IDEFICS2_LAYERS,
                          tensor_mask=True)
    lengths = [len(model.tokenizer.encode(model._build_prompt(r.args[0], 1))) for r in requests]
    pixels, _, patch_mask = model._preprocess_hf([model._visuals(r.args)[0] for r in requests])
    run.update(prompt_tokens=lengths, grid=list(pixels.shape[2:]), valid_patches=patch_mask.sum(1).tolist())
    log(f"{label}: prompts of {lengths} tokens, images padded to {run['grid']}, valid patches {run['valid_patches']}")
    if lengths != [IDEFICS2_PROMPT_TOKENS] * len(requests) or not (patch_mask == 0).any(1).all():
        raise AssertionError(f"{label}: prompts of {lengths} tokens (phase 2 holds {IDEFICS2_PROMPT_TOKENS}); "
                             f"every image's patch mask must have gaps: {run['valid_patches']}")
    run["logits"] = _bf16_logits_rule(lambda: _idefics2_chunk_logits(model, requests), label)
    run["loglikelihood"] = check_loglikelihood(model, {
        "flash_attention": IDEFICS2_TOWER_LAUNCHES + IDEFICS2_LAYERS,
        "flash_attention_tensor_mask": IDEFICS2_TOWER_LAUNCHES, "gqa_decode_attention": 0})
    del model
    _free()
    return run


def onevision_checkpoint_config() -> dict:
    """``llava-onevision-qwen2-7b-ov``'s preset (full width) with the decoder
    cut to ``SIGLIP_CKPT_LAYERS`` layers, in the released config.json's form."""
    from lmms_owc_tpu_torch.models.llava_onevision import PRESET_CONFIGS

    cfg = json.loads(json.dumps(PRESET_CONFIGS[ONEVISION_PRESET]))
    cfg["text_config"]["num_hidden_layers"] = SIGLIP_CKPT_LAYERS
    cfg["vision_config"]["vision_use_head"] = False  # the released tower has no pooling head
    cfg.update(model_type="llava_onevision", architectures=["LlavaOnevisionForConditionalGeneration"])
    return cfg


def idefics2_checkpoint_config() -> dict:
    """``idefics2-8b``'s preset (full width) with the decoder cut to
    ``SIGLIP_CKPT_LAYERS`` layers, in the released config.json's form."""
    from lmms_owc_tpu_torch.models.idefics2 import PRESET_CONFIGS

    cfg = json.loads(json.dumps(PRESET_CONFIGS[IDEFICS2_PRESET]))
    cfg["text_config"]["num_hidden_layers"] = SIGLIP_CKPT_LAYERS
    # The released form names the perceiver's width and epsilon (the port's defaults for the preset).
    cfg["perceiver_config"].update(hidden_size=cfg["text_config"]["hidden_size"], rms_norm_eps=1e-6)
    cfg.update(model_type="idefics2", architectures=["Idefics2ForConditionalGeneration"])
    return cfg


def idefics2_tokenizer() -> dict:
    """Idefics2's Mistral ``tokenizer.json`` form: :func:`llama2_tokenizer`
    with ``<fake_token_around_image>``, ``<image>`` and ``<end_of_utterance>``
    as added tokens at 32000-32002, inside the 32003-token vocabulary."""
    blob = llama2_tokenizer()
    blob["added_tokens"] = [t for t in blob["added_tokens"] if t["id"] < 32000] + [
        {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
         "special": True} for t, i in IDEFICS2_SPECIAL_IDS.items()]
    return blob


def write_siglip_checkpoint(family: str, dev, path: Path, seed: int) -> tuple[object, dict, dict]:
    """A full-width checkpoint of ``family`` ("onevision" or "idefics2") with
    ``SIGLIP_CKPT_LAYERS`` decoder layers: random bf16 weights drawn on the
    card into the port's module tree, written under the published tensor
    names with config.json and the family's tokenizer (the Qwen2 fixture with
    its specials and ``<image>`` at their published ids; the Mistral form of
    :func:`idefics2_tokenizer`). Returns (written model, config, write stats)."""
    import torch

    from lmms_owc_tpu_torch.models import llava_onevision as ov
    from lmms_owc_tpu_torch.nn import idefics2 as idf
    from lmms_owc_tpu_torch.nn.llama import llama_config_from_hf

    gen = torch.Generator(device=dev).manual_seed(seed)
    if family == "onevision":
        cfg = onevision_checkpoint_config()
        vis = cfg["vision_config"]
        vision = idf.SiglipVisionConfig(hidden_size=vis["hidden_size"], num_layers=vis["num_hidden_layers"],
                                        num_heads=vis["num_attention_heads"],
                                        intermediate_size=vis["intermediate_size"],
                                        image_size=vis["image_size"], patch_size=vis["patch_size"])
        decoder = llama_config_from_hf(cfg["text_config"]).to_decoder_config()
        written = _random_module(ov.OnevisionModel(decoder, vision, True, torch.bfloat16, dev), gen)
        prefixes, label = ONEVISION_HF_PREFIXES, f"{ONEVISION_PRESET} width, {SIGLIP_CKPT_LAYERS} layers"
        tokenizer = pinned_tokenizer(json.loads(FIXTURE_TOKENIZER.read_text()),
                                     {**QWEN2_SPECIAL_IDS, "<image>": ONEVISION_IMAGE_ID})
        tokenizer_config = {"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
                            "clean_up_tokenization_spaces": False}
    else:
        cfg = idefics2_checkpoint_config()
        config = idf.idefics2_config_from_hf(cfg)
        # HF's connector: the modality projection's inner width is the text intermediate size.
        written = _random_module(idf.Idefics2Model(config, torch.bfloat16, dev, config.text.intermediate_size), gen)
        prefixes, label = IDEFICS2_HF_PREFIXES, f"{IDEFICS2_PRESET} width, {SIGLIP_CKPT_LAYERS} layers"
        tokenizer, tokenizer_config = idefics2_tokenizer(), dict(LLAMA2_TOKENIZER_CONFIG, pad_token="<unk>")
    out = write_tensors(_hf_layout(written, _NameProbe(prefixes)), path, label)
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "tokenizer.json").write_text(json.dumps(tokenizer))
    (path / "tokenizer_config.json").write_text(json.dumps(tokenizer_config))
    return written, cfg, out


def run_siglip_checkpoints(dev) -> dict:
    """Phase 20: for each SigLIP family, a full-width checkpoint with
    ``SIGLIP_CKPT_LAYERS`` decoder layers and the full tower
    (:func:`write_siglip_checkpoint`), loaded with ``pretrained=``: every
    parameter bit-equal to what was written, and the family's requests
    (phase 18's and phase 19's images) give the tokens of the model it was
    written from, through the loaded tokenizer."""
    import copy as _copy

    out = {}
    for family, preset, sizes, seed in (("onevision", ONEVISION_PRESET, None, 18),
                                        ("idefics2", IDEFICS2_PRESET, IDEFICS2_SIZES, 19)):
        root = Path(tempfile.mkdtemp(prefix=f"owc_{family}_"))
        try:
            written, _, stats = write_siglip_checkpoint(family, dev, root, seed)
            model, stats["load"] = _load(dev, preset, root, batch_size=NUM_REQUESTS)
            stats["parameters_bit_equal"] = _same_parameters(model.model, written, f"{family} checkpoint load")
            served = _copy.copy(model)  # the same adapter (config, tokenizer) over the written modules
            served.model = written
            requests = _requests(model, sizes)
            served.task_dict = model.task_dict
            want: list = []
            _serve(served, requests, want, require_text=False)
            got: list = []
            run = _serve(model, requests, got, require_text=False)
            _same_tokens(f"{family} checkpoint load", got, want)
            _log_run(f"{preset} checkpoint", run)
            stats["serve"] = dict(run, tokens_identical=True)
            del served, written, model
            _free()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out[family] = stats
        log(f"{family} checkpoint: {json.dumps(_phase_summary(stats))}")
    return out


# --------------------------------------------------- InternVL2 and InstructBLIP


def _internvl_per_call():
    """InternVL2's serving entries whose launches :func:`_serve` reads per
    call: the tower, the prefill and each decode step."""
    from lmms_owc_tpu_torch.nn import internvl as nniv
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    return (nniv, "internvit_forward"), (nnq, "prefill"), (nnq, "decode_step")


def _blip_per_call():
    """InstructBLIP's serving entries read per call: the tower, the Q-Former,
    the prefill and each decode step."""
    from lmms_owc_tpu_torch.nn import instructblip as nnib
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    return (nnib, "blip_vision_forward"), (nnib, "qformer_forward"), (nnq, "prefill"), (nnq, "decode_step")


def _family_chunk_logits(model, requests):
    """One chunk of InternVL2 or InstructBLIP requests: the adapter's
    preparation (tower, projector or Q-Former, embeddings), then the prefill."""
    embeds, pos, mask, _, bucket = model._prepare_chunk([r.args for r in requests])
    return _prefill_logits(model, embeds, pos, mask, bucket)


def _prompt_layout(run: dict, label: str, lengths: list[int], want: list[int]) -> None:
    """Record the prompts' lengths, bucket and decode cache; they must be those phase 2 holds."""
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    bucket = pad_to_bucket(max(lengths))
    run.update(prompt_tokens=lengths, bucket=bucket, cache_len=bucket + MAX_NEW_TOKENS)
    log(f"{label}: prompts of {lengths} tokens, bucket {bucket}, decode cache {run['cache_len']} positions")
    if lengths != want:
        raise AssertionError(f"{label}: prompts of {lengths} tokens, phase 2 holds {want}")


def run_internvl(dev) -> dict:
    """Phase 21: internvl2-2b with random bf16 weights drawn on the card
    answers phase 3's 8 requests in one chunk (a 448x448 image is one tile, a
    336x448 one 6 tiles and a thumbnail: 20 tiles, prompts of 279 and 1815
    tokens, bucket 2048, decode cache 2112: K3's Hopper instance at G = 6),
    64 greedy tokens: one tower call of 24 K2 launches (head_dim 64), 28
    prefill launches and 28 K3 per decode step, read around each call; the
    chunk's prefill logits by phase 4's rule; ``loglikelihood`` by phase 10's."""
    label = f"{INTERNVL_PRESET} bf16"
    model, requests, run = serve_bf16(dev, INTERNVL_PRESET, None, {}, label, _internvl_per_call())
    _check_tower_launches(run, label, "internvit_forward", 1, INTERNVL_TOWER_LAUNCHES, INTERNVL_LAYERS)
    sizes = [(448, 448)] * 6 + [(336, 448)] * 2
    tiles = [len(model._tile_images(model._request_visuals(*r.args[2:6]))[0]) for r in requests]
    lengths = [len(model.tokenizer.encode(model._build_prompt(PROMPT, [n]))) for n in tiles]
    run["tiles"] = tiles
    _prompt_layout(run, label, lengths, [INTERNVL_PROMPT_TOKENS[size] for size in sizes])
    if tiles != [INTERNVL_TILES[size] for size in sizes] or run["cache_len"] <= 2048:
        raise AssertionError(f"{label}: tiles {tiles}, decode cache {run['cache_len']} (must pass 2048)")
    run["logits"] = _bf16_logits_rule(lambda: _family_chunk_logits(model, requests), label)
    run["loglikelihood"] = check_loglikelihood(model, {
        "flash_attention": INTERNVL_TOWER_LAUNCHES + INTERNVL_LAYERS, "gqa_decode_attention": 0})
    del model
    _free()
    return run


def run_instructblip(dev) -> dict:
    """Phase 22: instructblip-vicuna-7b with random bf16 weights drawn on the
    card answers phase 3's 8 requests in one chunk (224 px, 32 queries and 9
    text tokens, bucket 128, decode cache 192), 64 greedy tokens: one tower
    call of 39 K2 launches at head_dim 88 (the Hopper instance, over the
    fused qkv's head-offset views), no launch in the Q-Former, 32 prefill
    launches and 32 K3 per decode step, read around each call; the chunk's
    prefill logits by phase 4's rule; ``loglikelihood`` by phase 10's."""
    label = f"{BLIP_PRESET} bf16"
    model, requests, run = serve_bf16(dev, BLIP_PRESET, None, {}, label, _blip_per_call())
    qformer = run["per_call"].pop("qformer_forward")
    if qformer != [{}]:
        raise AssertionError(f"{label}: the Q-Former's call launched {qformer}, expected one call and no launch")
    _check_tower_launches(run, label, "blip_vision_forward", 1, BLIP_TOWER_LAUNCHES, BLIP_LAYERS)
    run["per_call"]["qformer_forward"] = qformer
    lengths = [model.config.num_query_tokens + len(model.tokenizer.encode(PROMPT))] * len(requests)
    _prompt_layout(run, label, lengths, [BLIP_PROMPT_TOKENS] * len(requests))
    run["logits"] = _bf16_logits_rule(lambda: _family_chunk_logits(model, requests), label)
    run["loglikelihood"] = check_loglikelihood(model, {
        "flash_attention": BLIP_TOWER_LAUNCHES + BLIP_LAYERS, "gqa_decode_attention": 0})
    del model
    _free()
    return run


def internvl_checkpoint_config() -> dict:
    """``internvl2-2b``'s preset (full width) with the decoder cut to
    ``FAMILY_CKPT_LAYERS`` layers, in the released "-hf" config.json's form."""
    from lmms_owc_tpu_torch.models.internvl2 import PRESET_CONFIGS

    cfg = json.loads(json.dumps(PRESET_CONFIGS[INTERNVL_PRESET]))
    cfg["text_config"]["num_hidden_layers"] = FAMILY_CKPT_LAYERS
    cfg["text_config"].pop("rope_scaling", None)  # the released configs have none (plain RoPE)
    cfg["vision_config"].update(use_qk_norm=False, attention_bias=True, layer_norm_eps=1e-6, use_mean_pooling=True)
    cfg.update(model_type="internvl", architectures=["InternVLForConditionalGeneration"], downsample_ratio=0.5,
               vision_feature_layer=-1, vision_feature_select_strategy="default")
    return cfg


def instructblip_checkpoint_config() -> dict:
    """``instructblip-vicuna-7b``'s preset (full width) with the decoder cut to
    ``FAMILY_CKPT_LAYERS`` layers, in the released config.json's form."""
    from lmms_owc_tpu_torch.models.instructblip import PRESET_CONFIGS

    cfg = json.loads(json.dumps(PRESET_CONFIGS[BLIP_PRESET]))
    cfg["text_config"]["num_hidden_layers"] = FAMILY_CKPT_LAYERS
    cfg.update(model_type="instructblip", architectures=["InstructBlipForConditionalGeneration"])
    return cfg


def write_family_checkpoint(family: str, dev, path: Path, seed: int) -> tuple[object, dict]:
    """A full-width checkpoint of ``family`` ("internvl" or "instructblip")
    with ``FAMILY_CKPT_LAYERS`` decoder layers: random bf16 weights drawn on
    the card into the port's module tree (InternViT in its released form,
    without a final LN), written under the published tensor names with
    config.json and the family's tokenizers (the Qwen2 fixture with its
    specials and ``<img>``, ``</img>``, ``<IMG_CONTEXT>`` at their published
    ids; the Llama-2 form of :func:`llama2_tokenizer` and a
    ``qformer_tokenizer/`` of BERT's 30522-entry layout). Returns (written
    model, write stats)."""
    import torch

    from lmms_owc_tpu_torch.nn import instructblip as ib
    from lmms_owc_tpu_torch.nn import internvl as iv

    gen = torch.Generator(device=dev).manual_seed(seed)
    if family == "internvl":
        cfg = internvl_checkpoint_config()
        written = _random_module(iv.InternVLModel(iv.internvl_config_from_hf(cfg), torch.bfloat16, dev,
                                                  final_ln=False), gen)
        prefixes = INTERNVL_HF_PREFIXES
        tokenizer = pinned_tokenizer(json.loads(FIXTURE_TOKENIZER.read_text()),
                                     {**QWEN2_SPECIAL_IDS, **INTERNVL_SPECIAL_IDS})
        tokenizer_config = {"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
                            "clean_up_tokenization_spaces": False}
    else:
        cfg = instructblip_checkpoint_config()
        written = _random_module(ib.InstructBlipModel(ib.instructblip_config_from_hf(cfg), torch.bfloat16, dev), gen)
        prefixes = BLIP_HF_PREFIXES
        tokenizer = llama2_tokenizer()
        tokenizer["added_tokens"] = [t for t in tokenizer["added_tokens"] if t["content"] != "<pad>"]
        tokenizer_config = dict(LLAMA2_TOKENIZER_CONFIG, pad_token="<unk>")
        qdir = path / "qformer_tokenizer"
        qdir.mkdir()
        (qdir / "vocab.txt").write_text("\n".join(minilm_vocab()) + "\n")
        (qdir / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": True, "model_max_length": 512}))
    # InternViT's and BLIP's class and position embeddings and the Q-Former's
    # query tokens are [1, N, E] in the published checkpoints.
    layout = [(name, t.reshape(1, -1, t.shape[-1]) if name.endswith(FAMILY_3D_TENSORS) else t)
              for name, t in _hf_layout(written, _NameProbe(prefixes))]
    out = write_tensors(layout, path, f"{family} at full width, {FAMILY_CKPT_LAYERS} decoder layers")
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "tokenizer.json").write_text(json.dumps(tokenizer))
    (path / "tokenizer_config.json").write_text(json.dumps(tokenizer_config))
    return written, out


def run_family_checkpoints(dev) -> dict:
    """Phase 23: for InternVL2 and InstructBLIP, a full-width checkpoint with
    ``FAMILY_CKPT_LAYERS`` decoder layers and the full tower
    (:func:`write_family_checkpoint`), loaded with ``pretrained=``: every
    parameter bit-equal to what was written, and phase 3's requests give the
    tokens of the model it was written from, through the loaded tokenizers."""
    import copy as _copy

    out = {}
    for family, preset, seed in (("internvl", INTERNVL_PRESET, 21), ("instructblip", BLIP_PRESET, 22)):
        root = Path(tempfile.mkdtemp(prefix=f"owc_{family}_"))
        try:
            written, stats = write_family_checkpoint(family, dev, root, seed)
            model, stats["load"] = _load(dev, preset, root, batch_size=NUM_REQUESTS)
            stats["parameters_bit_equal"] = _same_parameters(model.model, written, f"{family} checkpoint load")
            if family == "instructblip" and model.qformer_tokenizer is None:
                raise AssertionError("instructblip checkpoint: the qformer_tokenizer/ directory was not read")
            served = _copy.copy(model)  # the same adapter (config, tokenizers) over the written modules
            served.model = written
            requests = _requests(model)
            served.task_dict = model.task_dict
            want: list = []
            _serve(served, requests, want, require_text=False)
            got: list = []
            run = _serve(model, requests, got, require_text=False)
            _same_tokens(f"{family} checkpoint load", got, want)
            _log_run(f"{preset} checkpoint", run)
            stats["serve"] = dict(run, tokens_identical=True)
            del served, written, model
            _free()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out[family] = stats
        log(f"{family} checkpoint: {json.dumps(_phase_summary(stats))}")
    return out


# ---------------------------------------------------------------- Phi-3-Vision


def _phi3v_per_call():
    """Phi-3-Vision's serving entries whose launches :func:`_serve` reads per
    call: the CLIP tower (one call per image), the prefill and each decode step."""
    from lmms_owc_tpu_torch.nn import clip as nnclip
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    return (nnclip, "clip_vision_forward"), (nnq, "prefill"), (nnq, "decode_step")


def phi3v_smoke_config() -> dict:
    """``phi3v``'s preset (the published widths) with a longrope scaling of
    the released config's form: 48 short and long factors."""
    from lmms_owc_tpu_torch.models.phi3v import PRESET_CONFIGS

    cfg = json.loads(json.dumps(PRESET_CONFIGS[PHI3V_PRESET]))
    cfg["text_config"]["rope_scaling"] = {"type": "longrope", "short_factor": PHI3V_SHORT_FACTORS,
                                          "long_factor": PHI3V_LONG_FACTORS}
    return cfg


@contextmanager
def _phi3v_smoke_preset():
    """:func:`phi3v_smoke_config` registered as the adapter's preset
    ``PHI3V_SMOKE_PRESET`` for the block."""
    from lmms_owc_tpu_torch.models import phi3v as p3

    p3.PRESET_CONFIGS[PHI3V_SMOKE_PRESET] = phi3v_smoke_config()
    try:
        yield
    finally:
        p3.PRESET_CONFIGS.pop(PHI3V_SMOKE_PRESET, None)


def phi3v_prompt_tokens(sizes=None) -> list[int]:
    """The prompt length of each of phase 3's requests (or of ``sizes``) at
    phase 24's configuration, computed: the HD transform's crop grid (h x w
    crops of 336 px, at most ``PHI3V_CROPS``) gives (h*w)*144 + h*12 + 1 +
    12*13 image rows (half = 12 units a side), and the fallback tokenizer the
    prompt's other tokens."""
    from types import SimpleNamespace

    from PIL import Image

    from lmms_owc_tpu_torch.models import phi3v as p3

    vision = p3.clip_config(p3.PRESET_CONFIGS[PHI3V_PRESET]["vision_config"])
    size, half = vision.image_size, vision.image_size // vision.patch_size // 2
    text = len(p3._FallbackPhi3Tokenizer().encode(p3.Phi3v._build_prompt(None, PROMPT, 1))) - 1
    out = []
    for h, w in sizes or [(448, 448)] * 6 + [(336, 448)] * 2:
        hd = p3.Phi3v._hd_transform(SimpleNamespace(vision_config=vision), Image.new("RGB", (w, h)), PHI3V_CROPS)
        rows, cols = hd.size[1] // size, hd.size[0] // size
        out.append(rows * cols * half * half + rows * half + 1 + half * (half + 1) + text)
    return out


def run_phi3v(dev) -> tuple[dict, object]:
    """Phase 24: phi3v at the published widths (CLIP ViT-L/14-336, Phi-3-mini
    with :func:`phi3v_smoke_config`'s longrope scaling) with random bf16
    weights drawn on the card answers phase 3's 8 requests in one chunk at 16
    crops (4x4 crops for a 448x448 image, 3x4 for a 336x448 one, each with its
    global view; the prompt lengths of :func:`phi3v_prompt_tokens`, bucket
    3072, decode cache 3136: K3's Hopper instance at head_dim 96), 64 greedy
    tokens, with the port's host stage timers on: one tower call per image of
    23 K2 launches (head_dim 64), 32 prefill launches (head_dim 96) and 32 K3
    per decode step, read around each call; the prefill logits of a chunk of
    one image of each size by phase 4's rule; ``loglikelihood`` by phase
    10's, at batch 2. Returns the run and the model (phase 23 writes its
    checkpoint from it)."""
    from lmms_owc_tpu_torch.models.phi3v import IMAGE_TOKEN_ID

    label = f"{PHI3V_PRESET} bf16"
    with _phi3v_smoke_preset():
        model, requests, run = serve_bf16(dev, PHI3V_PRESET, None, {}, label, _phi3v_per_call(), host_timers=True,
                                          preset=PHI3V_SMOKE_PRESET, num_crops=PHI3V_CROPS)
    log(f"{label} host stages: {'; '.join(run['hostprof'])}")
    factor = model.decoder_config.rope_longrope[0]
    if model.decoder_config.head_dim != 96 or not 1.19 < factor < 1.20:
        raise AssertionError(f"{label}: head_dim {model.decoder_config.head_dim}, longrope attention factor {factor}")
    _check_tower_launches(run, label, "clip_vision_forward", len(requests), PHI3V_TOWER_LAUNCHES, PHI3V_LAYERS)
    prepared = model._prepare_rows([(PROMPT, model._request_visuals(*r.args[2:6]), []) for r in requests])
    lengths = [len(ids) for ids, _ in prepared]
    run["image_rows"] = [sum(t == IMAGE_TOKEN_ID for t in ids) for ids, _ in prepared]
    run["longrope_attention_factor"] = factor
    _prompt_layout(run, label, lengths, phi3v_prompt_tokens())
    if run["cache_len"] <= 2048:
        raise AssertionError(f"{label}: decode cache {run['cache_len']} (must pass 2048)")
    run["logits"] = _bf16_logits_rule(lambda: _family_chunk_logits(model, [requests[0], requests[-1]]), label)
    model.batch_size = 2  # the plain and f32 paths' [B, 32, 3072, 3072] scores stay a few GB
    run["loglikelihood"] = check_loglikelihood(model, {
        "flash_attention": len(requests) * PHI3V_TOWER_LAUNCHES + len(requests) // 2 * PHI3V_LAYERS,
        "gqa_decode_attention": 0})
    model.batch_size = NUM_REQUESTS
    _free()
    return run, model


def phi3v_checkpoint_config() -> dict:
    """:func:`phi3v_smoke_config`'s decoder (full width, its longrope
    scaling) cut to ``FAMILY_CKPT_LAYERS`` layers, in the released
    config.json's form: the Phi-3 decoder's fields at the top level, the
    image embedding's settings, no ``vision_config`` (the adapter takes
    CLIP-L/336)."""
    text = phi3v_smoke_config()["text_config"]
    return {**text, "num_hidden_layers": FAMILY_CKPT_LAYERS, "model_type": "phi3_v",
            "architectures": ["Phi3VForCausalLM"], "pad_token_id": PHI3V_SPECIAL_IDS["<|endoftext|>"],
            "bos_token_id": 1, "eos_token_id": PHI3V_SPECIAL_IDS["<|end|>"],
            "embd_layer": {"embedding_cls": "image", "hd_transform_order": "sub_glb", "projection_cls": "mlp",
                           "use_hd_transform": True, "with_learnable_separator": True},
            "img_processor": {"image_dim_out": 1024, "model_name": "openai/clip-vit-large-patch14-336",
                              "name": "clip_vision_model", "num_img_tokens": 144}}


def phi3v_tokenizer() -> dict:
    """The Llama-2 form of :func:`llama2_tokenizer` (``byte_fallback``) with
    its ``<image>`` and ``<pad>`` replaced by Phi-3's five added tokens at
    their published ids (``PHI3V_SPECIAL_IDS``; the ids between them added
    fillers)."""
    blob = llama2_tokenizer()
    blob["added_tokens"] = [t for t in blob["added_tokens"] if t["id"] < 32000]
    return pinned_tokenizer(blob, PHI3V_SPECIAL_IDS)


def phi3v_layout(written) -> list[tuple[str, object]]:
    """(checkpoint name, tensor) of a :class:`Phi3vModel` in the released
    layout: the decoder under ``model.`` with each layer's q/k/v fused into
    ``qkv_proj`` and gate/up into ``gate_up_proj``, the CLIP tower under
    ``model.vision_embed_tokens.img_processor.``, ``img_projection.0/2``, and
    ``sub_GN`` [1, 1, 1, 4E] and ``glb_GN`` [1, 1, 4E]."""
    import torch

    tensors = dict(_hf_layout(written, _NameProbe(PHI3V_HF_PREFIXES)))
    fused = {"self_attn.q_proj.weight": ("self_attn.qkv_proj.weight", ("q_proj", "k_proj", "v_proj")),
             "mlp.gate_proj.weight": ("mlp.gate_up_proj.weight", ("gate_proj", "up_proj"))}
    out = []
    for name, t in tensors.items():
        if name.startswith("model.layers."):
            if name.endswith(("self_attn.k_proj.weight", "self_attn.v_proj.weight", "mlp.up_proj.weight")):
                continue  # fused into the tensor of the first part
            for first, (target, parts) in fused.items():
                if name.endswith(first):
                    t = torch.cat([tensors[name.replace(parts[0], part)] for part in parts])
                    name = name[: -len(first)] + target
        elif name.endswith("sub_GN"):
            t = t.reshape(1, 1, 1, -1)
        elif name.endswith("glb_GN"):
            t = t.reshape(1, 1, -1)
        out.append((name, t))
    return out


def run_phi3v_checkpoint(dev, model) -> dict:
    """Phase 23, phi3v (run after phase 24, from its model): the phase-24
    model's tower, projector, separators, embeddings, head and first
    ``FAMILY_CKPT_LAYERS`` decoder layers, written at full width in the
    released layout (:func:`phi3v_layout`, :func:`phi3v_checkpoint_config`,
    :func:`phi3v_tokenizer`), loaded with ``pretrained=``: every parameter
    bit-equal to what was written, and phase 3's requests give the tokens of
    the model it was written from, through the loaded tokenizer."""
    import copy as _copy

    import torch

    from lmms_owc_tpu_torch.models.phi3v import Phi3vModel
    from lmms_owc_tpu_torch.nn.llama import llama_config_from_hf

    cfg = phi3v_checkpoint_config()
    written = Phi3vModel(llama_config_from_hf(cfg), model.vision_config, torch.bfloat16, dev)
    source = dict(model.model.named_parameters())
    with torch.no_grad():
        for name, p in written.named_parameters():
            p.copy_(source[name])
    root = Path(tempfile.mkdtemp(prefix="owc_phi3v_"))
    try:
        stats = write_tensors(phi3v_layout(written), root, f"phi3v at full width, {FAMILY_CKPT_LAYERS} decoder layers")
        (root / "config.json").write_text(json.dumps(cfg))
        (root / "tokenizer.json").write_text(json.dumps(phi3v_tokenizer()))
        (root / "tokenizer_config.json").write_text(json.dumps(dict(
            LLAMA2_TOKENIZER_CONFIG, eos_token="<|end|>", pad_token="<|endoftext|>")))
        loaded, stats["load"] = _load(dev, PHI3V_PRESET, root, batch_size=NUM_REQUESTS, num_crops=PHI3V_CROPS)
        stats["parameters_bit_equal"] = _same_parameters(loaded.model, written, "phi3v checkpoint load")
        if loaded.decoder_config.rope_longrope != model.decoder_config.rope_longrope:
            raise AssertionError("phi3v checkpoint: the longrope scaling did not load as written")
        served = _copy.copy(loaded)  # the same adapter (config, tokenizer) over the written modules
        served.model = written
        requests = _requests(loaded)
        served.task_dict = loaded.task_dict
        want: list = []
        _serve(served, requests, want, require_text=False)
        got: list = []
        run = _serve(loaded, requests, got, require_text=False)
        _same_tokens("phi3v checkpoint load", got, want)
        _log_run(f"{PHI3V_PRESET} checkpoint", run)
        stats["serve"] = dict(run, tokens_identical=True)
        del served, written, loaded
        _free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phi3v checkpoint: {json.dumps(_phase_summary(stats))}")
    return stats


# ------------------------------------------------------------------ scoring

# Words of phase 13's sentences and predictions: the toy answers, the toy prompts' words and a few more.
SCORING_WORDS = (
    "red panda blue jay green sea turtle golden retriever what type of object is in this photo describe the main "
    "a an animal bird dog cat tree sitting on with and near water grass sky small large brown white black"
).split()


def scoring_sentences(n: int, seed: int = 0, min_words: int = 3, max_words: int = 28) -> list[str]:
    """``n`` sentences of ``min_words`` to ``max_words`` words of ``SCORING_WORDS``, from ``seed``."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(SCORING_WORDS, size=int(rng.integers(min_words, max_words + 1))))
            for _ in range(n)]


def judge_prompts(n: int, seed: int = 1) -> list[str]:
    """``n`` textual-inclusion prompts: a random prediction against a toy answer."""
    from lmms_owc_tpu_torch.pipelines.text import TEXTUAL_INCLUSION_TEMPLATE

    answers = ["red panda", "blue jay", "green sea turtle", "golden retriever"]
    preds = scoring_sentences(n, seed, 1, 12)
    return [TEXTUAL_INCLUSION_TEMPLATE % (pred, answers[i % len(answers)]) for i, pred in enumerate(preds)]


def minilm_vocab() -> list[str]:
    """A 30522-entry BERT-uncased-style vocabulary: the specials at their
    published ids, ``SCORING_WORDS``, letters, digits and punctuation (with
    their ``##`` forms), then fillers."""
    vocab = ["[PAD]"] + [f"[unused{k}]" for k in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    singles = list("abcdefghijklmnopqrstuvwxyz0123456789") + list(".,!?;:'\"()-_/*#$%&+=<>@[]^`{|}~")
    for tok in sorted(set(SCORING_WORDS)) + singles + [f"##{c}" for c in singles]:
        if tok not in vocab:
            vocab.append(tok)
    return vocab + [f"[unused{k}]" for k in range(99, 99 + MINILM_CONFIG["vocab_size"] - len(vocab))]


def write_sbert_checkpoint(dev, path: Path, seed: int = 0) -> dict:
    """An HF BERT checkpoint at MiniLM-L6's published config with random f32
    weights drawn on the card from ``seed``: safetensors, ``config.json``,
    ``vocab.txt`` and ``tokenizer_config.json``."""
    import torch

    from lmms_owc_tpu_torch.nn.sbert import SbertModel, init_sbert_params, sbert_config_from_hf

    model = SbertModel(sbert_config_from_hf(MINILM_CONFIG), torch.float32, dev)
    init_sbert_params(model, torch.Generator(device=dev).manual_seed(seed))
    out = write_tensors(_hf_layout(model), path, "minilm-l6")
    (path / "config.json").write_text(json.dumps(MINILM_CONFIG))
    vocab = minilm_vocab()
    if len(vocab) != MINILM_CONFIG["vocab_size"]:
        raise AssertionError(f"MiniLM vocabulary has {len(vocab)} entries")
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (path / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": True, "tokenize_chinese_chars": True}))
    return out


def llama3_tokenizer() -> dict:
    """A Llama-3-form ``tokenizer.json`` over the fixture's byte-level BPE: the
    Llama-3 specials at their published ids, ``Split`` on the Llama-3 pattern
    then ``ByteLevel``, and the ``<|begin_of_text|>`` template."""
    from lmms_owc_tpu_torch.tokenizer import LLAMA3_PATTERN

    blob = pinned_tokenizer(json.loads(FIXTURE_TOKENIZER.read_text()), LLAMA3_SPECIAL_IDS)
    blob["model"]["ignore_merges"] = True
    blob["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated", "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False},
    ]}
    bos = "<|begin_of_text|>"
    blob["post_processor"] = {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False, "use_regex": True},
        {"type": "TemplateProcessing",
         "single": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
         "pair": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                  {"SpecialToken": {"id": bos, "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
         "special_tokens": {bos: {"id": bos, "ids": [LLAMA3_SPECIAL_IDS[bos]], "tokens": [bos]}}},
    ]}
    return blob


def llama2_tokenizer(words=()) -> dict:
    """A Llama-2 / Vicuna-form ``tokenizer.json`` (the form of the released
    llava-hf checkpoints): ``<unk>``/``<s>``/``</s>`` at 0/1/2, the 256
    ``<0xNN>`` byte tokens, the printable ASCII characters and ``▁``, merges
    that build ``▁`` + each of ``words`` (and :data:`LLAVA_WORDS`) letter by
    letter, fillers up to 32000 entries, then ``<image>`` at 32000 and
    ``<pad>`` at 32001. ``Prepend("▁")`` + ``Replace(" ", "▁")``, BPE with
    ``byte_fallback`` and ``fuse_unk``, the ``<s>`` template and the
    ``Replace`` / ``ByteFallback`` / ``Fuse`` / ``Strip`` decoder."""
    specials = ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(specials + [f"<0x{b:02X}>" for b in range(256)])}
    for c in ["\u2581"] + [chr(c) for c in range(0x21, 0x7F)]:
        vocab.setdefault(c, len(vocab))
    merges = []
    for word in dict.fromkeys(list(LLAVA_WORDS) + list(words)):
        piece = "\u2581"
        for c in word:
            if piece + c not in vocab:
                merges.append(f"{piece} {c}")
                vocab[piece + c] = len(vocab)
            piece += c
    while len(vocab) < 32000:
        vocab[f"\u2581fill{len(vocab)}"] = len(vocab)
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for t, i in [("<unk>", 0), ("<s>", 1), ("</s>", 2), ("<image>", 32000), ("<pad>", 32001)]]
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "\u2581"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "\u2581"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "\u2581"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


LLAMA2_TOKENIZER_CONFIG = {
    "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>", "legacy": True,
    "add_bos_token": True, "add_eos_token": False, "clean_up_tokenization_spaces": False,
    "tokenizer_class": "LlamaTokenizer",
}


def judge_checkpoint_config() -> dict:
    """``LLAMA32_3B_CONFIG`` (full width) with its depth cut to ``JUDGE_CKPT_LAYERS``."""
    from lmms_owc_tpu_torch.nn.judge import LLAMA32_3B_CONFIG

    return {**LLAMA32_3B_CONFIG, "num_hidden_layers": JUDGE_CKPT_LAYERS, "model_type": "llama",
            "architectures": ["LlamaForCausalLM"]}


def write_judge_checkpoint(dev, path: Path, seed: int = 0) -> dict:
    """An HF Llama checkpoint at Llama-3.2-3B's width and ``JUDGE_CKPT_LAYERS``
    layers with random bf16 weights drawn on the card from ``seed``, the
    Llama-3-form tokenizer and a Llama-3 chat template."""
    import torch

    from lmms_owc_tpu_torch.nn.llama import init_llama_params, llama_config_from_hf

    cfg = judge_checkpoint_config()
    model = init_llama_params(llama_config_from_hf(cfg), torch.Generator(device=dev).manual_seed(seed))
    out = write_tensors(_hf_layout(model), path, f"llama-3.2-3b width, {JUDGE_CKPT_LAYERS} layers")
    del model
    _free()
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "tokenizer.json").write_text(json.dumps(llama3_tokenizer()))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>", "clean_up_tokenization_spaces": True,
        "chat_template": LLAMA3_CHAT_TEMPLATE}))
    return out


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_sbert(dev, path: Path) -> dict:
    """Phase 13(a): the checkpoint's encoder on ``dev`` in f32 encodes
    ``SBERT_SENTENCES`` sentences at batch ``SBERT_BATCH`` (timed, counted:
    six flash launches per batch), then again with the plain attention;
    every row's embedding (each sentence is a valid row) within ``SBERT_TOL``."""
    from lmms_owc_tpu_torch.nn.sbert import SentenceEncoder
    from lmms_owc_tpu_torch.ops import attention as att

    enc = SentenceEncoder.from_pretrained(str(path), device=dev)
    sentences = scoring_sentences(SBERT_SENTENCES)
    enc.encode(sentences[:SBERT_BATCH], batch_size=SBERT_BATCH)  # warm-up
    _reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    got = enc.encode(sentences, batch_size=SBERT_BATCH)
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = _counts()["flash_attention"]
    with _route(att, "flash_attention", _plain_flash):
        want = enc.encode(sentences, batch_size=SBERT_BATCH)
    batches = -(-len(sentences) // SBERT_BATCH)
    lengths = [enc._bucket_len(enc.tokenizer(sentences[i : i + SBERT_BATCH])["input_ids"].shape[1])
               for i in range(0, len(sentences), SBERT_BATCH)]
    err = float(np.abs(got - want).max())
    norms = np.linalg.norm(got, axis=1)
    if not np.isfinite(got).all() or np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"sbert: embeddings not finite unit vectors (norms {norms.min()}..{norms.max()})")
    if dev.type == "cuda" and launches != enc.config.num_layers * batches:
        raise AssertionError(f"sbert: {launches} flash launches, expected {enc.config.num_layers} per batch")
    if err > SBERT_TOL:
        raise AssertionError(f"sbert: kernel embeddings differ from the plain attention's by {err} > {SBERT_TOL}")
    out = dict(sentences=len(sentences), batch=SBERT_BATCH, length_buckets=lengths, seconds=seconds,
               sentences_per_s=len(sentences) / seconds, flash_launches=launches, max_abs_err=err)
    log(f"scoring sbert: {json.dumps(out)}")
    del enc
    _free()
    return out


def _judge_run(dev, judge, prompts: list[str], int8: bool) -> dict:
    """One scoring pass over ``prompts``, timed, with its launches and peak
    memory; 28 prefill launches per chunk and whole decode steps required."""
    import torch

    cuda = dev.type == "cuda"
    _reset_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    outputs = judge.score_pairs(prompts, None, None)
    _sync(dev)
    seconds = time.perf_counter() - t0
    counts = _counts()
    decode_name = "gqa_decode_attention_int8" if int8 else "gqa_decode_attention"
    layers, chunks = judge.config.num_layers, -(-len(prompts) // judge.batch_size)
    launches = {"flash_attention": counts["flash_attention"], decode_name: counts[decode_name]}
    if cuda and (launches["flash_attention"] != layers * chunks or not launches[decode_name]
                 or launches[decode_name] % layers):
        raise AssertionError(f"judge: launches {launches}, expected {layers} per prefill chunk and per decode step")
    return dict(prompts=len(prompts), seconds=seconds, prompts_per_s=len(prompts) / seconds,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                decode_steps=launches[decode_name] // layers, counts=launches, outputs=outputs)


def check_judge(dev, prompts: list[str] | None = None, make=None) -> dict:
    """Phase 13(b): the judge at Llama-3.2-3B's width with random weights
    (``make(int8)``, by default ``JudgeModel.random_init`` on ``dev``) scores
    the prompts at batch ``JUDGE_BATCH`` in bf16 and in int8 with the int8 KV
    cache, each unpooled and under ``LMMS_OWC_JUDGE_DECODE_POOL`` =
    ``JUDGE_POOL``; pooled answers must equal unpooled ones on every row. One
    bf16 chunk's prefill logits are held by phase 4's rule."""
    from lmms_owc_tpu_torch.nn import qwen2_vl as qvl
    from lmms_owc_tpu_torch.nn.judge import JudgeModel

    prompts = prompts or judge_prompts(JUDGE_PROMPTS)
    make = make or (lambda int8: JudgeModel.random_init(seed=0, load_in_8bit=int8, device=dev))
    forms, logits, answers = {}, None, None
    for int8 in (False, True):
        t0 = time.perf_counter()
        judge = make(int8)
        judge.batch_size = JUDGE_BATCH
        _sync(dev)
        init_seconds = time.perf_counter() - t0
        label = "int8_kv_int8" if int8 else "bf16"
        with _env(LMMS_OWC_KV_INT8="1" if int8 else "0"):
            with _env(LMMS_OWC_JUDGE_DECODE_POOL="0"):
                forms[label] = _judge_run(dev, judge, prompts, int8)
            with _env(LMMS_OWC_JUDGE_DECODE_POOL=str(JUDGE_POOL)):
                forms[f"{label}_pool{JUDGE_POOL}"] = _judge_run(dev, judge, prompts, int8)
        forms[label]["init_seconds"] = init_seconds
        base, pooled = forms[label].pop("outputs"), forms[f"{label}_pool{JUDGE_POOL}"].pop("outputs")
        bad = [i for i, (a, b) in enumerate(zip(base, pooled, strict=True)) if a != b]
        if bad:
            raise AssertionError(f"judge {label}: pooled answers differ from unpooled ones on rows {bad}: "
                                 f"{pooled[bad[0]]!r} vs {base[bad[0]]!r}")
        forms[label]["pooled_same_rows"] = len(base)
        forms[label]["sample"] = base[0]
        answers = answers if int8 else base
        if not int8 and dev.type == "cuda":
            prepared = judge._prepare_chunk(prompts[:JUDGE_BATCH])
            embeds, pos, mask, _ = judge._inputs(prepared)

            def chunk_logits():
                out, _ = qvl.prefill(judge.model, embeds, pos, mask, prepared[0])
                if not bool(out.isfinite().all()):
                    raise AssertionError("judge prefill logits have non-finite values")
                return out

            logits = _bf16_logits_rule(chunk_logits, "judge bf16")
            del embeds, pos, mask
        del judge
        _free()
    out = dict(forms=forms, logits=logits, batch=JUDGE_BATCH, pool=JUDGE_POOL)
    log(f"scoring judge: {json.dumps(out)}")
    out["answers"] = answers  # the bf16 unpooled answers, phase 25(d)'s bar
    return out


def _copy_runs(cli_out: Path, runs: Path) -> dict[str, list[str]]:
    """Phase 12's generate_until samples as ``runs/{task}/{player}/``: the bf16
    run (a) as one player on toy, toy_multiround and toy_semantic, the int8
    pooled run (b) as another on toy."""
    players = {"qwen2-vl-7b-bf16": ("a", ("toy", "toy_multiround", "toy_semantic")),
               "qwen2-vl-7b-int8-pool2": ("b", ("toy",))}
    copied: dict[str, list[str]] = {}
    for player, (run, tasks) in players.items():
        for task in tasks:
            files = list((cli_out / run).rglob(f"*_samples_{task}.jsonl"))
            if not files:
                continue
            dst = runs / task / player
            dst.mkdir(parents=True, exist_ok=True)
            shutil.copy(files[0], dst / files[0].name)
            copied.setdefault(player, []).append(task)
    return copied


def run_offline(dev, cli_out: Path, root: Path, sbert_dir: Path, judge_dir: Path) -> dict:
    """Phase 13(c): with ``LMMS_OWC_SBERT_PATH`` and ``LMMS_OWC_JUDGE_PATH`` set
    to the two checkpoints, ``eval_metrics.main`` scores phase 12's samples
    with the four scoring metrics (written back into the files) and
    ``eval_ranking.main`` ranks the two players by each criterion. Fails when
    a fallback scorer was taken, a value is not finite, a column was not
    written back or (on the card) K2 or K3 was not launched."""
    import math

    from lmms_owc_tpu_torch import eval_metrics, eval_ranking
    from lmms_owc_tpu_torch.nn.judge import JudgeModel
    from lmms_owc_tpu_torch.nn.sbert import SentenceEncoder
    from lmms_owc_tpu_torch.pipelines import text

    runs = root / "runs"
    players = _copy_runs(cli_out, runs)
    out: dict = dict(players=players, judge_checkpoint_layers=JUDGE_CKPT_LAYERS)
    text._sentence_encoder = text._judge = None
    try:
        with _env(LMMS_OWC_SBERT_PATH=str(sbert_dir), LMMS_OWC_JUDGE_PATH=str(judge_dir)):
            _reset_counts()
            t0 = time.perf_counter()
            metrics = eval_metrics.main(["-i", str(runs), "-m", ",".join(SCORING_METRICS)])
            _sync(dev)
            out["eval_metrics"] = dict(seconds=time.perf_counter() - t0, counts=_counts(), results=metrics)
            scorers = {"sentence_encoder": type(text._sentence_encoder).__name__, "judge": type(text._judge).__name__}
            if not (isinstance(text._sentence_encoder, SentenceEncoder) and isinstance(text._judge, JudgeModel)):
                raise AssertionError(f"offline scoring took a fallback scorer: {scorers}")
            out["scorers"] = scorers
            for task, by_player in metrics.items():
                for player, values in by_player.items():
                    bad = {k: v for k, v in values.items() if not k.startswith("_") and not math.isfinite(v)}
                    if bad or not set(SCORING_METRICS) <= set(values):
                        raise AssertionError(f"eval_metrics {task}/{player}: {values}")
            for file in runs.rglob("*.jsonl"):
                columns = set(json.loads(file.read_text().splitlines()[0]))
                if not set(SCORING_METRICS) <= columns:
                    raise AssertionError(f"eval_metrics did not write its columns back into {file}: {columns}")
            out["ranking"] = {}
            for criterion in ("llama_score", "semantic_similarity"):
                _reset_counts()
                t0 = time.perf_counter()
                boards = eval_ranking.main(["-i", str(runs), "-c", criterion, "-n", str(RANKING_GAMES),
                                            "-b", str(RANKING_ROUNDS)])
                _sync(dev)
                if set(boards.get("toy", {}).get("final", {})) != set(players):
                    raise AssertionError(f"eval_ranking {criterion}: leaderboards {boards}")
                out["ranking"][criterion] = dict(seconds=time.perf_counter() - t0, counts=_counts(), leaderboards=boards)
    finally:
        text._sentence_encoder = text._judge = None
        _free()
    if dev.type == "cuda":
        counts = out["eval_metrics"]["counts"]
        if not (counts["flash_attention"] and counts["gqa_decode_attention"]):
            raise AssertionError(f"offline scoring did not launch K2 and K3: {counts}")
        if not out["ranking"]["llama_score"]["counts"]["gqa_decode_attention"]:
            raise AssertionError("eval_ranking llama_score did not launch K3")
    log(f"scoring offline: {json.dumps(out)}")
    return out


def run_scoring(dev, cli_out: Path, root: Path, sbert_dir: Path) -> dict:
    """Phase 13: (a) :func:`check_sbert`, (b) :func:`check_judge`, then the judge
    checkpoint is written and (c) :func:`run_offline` runs the offline CLIs."""
    t0 = time.perf_counter()
    summary = dict(sbert=check_sbert(dev, sbert_dir), judge=check_judge(dev))
    judge_dir = root / "judge"
    judge_dir.mkdir()
    summary["judge_checkpoint"] = write_judge_checkpoint(dev, judge_dir)
    summary["offline"] = run_offline(dev, cli_out, root, sbert_dir, judge_dir)
    summary["phase_seconds"] = time.perf_counter() - t0
    return summary


def _phase_summary(phase: dict) -> dict:
    """Phase 9's numbers without the per-run sample strings."""
    keys = ("images", "seconds", "images_per_s", "phase_seconds", "peak_gb", "decode_steps", "counts", "load_seconds",
            "load_peak_above_gb", "model_gb", "peak_bound_gb", "parameters_bit_equal", "tokens_identical",
            "int8_modules_bit_equal", "int4_modules_bit_equal")
    return {k: ({kk: vv for kk, vv in v.items() if kk in keys} if isinstance(v, dict) else v) for k, v in phase.items()}


def _ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``'s report: registers,
    shared memory, spills (names demangled when ``c++filt`` is there)."""

    rows, name = [], None
    for line in report.splitlines():
        if "Performance" in line:  # e.g. wgmma serialized
            rows.append((re.sub(r".*'(\w+)'.*", r"\1", line) if "'" in line else "-", line.strip()[:300]))
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spill = m.group(1), ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers(.*)", line)):
            rows.append((name, f"{m.group(1)} registers{m.group(2)}; {spill}"))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in rows), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [n for n, _ in rows]
    return [f"{n[:160]}: {info}" for n, (_, info) in zip(names, rows)]


def _host_packages() -> dict:
    """Whether each host package of ``HOST_PACKAGES`` is importable here, and
    whether the port's JPEG loader builds (g++ with libjpeg)."""
    import importlib.util

    from lmms_owc_tpu_torch.native import native_loader_available

    found = {name: importlib.util.find_spec(name) is not None for name in HOST_PACKAGES}
    return dict(found, libjpeg=native_loader_available())


def _module_outputs(model, cap, n: int) -> list:
    """One captured decode step (no row blocks) on the first ``n`` rows of its
    inputs: the outputs of the decoder's leaf modules (norms, products), of
    its attention calls and the logits, in call order."""
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    seen: list = []
    hooks = [mod.register_forward_hook(lambda m, a, out, _name=name: seen.append((_name, out.clone())))
             for name, mod in model.model.named_modules()
             if name and not name.startswith("vision") and not list(mod.children())]
    real = nnq.gqa_decode_attention

    def attention(*args, **kw):
        out = real(*args, **kw)
        seen.append(("attention", out.clone()))
        return out

    try:
        with _route(nnq, "gqa_decode_attention", attention):
            logits = nnq.decode_step(
                model.model, cap["token_ids"][:n], cap["position_ids"][:, :n],
                tuple(c[:, :n].clone() for c in cap["cache"]), cap["cache_pos"], cap["kv_mask"][:n].clone())
    finally:
        for h in hooks:
            h.remove()
    return seen + [("logits", logits)]


def _repeat_pool_runs(model, repeats: int = 3) -> dict:
    """Phase 3b's requests at batch ``POOL_CHECK_BATCH``, decoded ``repeats``
    times each unpooled and at pool 2, without row blocks and with
    ``DECODE_ROWS``: per form, whether every repeat gave the first one's
    tokens, and the rows where the first pooled and unpooled runs differ."""
    from lmms_owc_tpu_torch.models.qwen2_vl import DECODE_ROWS

    requests = _requests(model)
    saved = model.batch_size, model.decode_rows
    model.batch_size = POOL_CHECK_BATCH
    out: dict = {}
    try:
        for rows in (None, DECODE_ROWS):
            model.decode_rows = rows
            runs: dict = {}
            with _env(LMMS_OWC_SORT_BY_VISION="0", LMMS_OWC_KV_INT8=""):
                for _ in range(repeats):
                    for pool in ("1", "2"):
                        with _env(LMMS_OWC_DECODE_POOL=pool):
                            tokens: list = []
                            _serve(model, requests, tokens, require_text=False)
                            runs.setdefault(pool, []).append(np.concatenate(tokens))
            same = (runs["1"][0] == runs["2"][0]).all(axis=1)
            out[str(rows)] = dict(
                repeats_identical={pool: all((r == runs[pool][0]).all() for r in runs[pool]) for pool in runs},
                pooled_vs_unpooled_differing=np.nonzero(~same)[0].tolist())
    finally:
        model.batch_size, model.decode_rows = saved
    return out


def _pool_steps(model, keep_at: int | None = None) -> dict:
    """Phase 3b's requests without row blocks, unpooled and at pool 2: the
    logits of every decode step, and with ``keep_at`` a copy of that step's
    inputs, per run."""
    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq

    requests = _requests(model)
    saved = model.batch_size, model.decode_rows
    model.batch_size, model.decode_rows = POOL_CHECK_BATCH, None
    steps: dict = {}
    real = nnq.decode_step
    try:
        for pool in ("1", "2"):
            calls = steps[pool] = {"logits": []}

            def spy(m, token_ids, position_ids, cache, cache_pos, kv_mask, *rest, _calls=calls):
                if len(_calls["logits"]) == keep_at:
                    _calls["inputs"] = dict(token_ids=token_ids.clone(), position_ids=position_ids.clone(),
                                            kv_mask=kv_mask.clone(), cache=tuple(c.clone() for c in cache),
                                            cache_pos=cache_pos)
                out = real(m, token_ids, position_ids, cache, cache_pos, kv_mask, *rest)
                _calls["logits"].append(out.clone())
                return out

            with _env(LMMS_OWC_SORT_BY_VISION="0", LMMS_OWC_KV_INT8="", LMMS_OWC_DECODE_POOL=pool), \
                    _route(nnq, "decode_step", spy):
                model.generate_until(requests)
    finally:
        model.batch_size, model.decode_rows = saved
    return steps


def _pool_divergence(model) -> dict:
    """Where pooled decoding (8 rows) parts from unpooled (two chunks of 4)
    without row blocks: per chunk, the first decode step whose logits differ
    on its rows; at the first chunk's such step, whether that step's inputs
    were equal on its rows and which calls (:func:`_module_outputs`) part."""
    import torch

    steps = _pool_steps(model)
    unpooled, pooled = steps["1"]["logits"], steps["2"]["logits"]
    n_steps = len(pooled)
    first = {}
    for chunk in (0, 1):
        rows = slice(chunk * POOL_CHECK_BATCH, (chunk + 1) * POOL_CHECK_BATCH)
        first[chunk] = next((i for i in range(n_steps)
                             if not torch.equal(unpooled[chunk * n_steps + i], pooled[i][rows])), None)
    out = dict(steps=n_steps, first_parting_step={"chunk 0": first[0], "chunk 1": first[1]})
    if first[0] is not None:
        caps = _pool_steps(model, keep_at=first[0])
        a, b = caps["1"]["inputs"], caps["2"]["inputs"]
        n = POOL_CHECK_BATCH
        out["inputs_equal"] = dict(
            token_ids=bool(torch.equal(a["token_ids"], b["token_ids"][:n])),
            position_ids=bool(torch.equal(a["position_ids"], b["position_ids"][:, :n])),
            kv_mask=bool(torch.equal(a["kv_mask"], b["kv_mask"][:n])),
            cache=[bool(torch.equal(x, y[:, :n])) for x, y in zip(a["cache"], b["cache"])])
        out["parting_calls"] = [name for (name, x), (_, y) in zip(_module_outputs(model, a, n),
                                                                   _module_outputs(model, b, 2 * n))
                                if not torch.equal(x, y[:n])][:8]
    return out


def flash_probe_shapes() -> dict:
    """K2's Hopper rows for :func:`probe_flash_warpgroups`: label -> ((B, H,
    KVH, L, D), prompt lengths or None). With lengths the row is causal and
    left-padded to them in its bucket (the decoders' prefill); without, it is
    non-causal with no mask (the towers). The head_dim-64 towers (the LLaVA
    and Phi-3 towers, InternViT-300M), the short prompts (the judge, Mistral,
    Vicuna at bucket 128), the SigLIP and BLIP towers at D = 72 and 88, the
    K1 tower shape at D = 80, and the longer prefills (Qwen2-7B at 320 and at
    onevision's 4096, Qwen2-1.5B at 2048, Vicuna at 640 and 3072, Phi-3 at
    3072)."""
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    phi3 = phi3v_prompt_tokens()
    internvl = [INTERNVL_PROMPT_TOKENS[(448, 448)]] * 6 + [INTERNVL_PROMPT_TOKENS[(336, 448)]] * 2
    return {
        "llava_tower": ((8, 16, 16, 577, 64), None),
        "phi3_tower": ((17, 16, 16, 577, 64), None),
        "internvit_tower": ((20, 16, 16, 1025, 64), None),
        "judge_prefill": ((JUDGE_BATCH, 24, 8, 128, 128), [128 - (7 * i) % 40 for i in range(JUDGE_BATCH)]),
        "mistral_prefill": ((4, 32, 8, 128, 128), [IDEFICS2_PROMPT_TOKENS] * 4),
        "blip_prefill": ((8, 32, 32, 128, 128), [BLIP_PROMPT_TOKENS] * 8),
        "onevision_tower": ((5, 16, 16, 729, 72), None),
        "blip_tower": ((8, 16, 16, 257, 88), None),
        "vision_d80": ((8, 16, 16, 1024, 80), None),
        "prefill": ((8, 28, 4, 320, 128), [320 - x for x in (0, 3, 17, 40, 64, 100, 191, 250)]),
        "tp_prefill": ((8, 14, 2, 320, 128), [320 - x for x in (0, 3, 17, 40, 64, 100, 191, 250)]),
        "llava_prefill": ((8, 32, 32, 640, 128), [LLAVA_PROMPT_TOKENS] * 8),
        "internvl_prefill": ((8, 12, 2, 2048, 128), internvl),
        "llava_next_prefill": ((2, 32, 32, 3072, 128), list(LLAVA_NEXT_PROMPT_TOKENS)),
        "onevision_prefill": ((2, 28, 4, 4096, 128), list(ONEVISION_PROMPT_TOKENS.values())),
        "phi3_prefill": ((8, 32, 32, pad_to_bucket(max(phi3)), 96), phi3),
    }


def probe_flash_warpgroups(dev, forms: tuple[int, ...] = (0, 1, 2, 3)) -> dict:
    """The flash kernel's Hopper instance at its own plan (form 0) and at 1, 2
    and 3 warpgroups per CTA (the launch's ``warpgroups`` override) at
    :func:`flash_probe_shapes` in bf16: each form held to the plain version
    within ``TOL`` (on the rows that have a valid key), then its device ms
    (profiler, mean of 20) read in the order of ``forms`` and back, averaged
    per form, beside SDPA's, with the plan :func:`_flash_plan` gives. A
    diagnostic of ``sm90::warpgroups``; the smoke run does not call it.
    ``--flash-wg-probe=0`` times the plan alone, so the same file copied into
    an older checkout times that checkout's kernel."""
    import torch

    from lmms_owc_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, ((b, h, kvh, l, d), lengths) in flash_probe_shapes().items():
        q = torch.randn((b, h, l, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, kvh, l, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        causal, mask, rows, keep = False, None, None, None
        if lengths is not None:
            pos = torch.arange(l, device=dev)
            mask = (pos[None, :] >= l - torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
            causal, rows, keep = True, mask.bool()[:, None, :].expand(b, h, l), _causal_keep(mask, l)
        want = att.flash_attention_plain(q, k, v, causal=causal, kv_mask=mask)
        result = torch.empty_like(q)

        def run(wg):
            att._launch_flash("flash_attention", q, k, v, result, causal=causal, kv_mask=mask,
                              kv_mask_contiguous=True, scale=d ** -0.5, rope_cos=None, rope_sin=None, warpgroups=wg)
            return result

        row: dict = {"shape": [b, h, kvh, l, d], "causal": causal, "plan": _flash_plan(h, kvh, l, d),
                     "max_abs_err": {}, "device_ms": {wg: [] for wg in forms}}
        for wg in forms:
            row["max_abs_err"][wg] = _compare(f"flash_attention {label} warpgroups={wg}", run(wg), want, rows)
        for wg in forms + forms[::-1]:
            symbols: list[str] = []
            row["device_ms"][wg].append(_device_ms(lambda: run(wg), symbols=symbols))
            if _flash_instances(symbols) != {"sm90"}:
                raise AssertionError(f"{label} warpgroups={wg}: ran {symbols}")
        row["device_ms"] = {wg: sum(t) / len(t) for wg, t in row["device_ms"].items()}
        row["kernels_ms"] = _device_kernels_ms(lambda: run(forms[0]))
        row["sdpa_device_ms"] = _device_ms(_sdpa(q, k, v, keep))
        out[label] = row
        log(f"flash probe {label}: {json.dumps(row)}")
        del q, k, v, want, result
        torch.cuda.empty_cache()
    return out


def decode_probe_shapes() -> dict:
    """K3's main-path decode shapes (2 layers each) for
    :func:`probe_decode_splits`: label -> ((L, B, H, KVH, D, prompt bucket,
    S), prompt lengths, cache forms). Phase 3's and phase 5's caches at 384
    positions, the judge's at 160, and the caches past 2048 positions of
    phases 17, 18, 21 and 24 and of the longest bucket (8192 + 512)."""
    from lmms_owc_tpu_torch.utils import pad_to_bucket

    starts = [0, 3, 17, 40, 64, 100, 191, 250]
    phi3 = phi3v_prompt_tokens()
    phi3_bucket = pad_to_bucket(max(phi3))
    return {
        "qwen2_vl_384": ((2, 8, 28, 4, 128, 320, 384), [320 - x for x in starts], ("bf16",)),
        "qwen2_vl_384_pool": ((2, POOL_BATCH * 2, 28, 4, 128, 320, 384),
                              [320 - i % 64 for i in range(POOL_BATCH * 2)], ("int8",)),
        "judge_160": ((2, JUDGE_POOL * JUDGE_BATCH, 24, 8, 128, 128, 160),
                      [128 - (7 * i) % 40 for i in range(JUDGE_POOL * JUDGE_BATCH)], ("bf16",)),
        "llava_next_3136": ((2, 2, 32, 32, 128, 3072, 3136), list(LLAVA_NEXT_PROMPT_TOKENS), ("bf16", "int8")),
        "internvl_2112": ((2, 8, 12, 2, 128, 2048, 2112),
                          [INTERNVL_PROMPT_TOKENS[(448, 448)]] * 6 + [INTERNVL_PROMPT_TOKENS[(336, 448)]] * 2,
                          ("bf16", "int8")),
        "onevision_4160": ((2, 8, 28, 4, 128, 4096, 4160),
                           [ONEVISION_PROMPT_TOKENS[(448, 448)]] * 6 + [ONEVISION_PROMPT_TOKENS[(336, 448)]] * 2,
                           ("bf16", "int8")),
        "phi3_3136": ((2, 8, 32, 32, 96, phi3_bucket, phi3_bucket + MAX_NEW_TOKENS), phi3, ("bf16", "int8")),
        "long_8704": ((2, 8, 28, 4, 128, LONG_CACHE - 305, LONG_CACHE), [LONG_CACHE - 305 - x for x in starts],
                      ("bf16", "int8")),
    }


def probe_decode_graphs(dev, rows: int = 96, prompt: int = 128) -> dict:
    """The decode step of the 28-layer 7B decoder (W8A8 with the int8 cache,
    and bf16), ``rows`` rows after a ``prompt``-position prefill, row blocks
    of 128 (the adapter's):

    - ``steps``: 24 steps, each issued onto an idle device (synchronized
      before) and synchronized after: the median and first three of the
      host's issue ms (the ``decode_step`` call) and the step's wall ms,
      called directly, and inside a decode pool's graphs where the checkout
      has them (``_pool_graphs``), alone and beside a thread that runs
      Python meanwhile (as the adapters' prep worker does);
    - ``pools``: the wall ms of whole ``decode_pool`` calls (median of 5,
      after one untimed) whose rows all stop after ``n`` decode steps, by
      EOS within a budget of 63 steps (``eos``) and by a budget of ``n``
      steps (``budget``);
    - the device memory reserved after all of it.

    A diagnostic; the smoke run does not call it."""
    import threading

    import torch

    from lmms_owc_tpu_torch.models.qwen2_vl import PRESET_CONFIGS
    from lmms_owc_tpu_torch.nn import layers as tl
    from lmms_owc_tpu_torch.nn import qwen2_vl as tq
    from lmms_owc_tpu_torch.ops.quant import quantize_params_int8

    def busy(stop):
        while not stop.is_set():
            sum(i * i for i in range(20000))

    graphs = getattr(tq, "_pool_graphs", None)
    out = {}
    for case in ("w8a8", "bf16"):
        w8a8 = case == "w8a8"
        config = tq.Qwen2VLConfig.from_hf_dict(PRESET_CONFIGS["qwen2-vl-7b"])
        model = tq.Qwen2VLModel(config, torch.bfloat16, dev, text_only=True)
        tq.init_params(model, torch.Generator(dev).manual_seed(0))
        if w8a8:
            quantize_params_int8(model)
        tl.set_int8_activations(w8a8)
        g = torch.Generator(dev).manual_seed(1)
        pads = torch.randint(0, prompt // 2, (rows,), generator=g, device=dev)
        mask = (torch.arange(prompt, device=dev)[None] >= pads[:, None]).to(torch.int32)
        embeds = (torch.randn(rows, prompt, config.hidden_size, generator=g, device=dev) * 0.5).to(model.dtype)
        positions = (torch.cumsum(mask, 1) - 1).clamp(min=0)[None].expand(3, rows, prompt).contiguous()
        new = 64
        logits0, cache0 = tq.prefill(model, embeds, positions, mask, prompt + new)
        if w8a8:
            cache0 = tq.quantize_kv_cache(*cache0)
        mask0 = torch.zeros(rows, prompt + new, dtype=torch.int32, device=dev)
        mask0[:, :prompt] = mask
        next_positions = mask.sum(1).long()

        def fresh():
            return tuple(t.clone() for t in cache0), mask0.clone()

        row: dict = {"steps": {}, "pools": {}}
        forms = ["direct"] + (["graphs", "graphs-beside-python"] if graphs else [])
        for form in forms:
            cache, kv_mask = fresh()
            token = logits0.argmax(-1)
            issue, wall = [], []
            stop = threading.Event()
            thread = threading.Thread(target=busy, args=(stop,)) if form.endswith("python") else None
            context = graphs(model, dev) if form.startswith("graphs") else nullcontext()
            if thread:
                thread.start()
            try:
                with context:
                    for s in range(24):
                        pos = (next_positions + s)[None, :, None].expand(3, rows, 1)
                        kv_mask[:, prompt + s] = 1
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        logits = tq.decode_step(model, token, pos, cache, prompt + s, kv_mask, 128)
                        t1 = time.perf_counter()
                        token = logits.argmax(-1)
                        torch.cuda.synchronize()
                        issue.append((t1 - t0) * 1e3)
                        wall.append((time.perf_counter() - t0) * 1e3)
            finally:
                stop.set()
                if thread:
                    thread.join(timeout=60)
            row["steps"][form] = {"issue_ms_median": round(statistics.median(issue), 3),
                                  "step_ms_median": round(statistics.median(wall), 3),
                                  "first_three_issue_ms": [round(t, 2) for t in issue[:3]],
                                  "first_three_step_ms": [round(t, 2) for t in wall[:3]]}
            log(f"decode graph probe {case} {form}: {json.dumps(row['steps'][form])}")

        eos = config.eos_token_id
        eos_ids = torch.tensor([eos], device=dev)
        real_sample = tq._sample_token
        for n in (1, 2, 3, 4, 5, 6, 8, 16):
            for stop_by in ("eos", "budget"):
                times = []
                for _ in range(6):
                    cache, kv_mask = fresh()
                    calls = [0]

                    def sample(*a, calls=calls, n=n, stop_by=stop_by):
                        calls[0] += 1
                        token = real_sample(*a)
                        return torch.full_like(token, eos) if stop_by == "eos" and calls[0] > n else token

                    tq._sample_token = sample
                    try:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        tq.decode_pool(model, cache, logits0, kv_mask, next_positions,
                                       new if stop_by == "eos" else n + 1, prompt, eos_ids, decode_rows=128)
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                    finally:
                        tq._sample_token = real_sample
                    if calls[0] != n + 1:
                        raise AssertionError(f"decode graph probe: a pool of {n} steps sampled {calls[0]} times")
                row["pools"][f"{n} {stop_by}"] = round(statistics.median(times[1:]), 3)
        log(f"decode graph probe {case} pools (ms by steps and stop): {json.dumps(row['pools'])}")
        torch.cuda.synchronize()
        row["memory_reserved_gb"] = round(torch.cuda.memory_reserved() / 1e9, 3)
        out[case] = row
        tl.set_int8_activations(False)
        del model, cache0, logits0, cache, kv_mask
        _free()
    return out


def probe_decode_splits(dev, splits=(8, 16)) -> dict:
    """K3 at :func:`decode_probe_shapes` under the split plans of at most
    ``splits`` CTAs a cluster (8, the plan's own, through the public
    wrapper; 16, a non-portable cluster, through ``_launch_decode``): each
    plan held to the plain version (``LONG_CACHE_TOL`` past 2048 positions,
    else ``TOL``), then its device ms (profiler, mean of 20) read in the order
    8, 16, 16, 8 and averaged per plan, beside SDPA's (bf16) and the bound,
    with the kernel symbols the profiler saw. A diagnostic of the plan; the
    smoke run does not call it. With ``splits=(8,)`` it uses only the public
    wrappers, so an older checkout's package can be timed by the same code."""
    import torch

    from lmms_owc_tpu_torch.nn.qwen2_vl import quantize_kv_cache
    from lmms_owc_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, ((layers, b, nh, kvh, hd, prompt, s), lengths, forms) in decode_probe_shapes().items():
        spos = torch.arange(s, device=dev)
        dstarts = prompt - torch.tensor(lengths, device=dev)
        mask = ((spos[None, :] >= dstarts[:, None]) & (spos[None, :] < prompt + 5)).to(torch.int32)
        valid = int(mask.sum())
        q, ck, cv = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                     for shape in ((b, nh, hd), (layers, b, kvh, s, hd), (layers, b, kvh, s, hd)))
        for form in forms:
            cache = quantize_kv_cache(ck, cv) if form == "int8" else (ck, cv)
            plans = {n: att.decode_split_plan(s, n) if n != 8 else att.decode_split_plan(s) for n in splits}
            runs = {}
            for n in splits:
                if n == 8:
                    runs[n] = lambda: att.gqa_decode_attention(q, cache[0], cache[1], 1, mask, *cache[2:])
                elif plans[n] != plans[8]:
                    runs[n] = (lambda n=n: att._launch_decode(q, cache[0], cache[1], 1, mask, *(cache[2:] or (None, None)),
                                                              1.0 / hd ** 0.5, splits=n))
            want = att.gqa_decode_attention_plain(q, cache[0], cache[1], 1, mask, *cache[2:])
            tol = dict(atol=LONG_CACHE_TOL[form][0], rtol=0.0, rel_l2=LONG_CACHE_TOL[form][1]) if s > 2048 else {}
            row: dict = {"shape": [layers, b, nh, kvh, s, hd], "form": form, "plans": {n: plans[n] for n in runs},
                         "max_abs_err": {}, "device_ms": {n: [] for n in runs}, "symbols": {}}
            for n, run in runs.items():
                row["max_abs_err"][n] = _compare(f"decode {label} {form} splits<={n}", run(), want, **tol)
            for n in list(runs) + list(runs)[::-1]:
                symbols: list[str] = []
                for _ in range(3):  # the profiler can drop a window's events: read the call again
                    ms = _device_ms(runs[n], symbols=symbols)
                    if ms is not None:
                        row["device_ms"][n].append(ms)
                        break
                row["symbols"][n] = sorted(set(symbols))
            row["device_ms"] = {n: sum(t) / len(t) if t else None for n, t in row["device_ms"].items()}
            if form == "int8":
                nbytes = 2 * 2 * b * nh * hd + kvh * valid * (2 * hd + 2 * 4) + 4 * b * s
            else:
                nbytes = 2 * (2 * b * nh * hd + 2 * kvh * hd * valid) + 4 * b * s
                row["sdpa_device_ms"] = _device_ms(_sdpa(q[:, :, None], ck[1], cv[1], mask.bool()[:, None, None, :]))
            row.update(_bound(4.0 * hd * nh * valid, nbytes))
            out[f"{label} {form}"] = row
            log(f"decode split probe {label} {form}: {json.dumps(row)}")
            del cache, want
        del q, ck, cv
        torch.cuda.empty_cache()
    return out


def probe_decode_rows(dev) -> dict:
    """Phase 3's bf16 model and requests served with the adapter's decode row
    blocks (``DECODE_ROWS``) and without them (None), timed alternately
    (blocks, none, none, blocks, blocks, none), then one call of each under
    ``torch.profiler``: its device milliseconds summed over the kernels, the
    number of kernels and the heaviest ones; then, in bf16 and in int4,
    whether repeated pooled and unpooled runs give the same tokens
    (:func:`_repeat_pool_runs`) and where pooled decoding parts from unpooled
    (:func:`_pool_divergence`); last, on how many rows RMSNorm's f32 mean of
    squares parts from its value among 128 rows, at each row count. A
    diagnostic of what the blocks cost and why; the smoke run does not call it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.models.qwen2_vl import DECODE_ROWS

    model, requests, _ = serve_bf16(dev, "qwen2-vl-7b", None, MIN_LAUNCHES, "bf16, unpooled")
    out: dict = {"decode_rows": DECODE_ROWS, "timed": [], "profiled": {}}
    try:
        for rows in (DECODE_ROWS, None, None, DECODE_ROWS, DECODE_ROWS, None):
            model.decode_rows = rows
            run = _serve(model, requests)
            out["timed"].append(dict(decode_rows=rows, seconds=run["seconds"], phase_seconds=run["phase_seconds"],
                                     decode_steps=run["decode_steps"]))
        for rows in (DECODE_ROWS, None):
            model.decode_rows = rows
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.generate_until(requests)
                torch.cuda.synchronize()
            kernels = sorted(
                ((e.key, e.count, getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
                 for e in prof.key_averages()), key=lambda k: -k[2])
            kernels = [k for k in kernels if k[2] > 0]
            out["profiled"][str(rows)] = dict(
                device_ms=sum(k[2] for k in kernels) / 1000, kernels=sum(k[1] for k in kernels),
                top=[dict(name=name[:90], calls=n, ms=us / 1000) for name, n, us in kernels[:8]])
        out["repeats"] = {"bf16": _repeat_pool_runs(model)}
        out["divergence"] = {"bf16": _pool_divergence(model)}
    finally:
        model.decode_rows = DECODE_ROWS
    del model
    _free()
    with _env(LMMS_OWC_DECODE_POOL="1", LMMS_OWC_KV_INT8=""):
        q4 = get_model("qwen2-vl-7b", random_init=True, dtype="bfloat16", batch_size=NUM_REQUESTS, device=str(dev),
                       load_in_4bit=True)
        out["repeats"]["int4"] = _repeat_pool_runs(q4)
        out["divergence"]["int4"] = _pool_divergence(q4)
    del q4
    _free()
    # Whether RMSNorm's f32 mean of squares gives a row the bits it has among
    # 128 rows, at each row count (the bf16 cast after it hides most parting).
    x = torch.randn(128, 1, 3584, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    sq = x.to(torch.bfloat16).float().square()
    full = sq.mean(dim=-1)
    out["rms_mean_rows_parting"] = {b: int((sq[:b].mean(dim=-1) != full[:b]).sum())
                                    for b in (1, 2, 4, 8, 12, 15, 16, 17, 32, 64, 96)}
    return out


# ------------------------------------------------------------ phase 25: tensor parallelism


def check_tp_shapes(dev, gen) -> dict[str, dict]:
    """Phase 2 at phase 25's sharded shapes (``qwen2-vl-7b`` at tp = 2): K2's
    Hopper instance at 14/2 heads over phase 3's prefill, K3 at q [8, 14, 128]
    against cache [28, 8, 2, 384, 128], K1 at 8 tower heads of 80, and K4 on
    each rank's products at M = 8 (q/o 3584 -> 1792 and 1792 -> 3584, k/v
    3584 -> 256, gate/up 3584 -> 9472, down 9472 -> 3584, the head 3584 ->
    76032). Returns ``{kernel: {label: row}}``; the K4 rows go under ``all``."""
    import torch

    from lmms_owc_tpu_torch.nn.layers import apply_rope
    from lmms_owc_tpu_torch.nn.qwen2_vl import Qwen2VLVisionConfig, vision_rope_cos_sin
    from lmms_owc_tpu_torch.ops import attention as att
    from lmms_owc_tpu_torch.ops import int4_matmul as i4
    from lmms_owc_tpu_torch.ops.quant import quantize_int4

    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    rows: dict[str, dict] = {"flash_attention": {}, "gqa_decode_attention": {}, "vision_qkv_attention": {},
                             "int4_matmul": {}}
    n, p, h, d = 8, 1024, 16 // TP_RANKS, 80
    qkv = randn(n, p, 3 * h * d)
    freqs = torch.from_numpy(vision_rope_cos_sin([(1, 32, 32)], Qwen2VLVisionConfig())).to(dev)
    cos, sin = torch.cos(freqs)[None].expand(n, p, d // 2), torch.sin(freqs)[None].expand(n, p, d // 2)
    vmask = torch.ones((n, p), dtype=torch.int32, device=dev)
    vmask[n // 2 :, 768:] = 0
    kw = dict(kv_mask=vmask, rope_cos=cos, rope_sin=sin)
    err = _compare("vision_qkv_attention[tp]", att.vision_qkv_attention(qkv, h, d, **kw),
                   att.vision_qkv_attention_plain(qkv, h, d, **kw))
    vq, vk, vv = qkv.view(n, p, 3, h, d).permute(2, 0, 3, 1, 4)
    rows["vision_qkv_attention"]["tp_tower"] = _row(
        f"qkv [{n}, {p}, {3 * h * d}] bf16 ({h} heads a rank at tp = {TP_RANKS}), rope, mask (0, 768) on "
        f"{n // 2} rows", err,
        _timings(lambda: att.vision_qkv_attention(qkv, h, d, **kw),
                 lambda: att.vision_qkv_attention_plain(qkv, h, d, **kw),
                 _sdpa(apply_rope(vq, cos, sin), apply_rope(vk, cos, sin), vv, vmask.bool()[:, None, None, :])),
        _attention_bound(vmask, h, h, p, d, causal=False, extra_bytes=2 * 4 * n * p * d // 2 + 8 * n), SDPA,
        plan=(h, h, p, d),
    )
    del qkv

    b, nh, kvh, l, hd = 8, 28 // TP_RANKS, 4 // TP_RANKS, 320, 128
    q, k, v = randn(b, nh, l, hd), randn(b, kvh, l, hd), randn(b, kvh, l, hd)
    starts = torch.tensor([0, 3, 17, 40, 64, 100, 191, 250], device=dev)
    pos = torch.arange(l, device=dev)
    pmask = (pos[None, :] >= starts[:, None]).to(torch.int32)
    kw = dict(causal=True, kv_mask=pmask)
    valid_rows = (pos[None, :] >= starts[:, None])[:, None, :].expand(b, nh, l)
    got = att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw)
    err = _compare("flash_attention[tp]", got, att.flash_attention_plain(q, k, v, **kw), valid_rows)
    _per_head_equal("tp prefill", q, k, v, got, **kw)
    rows["flash_attention"]["tp_prefill"] = _row(
        f"q [{b}, {nh}, {l}, {hd}], k/v [{b}, {kvh}, {l}, {hd}] bf16 (tp = {TP_RANKS}: G = {nh // kvh}), causal, "
        "left-padded (equal to per-head launches)", err,
        _timings(lambda: att.flash_attention(q, k, v, kv_mask_contiguous=True, **kw),
                 lambda: att.flash_attention_plain(q, k, v, **kw), _sdpa(q, k, v, _causal_keep(pmask, l))),
        _attention_bound(pmask, nh, kvh, l, hd, causal=True, extra_bytes=8 * b), SDPA, plan=(nh, kvh, l, hd),
    )
    del q, k, v

    layers, s = 28, 384
    qd = randn(b, nh, hd)
    ck, cv = randn(layers, b, kvh, s, hd), randn(layers, b, kvh, s, hd)
    spos = torch.arange(s, device=dev)
    dmask = ((spos[None, :] >= starts[:, None]) & (spos[None, :] < l + 5)).to(torch.int32)
    errs = [_compare(f"gqa_decode_attention[tp, layer {i}]", att.gqa_decode_attention(qd, ck, cv, i, dmask),
                     att.gqa_decode_attention_plain(qd, ck, cv, i, dmask)) for i in (0, layers - 1)]
    rows["gqa_decode_attention"]["tp_decode"] = _row(
        f"q [{b}, {nh}, {hd}], cache [{layers}, {b}, {kvh}, {s}, {hd}] bf16 (tp = {TP_RANKS}), layers 0 and "
        f"{layers - 1}", max(errs),
        _timings(lambda: att.gqa_decode_attention(qd, ck, cv, layers - 1, dmask),
                 lambda: att.gqa_decode_attention_plain(qd, ck, cv, layers - 1, dmask),
                 _sdpa(qd[:, :, None], ck[layers - 1], cv[layers - 1], dmask.bool()[:, None, None, :])),
        _attention_bound(dmask, nh, kvh, 1, hd, causal=False, extra_bytes=4 * b * s), SDPA,
    )
    del ck, cv

    m = min(INT4_ROWS)
    for name, (kk, nn) in TP_INT4_SHAPES.items():
        qp = quantize_int4(torch.randn((nn, kk), generator=gen, device=dev) * 0.02)
        q4, scale = qp["q4"], qp["scale"]
        library, described = _int4_library(qp)
        del qp
        x = torch.randn((m, kk), generator=gen, device=dev).to(bf16)
        err = _compare(f"int4_matmul[tp {name}]", i4.int4_matmul(x, q4, scale), i4.int4_matmul_plain(x, q4, scale))
        t = _timings(lambda: i4.int4_matmul(x, q4, scale), lambda: i4.int4_matmul_plain(x, q4, scale),
                     (lambda: library(x)) if library is not None else None)
        bound = _bound(2.0 * m * nn * kk, 2 * m * kk + nn * kk // 2 + 4 * nn * (kk // 128) + 2 * m * nn)
        rows["int4_matmul"][f"tp {name} M={m}"] = _row(
            f"x [{m}, {kk}] bf16, q4 [{nn}, {kk // 2}] int8, scale [{nn}, {kk // 128}] (a rank's {name} at "
            f"tp = {TP_RANKS})", err, t, bound, described)
        del q4, scale, library
        torch.cuda.empty_cache()
    return rows


def tp_reference(model, requests, exact: bool = False) -> dict:
    """Phase 25's bar from an unsharded model with phase 3's seed: one chunk's
    prefill logits through the kernels (with ``exact``, also with the
    attention in f32, phase 4's "exact") and the tokens of ``requests``, on the host."""
    import torch

    out = dict(logits=_chunk_logits(model, requests).cpu())
    if exact:
        with _attention(flash_attention=_exact_flash, vision_qkv_attention=_exact_vision,
                        fused_qkv_attention=_exact_fused):
            out["exact"] = _chunk_logits(model, requests).cpu()
    tokens: list = []
    with _tokens(model, tokens):
        model.generate_until(requests)
    torch.cuda.synchronize()
    return dict(out, tokens=np.concatenate(tokens))


def _allreduce_share(model, capture) -> dict:
    """One captured decode step as the adapter runs it (its decode row
    blocks): its time (median, CUDA events) and the time its model-group
    all-reduces take, each timed between two synchronizes."""
    import torch

    from lmms_owc_tpu_torch.nn import qwen2_vl as nnq
    from lmms_owc_tpu_torch.parallel.mesh import ModelGroup

    def step():
        cache = tuple(c.clone() for c in capture["cache"])
        return nnq.decode_step(model.model, capture["token_ids"], capture["position_ids"], cache,
                               capture["cache_pos"], capture["kv_mask"].clone(), model.decode_rows)

    step_ms = _median_ms(step, warmup=2, iters=10)
    real, spent, calls = ModelGroup.all_reduce, [0.0], [0]

    def timed(self, t, op="sum"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, t, op)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        calls[0] += 1
        return out

    ModelGroup.all_reduce = timed
    try:
        for _ in range(5):
            step()
    finally:
        ModelGroup.all_reduce = real
    allreduce_ms = spent[0] * 1e3 / 5
    return dict(step_ms=step_ms, allreduce_ms=allreduce_ms, allreduces=calls[0] // 5,
                share=allreduce_ms / step_ms)


def tp_rank(rank: int, port: int, work: str) -> None:
    """One of phase 25's two processes on ``cuda:0``: a gloo group of
    ``TP_RANKS``, then (a) ``qwen2-vl-7b`` at tp = 2 in bf16 and in int8 +
    W8A8 + the int8 KV cache, (c) in int4, (b) the flagship dry-run preset,
    (d) the judge with ``data_parallel``. Rank 0 writes what it measured."""
    import datetime

    import torch

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", rank=rank, world_size=TP_RANKS,
                                         timeout=datetime.timedelta(seconds=600))
    from lmms_owc_tpu_torch import get_device, no_tf32
    from lmms_owc_tpu_torch.models import get_model
    from lmms_owc_tpu_torch.nn.judge import JudgeModel
    from lmms_owc_tpu_torch.nn.layers import set_int8_activations
    from lmms_owc_tpu_torch.ops import _build
    from lmms_owc_tpu_torch.parallel.dryrun import flagship_outputs

    no_tf32()
    _build.load_library()
    dev = get_device("cuda")
    say = log if rank == 0 else (lambda msg: None)
    out: dict = {"forms": {}}
    logits: dict = {}
    for label, kwargs, env in TP_FORMS:
        with _env(**env):
            t0 = time.perf_counter()
            model = get_model("qwen2-vl-7b", random_init=True, dtype="bfloat16", batch_size=NUM_REQUESTS,
                              device=str(dev), time_phases=True, model_parallel=TP_RANKS, **kwargs)
            torch.cuda.synchronize()
            init_seconds = time.perf_counter() - t0
            layer, block = model.model.layers[0], model.model.vision.blocks[0]
            shards = dict(heads=layer.heads, kv_heads=layer.kv_heads, tower_heads=model.model.vision.heads,
                          vocab_rows=int(model.model.embed_tokens.shape[0]), up_rows=_out_rows(layer.up),
                          down_cols=_out_rows(layer.down.inner, 1), tower_qkv_rows=_out_rows(block.qkv))
            if shards["up_rows"] * TP_RANKS != 18944 or shards["heads"] * TP_RANKS != 28:
                raise AssertionError(f"phase 25 {label}: rank {rank} holds {shards}, not half of the 7B")
            capture: dict = {}
            with _decode_steps(capture):  # a short warm-up at the measured shapes; keeps one decode step's inputs
                model.generate_until(_requests(model, max_new_tokens=TP_WARMUP_TOKENS))
            requests = _requests(model)
            tokens: list = []
            run = _serve(model, requests, tokens)
            run.update(init_seconds=init_seconds, shards=shards, tokens=np.concatenate(tokens).tolist())
            logits[label] = _chunk_logits(model, requests).cpu()
            if label == "bf16":
                run["decode_step"] = _allreduce_share(model, capture)
            say(f"tp = {TP_RANKS} {label}: {json.dumps({k: v for k, v in run.items() if k != 'tokens'})}")
            out["forms"][label] = run
            set_int8_activations(False)
            del model, capture
            _free()
    with _env(LMMS_OWC_DECODE_POOL="1", LMMS_OWC_KV_INT8=""):
        out["flagship"] = flagship_outputs(TP_RANKS, str(dev), MAX_NEW_TOKENS)
    with _env(LMMS_OWC_KV_INT8="0", LMMS_OWC_JUDGE_DECODE_POOL="0"):
        judge = JudgeModel.random_init(seed=0, device=dev, data_parallel=True)
        judge.batch_size = JUDGE_BATCH
        t0 = time.perf_counter()
        answers = judge.score_pairs(judge_prompts(JUDGE_PROMPTS), None, None)
        torch.cuda.synchronize()
        out["judge"] = dict(answers=answers, seconds=time.perf_counter() - t0, ranks=judge.ranks)
        del judge
        _free()
    torch.distributed.barrier()
    if rank == 0:
        torch.save(logits, Path(work) / "logits.pt")
        (Path(work) / "rank0.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def _out_rows(lin, axis: int = 0) -> int:
    """A linear module's output rows (``axis`` 1: input columns; int4 counts packed bytes)."""
    for name in ("weight", "q", "q4"):
        if hasattr(lin, name):
            return int(getattr(lin, name).shape[axis])
    raise TypeError(type(lin).__name__)


def _token_agreement(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float((got == want).mean())


def run_tensor_parallel(dev, refs: dict, judge_answers: list[str], plain_vs_exact: float) -> dict:
    """Phase 25: ``TP_RANKS`` processes on the one card (:func:`tp_rank`) over
    gloo. (a) bf16: prefill logits held by phase 4's rule against phase 3's
    f32-attention logits (``refs["bf16"]``); int8 + W8A8 and (c) int4: the
    logits within that rule's bound of the unsharded model's (phases 5 and 6,
    same seed); the share of tokens that agree, images/s, phase times and
    peak memory per rank logged. (b) The flagship dry-run preset: the
    unsharded model's tokens on every row. (d) The judge: phase 13's answers
    on every row."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from lmms_owc_tpu_torch.parallel.dryrun import flagship_outputs

    work = Path(tempfile.mkdtemp(prefix="owc_tp_"))
    procs = []
    try:
        with _env(LMMS_OWC_DECODE_POOL="1", LMMS_OWC_KV_INT8=""):
            flagship = flagship_outputs(1, str(dev), MAX_NEW_TOKENS)
            _free()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=tp_rank, args=(rank, port, str(work))) for rank in range(TP_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, TP_TIMEOUT - (time.perf_counter() - t0)))
        if any(p.is_alive() or p.exitcode != 0 for p in procs):
            raise AssertionError(f"phase 25: rank exit codes {[p.exitcode for p in procs]} "
                                 f"(None: still running after {TP_TIMEOUT} s)")
        out = json.loads((work / "rank0.json").read_text())
        logits = torch.load(work / "logits.pt")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)
    return check_tp_results(out, logits, flagship, refs, judge_answers, plain_vs_exact)


def check_tp_results(out: dict, logits: dict, flagship, refs: dict, judge_answers: list[str],
                     plain_vs_exact: float) -> dict:
    """Phase 25's gates on what rank 0 wrote (:func:`run_tensor_parallel`)."""
    bound = max(LOGITS_REL_L2, 1.25 * plain_vs_exact)
    for label, ref_key in (("bf16", "bf16"), ("int8_w8a8_kv_int8", "int8_w8a8"), ("int4", "int4")):
        run, ref = out["forms"][label], refs[ref_key]
        got = logits[label].float()
        run["logits"] = {
            "tp_vs_unsharded": _rel_l2(got, ref["logits"].float()),
            "argmax_agreement": float((got.argmax(-1) == ref["logits"].argmax(-1)).float().mean()),
            "bound": bound,
        }
        if "exact" in ref:
            run["logits"]["tp_vs_exact"] = _rel_l2(got, ref["exact"].float())
        key = "tp_vs_exact" if "exact" in ref else "tp_vs_unsharded"
        run["token_agreement"] = _token_agreement(run.pop("tokens"), ref["tokens"])
        log(f"phase 25 {label}: tp = {TP_RANKS} logits {json.dumps(run['logits'])}; tokens equal to the "
            f"unsharded model's: {run['token_agreement']:.4f}")
        if run["logits"][key] > bound:
            raise AssertionError(f"phase 25 {label}: tp logits {key} {run['logits'][key]:.3e} > {bound:.3e}")
        # The row-parallel W8A8 product reduces the global amax and the int32
        # partials, so it is the unsharded product: bit-equal logits, every token.
        if "w8a8" in label and (run["logits"]["tp_vs_unsharded"] != 0.0 or run["token_agreement"] != 1.0):
            raise AssertionError(f"phase 25 {label}: tp W8A8 differs from the unsharded model (logits "
                                 f"{run['logits']['tp_vs_unsharded']:.3e}, tokens {run['token_agreement']:.4f})")
        decode = "gqa_decode_attention_int8" if "kv_int8" in label else "gqa_decode_attention"
        least = {"vision_qkv_attention": MIN_LAUNCHES["vision_qkv_attention"],
                 "flash_attention": MIN_LAUNCHES["flash_attention"], decode: 28 * run["decode_steps"]}
        for name, n in least.items():
            if run["decode_steps"] == 0 or run["counts"][name] < n:
                raise AssertionError(f"phase 25 {label}: {name} launched {run['counts'][name]} times, expected >= {n}")
    _check_min_per_step(out["forms"]["int4"], "int4_matmul")
    same = np.asarray([a == b for a, b in zip(out.pop("flagship"), flagship, strict=True)])
    log(f"phase 25(b) {FLAGSHIP_DRYRUN} f32 int8: rows with the unsharded tokens {int(same.sum())} of {same.size}")
    if not same.all():
        raise AssertionError(f"phase 25(b): sharded tokens differ from unsharded ones on rows {np.nonzero(~same)[0]}")
    answers = out["judge"].pop("answers")
    bad = [i for i, (a, b) in enumerate(zip(answers, judge_answers, strict=True)) if a != b]
    out["judge"]["same_rows"] = len(answers) - len(bad)
    log(f"phase 25(d) judge data_parallel over {out['judge']['ranks']} ranks: {out['judge']['same_rows']} of "
        f"{len(answers)} answers equal to one rank's")
    if bad:
        raise AssertionError(f"phase 25(d): data-parallel judge answers differ on rows {bad}")
    out["flagship"] = dict(rows=int(same.size), same_rows=int(same.sum()))
    return out


# The flags that run phases 1 and 2 or a probe alone (see the module docstring).
DIAGNOSTIC_MODES = ("--decode-graph-probe", "--decode-rows-probe", "--decode-split-probe", "--flash-wg-probe",
                    "--kernel-rows")


def main(argv: list[str] | None = None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from lmms_owc_tpu_torch import get_device, no_tf32
    from lmms_owc_tpu_torch.ops import _build

    dev = get_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"host packages: {json.dumps(_host_packages())}")
    no_tf32()
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")
    ptxas = _ptxas_summary(_build.ptxas_report(lib_path))
    for line in ptxas:
        log(f"ptxas: {line}")
    args = sys.argv[1:] if argv is None else argv
    # A serialized wgmma pipeline fails phase 1; the diagnostic modes only
    # print it, so this file can time an older checkout's kernels.
    serialized = [line for line in ptxas if "serialized" in line]
    if serialized and not any(a.startswith(DIAGNOSTIC_MODES) for a in args):
        raise AssertionError(f"phase 1: ptxas serialized the wgmmas of {len(serialized)} kernel(s), e.g. "
                             f"{serialized[0]}")
    if "--decode-graph-probe" in args:
        log(f"decode graph probe ({smi}): {json.dumps(probe_decode_graphs(dev))}")
        print(smi)
        return 0
    if "--decode-rows-probe" in args:
        log(f"decode rows probe: {json.dumps(probe_decode_rows(dev))}")
        print(smi)
        return 0
    probe = [a for a in args if a.startswith("--decode-split-probe")]
    if probe:
        splits = tuple(int(n) for n in probe[0].partition("=")[2].split(",") if n) or (8, 16)
        log(f"decode split probe ({smi}): {json.dumps(probe_decode_splits(dev, splits))}")
        print(smi)
        return 0
    probe = [a for a in args if a.startswith("--flash-wg-probe")]
    if probe:
        forms = tuple(int(n) for n in probe[0].partition("=")[2].split(",") if n) or (0, 1, 2, 3)
        log(f"flash warpgroups probe ({smi}): {json.dumps(probe_flash_warpgroups(dev, forms))}")
        print(smi)
        return 0

    if "--kernel-rows" in args:
        rows = check_kernels(dev)
        flash = {name: {label: [row["device_ms"], row["library_device_ms"], row.get("plan")]
                        for label, row in [(name, rows[name])] + list(rows[name].get("also", {}).items())}
                 for name in FLASH_KERNELS if name in rows}
        log(f"kernel rows ({smi}; device ms, library device ms, plan): {json.dumps(flash)}")
        print(smi)
        return 0

    wall: dict[str, float] = {}  # wall seconds of each step below, for ``summary wall seconds``
    since = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        wall[name], since[0] = round(now - since[0], 3), now

    parity = check_kernels(dev)
    mark("2 kernel parity")
    model, requests, counts = run_main_path(dev)
    mark("3 main path")
    packed = check_packed_tower(model, requests)  # phase 8, on phase 3's bf16 weights
    mark("8 packed tower")
    pool_rows = check_pool_rows(model, "bf16")  # phase 3b
    mark("3b pooled rows")
    # Phases 9-11 on phase 3's bf16 weights, before phase 4 turns them to f32;
    # phase 12 scores toy_semantic with the MiniLM checkpoint of phase 13.
    scoring_root = Path(tempfile.mkdtemp(prefix="owc_scoring_"))
    try:
        sbert_dir = scoring_root / "minilm"
        sbert_dir.mkdir()
        write_sbert_checkpoint(dev, sbert_dir)
        root = Path(tempfile.mkdtemp(prefix="owc_ckpt_"))
        try:
            ckpt, checkpoint = check_checkpoint(dev, model, requests, "qwen2-vl-7b", root, quantized=True)
            mark("9 checkpoint qwen2-vl-7b")
            loglik = check_loglikelihood(ckpt)
            multi = check_multi_round(ckpt)
            reference = cli_reference(ckpt, "qwen2-vl-7b")
            del ckpt
            _free()
            mark("10-11 loglikelihood, multi-round")
            with _env(LMMS_OWC_SBERT_PATH=str(sbert_dir)):
                cli = run_cli(dev, "qwen2-vl-7b", root, reference, out_root=scoring_root / "cli")  # phase 12
                (scoring_root / "bench").mkdir()
                cli[BENCHMARK_TASK] = run_cli_benchmark(dev, "qwen2-vl-7b", root, scoring_root / "bench")
            mark("12 cli")
        finally:
            shutil.rmtree(root, ignore_errors=True)
        scoring = run_scoring(dev, scoring_root / "cli", scoring_root, sbert_dir)  # phase 13
        judge_answers = scoring["judge"].pop("answers")
        mark("13 scoring")
    finally:
        shutil.rmtree(scoring_root, ignore_errors=True)
    tp_refs = {"bf16": tp_reference(model, requests, exact=True)}  # phase 25's bar, before phase 4's f32
    plain_vs_exact = check_whole_model(model, requests)["plain_vs_exact"]
    del model, requests
    _free()
    mark("4 whole model")
    pool = run_quantized_pool(dev)
    tp_refs["int8_w8a8"] = pool.pop("tp_reference")
    mark("5 quantized pool")
    int4 = run_int4(dev)
    tp_refs["int4"] = int4.pop("tp_reference")
    mark("6 int4")
    v25, v25_model, v25_requests = run_v25(dev)
    mark("7 qwen2.5-vl")
    root = Path(tempfile.mkdtemp(prefix="owc_ckpt_"))
    try:
        ckpt, checkpoint25 = check_checkpoint(dev, v25_model, v25_requests, "qwen2.5-vl-7b", root, quantized=False)
        del ckpt, v25_model, v25_requests
        _free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mark("9 checkpoint qwen2.5-vl-7b")
    v25_quantized = run_v25_quantized(dev)  # phase 7b
    mark("7b qwen2.5-vl quantized")

    clip = run_clip(dev)  # phase 14
    mark("14 clip")
    llava = run_llava(dev)  # phase 15
    mark("15 llava-1.5-7b")
    llava["checkpoint"] = run_llava_checkpoint(dev)  # phase 16
    mark("16 llava checkpoint")
    llava["next"] = run_llava_next(dev)  # phase 17
    mark("17 llava-next")
    onevision = run_onevision(dev)  # phase 18
    mark("18 llava-onevision")
    idefics2 = run_idefics2(dev)  # phase 19
    mark("19 idefics2")
    siglip_checkpoints = run_siglip_checkpoints(dev)  # phase 20
    mark("20 siglip checkpoints")
    internvl = run_internvl(dev)  # phase 21
    mark("21 internvl2")
    blip = run_instructblip(dev)  # phase 22
    mark("22 instructblip")
    family_checkpoints = run_family_checkpoints(dev)  # phase 23
    mark("23 internvl and instructblip checkpoints")
    phi3v, phi3v_model = run_phi3v(dev)  # phase 24
    mark("24 phi3v")
    family_checkpoints["phi3v"] = run_phi3v_checkpoint(dev, phi3v_model)  # phase 23, from phase 24's model
    del phi3v_model
    _free()
    mark("23 phi3v checkpoint")
    tp = run_tensor_parallel(dev, tp_refs, judge_answers, plain_vs_exact)  # phase 25
    del tp_refs
    mark("25 tensor parallel")

    # Each kernel's launches from the main path that carries it: phase 3 (bf16),
    # phase 5 (int8 cache), phase 6 (int4), phase 7 (Qwen2.5-VL) or phase 8 (packed);
    # phase 12's CLI runs report theirs in ``summary cli``.
    launches = {name: counts[name] for name in MIN_LAUNCHES}
    launches["gqa_decode_attention_int8"] = pool["counts"]["gqa_decode_attention_int8"]
    launches["int4_matmul"] = int4["counts"]["int4_matmul"]
    launches["fused_qkv_attention"] = v25["counts"]["fused_qkv_attention"]
    launches["packed_vision_attention"] = packed["launches"]
    # Phase 2's rows at phases 14-17's shapes, each with the launches of the
    # run that takes it (the counts those phases checked).
    also = {name: parity[name]["also"] for name in ("flash_attention", "gqa_decode_attention",
                                                    "gqa_decode_attention_int8")}
    def k2(run: dict, entry: str) -> int:  # K2 launches read around each call of ``entry``
        return sum(c.get("flash_attention", 0) for c in run["per_call"][entry])

    also["flash_attention"]["llava_tower"]["launches"] = k2(llava, "encode_images")
    also["flash_attention"]["llava_prefill"]["launches"] = k2(llava, "prefill")
    also["flash_attention"]["llava_next_prefill"]["launches"] = k2(llava["next"], "prefill")
    also["flash_attention"]["clip_vision"]["launches"] = k2(clip, "clip_vision_forward")
    also["flash_attention"]["clip_text"]["launches"] = k2(clip, "clip_text_encode")
    also["gqa_decode_attention"]["llava_decode"]["launches"] = llava["counts"]["gqa_decode_attention"]
    also["gqa_decode_attention"]["llava_next_decode"]["launches"] = llava["next"]["counts"]["gqa_decode_attention"]
    also["flash_attention"]["onevision_tower"]["launches"] = k2(onevision, "siglip_vision_forward")
    also["flash_attention"]["idefics2_tower"]["launches"] = k2(idefics2, "siglip_vision_forward")
    also["flash_attention"]["onevision_prefill"]["launches"] = k2(onevision, "prefill")
    also["flash_attention"]["mistral_prefill"]["launches"] = k2(idefics2, "prefill")
    also["flash_attention"]["internvit_tower"]["launches"] = k2(internvl, "internvit_forward")
    also["flash_attention"]["internvl_prefill"]["launches"] = k2(internvl, "prefill")
    also["flash_attention"]["blip_tower"]["launches"] = k2(blip, "blip_vision_forward")
    also["flash_attention"]["blip_prefill"]["launches"] = k2(blip, "prefill")
    also["flash_attention"]["phi3_tower"]["launches"] = k2(phi3v, "clip_vision_forward")
    also["flash_attention"]["phi3_prefill"]["launches"] = k2(phi3v, "prefill")
    for label in ("d72_contiguous_f32", "d72_tensor_f32", "blip_tower_general", "d88_ragged_f32", "d96_general",
                  "d96_ragged_f32", "d64_general"):
        also["flash_attention"][label]["launches"] = 0  # parity forms no phase serves
    also["gqa_decode_attention"]["phi3_decode"]["launches"] = phi3v["counts"]["gqa_decode_attention"]
    also["gqa_decode_attention"]["phi3_decode_f32"]["launches"] = 0
    also["gqa_decode_attention"]["internvl_decode"]["launches"] = internvl["counts"]["gqa_decode_attention"]
    also["gqa_decode_attention"]["internvl_decode_short"]["launches"] = 0  # phase 21's cache passes 2048
    also["gqa_decode_attention"]["blip_decode"]["launches"] = blip["counts"]["gqa_decode_attention"]
    also["gqa_decode_attention"]["onevision_decode"]["launches"] = onevision["counts"]["gqa_decode_attention"]
    also["gqa_decode_attention"]["mistral_decode"]["launches"] = idefics2["counts"]["gqa_decode_attention"]
    also["gqa_decode_attention_int8"]["llava_decode"]["launches"] = \
        llava["int8_kv_int8"]["counts"]["gqa_decode_attention_int8"]
    tp_counts = tp["forms"]["bf16"]["counts"]  # phase 25's rank 0, bf16
    also["flash_attention"]["tp_prefill"]["launches"] = tp_counts["flash_attention"]
    also["gqa_decode_attention"]["tp_decode"]["launches"] = tp_counts["gqa_decode_attention"]
    parity["vision_qkv_attention"]["also"]["tp_tower"]["launches"] = tp_counts["vision_qkv_attention"]
    kernels = [
        dict(
            name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
            launches=launches[name],
            **{k: parity[name][k] for k in ROW_KEYS},
            **{k: parity[name][k] for k in ("also", "all", "decode_step_m8", "instance") if k in parity[name]},
        )
        for name in KERNELS
    ]
    for label, run in (("int8_w8a8_pool2_kv_int8", pool), ("int4", int4), ("qwen2.5-vl-7b_bf16", v25)):
        summary = {k: run[k] for k in ("images", "seconds", "images_per_s", "phase_seconds", "peak_gb",
                                       "decode_steps", "counts", "decode_step", "logits") if k in run}
        if "unpooled_same_rows" in run:
            summary["unpooled_same_rows"] = run["unpooled_same_rows"]
        log(f"summary {label}: {json.dumps(summary)}")
    log(f"summary packed tower: {json.dumps(packed)}")
    pooled_rows = {"bf16": pool_rows, "int8_weight_only": pool["pool_rows_int8_weight_only"],
                   "int4": int4["pool_rows"]}
    log(f"summary pooled rows: {json.dumps(pooled_rows)}")
    for label, phase in (("checkpoint qwen2-vl-7b", checkpoint), ("checkpoint qwen2.5-vl-7b", checkpoint25)):
        log(f"summary {label}: {json.dumps(_phase_summary(phase))}")
    log(f"summary loglikelihood: {json.dumps(loglik)}")
    log(f"summary multi-round: {json.dumps(multi)}")
    log(f"summary cli: {json.dumps(cli)}")
    log(f"summary scoring: {json.dumps(scoring)}")
    log(f"summary clip: {json.dumps(clip)}")
    keys = ("images", "seconds", "images_per_s", "phase_seconds", "peak_gb", "decode_steps", "counts", "logits",
            "prompt_tokens", "bucket", "cache_len")
    def served(run: dict) -> dict:
        return {**{k: run[k] for k in keys if k in run}, "per_call": _call_summary(run["per_call"])}

    llava_summary = {
        "llava-1.5-7b bf16": served(llava),
        "llava-1.5-7b loglikelihood": {k: v for k, v in llava["loglikelihood"].items() if k != "losses"},
        "llava-1.5-7b int8 + int8 KV": served(llava["int8_kv_int8"]),
        "checkpoint": _phase_summary(llava["checkpoint"]),
        "llava-next-vicuna-7b bf16": served(llava["next"]),
    }
    log(f"summary llava: {json.dumps(llava_summary)}")
    siglip_summary = {
        f"{ONEVISION_PRESET} bf16": {**served(onevision), "tiles": onevision["tiles"]},
        f"{ONEVISION_PRESET} loglikelihood": {k: v for k, v in onevision["loglikelihood"].items() if k != "losses"},
        f"{IDEFICS2_PRESET} bf16": {**served(idefics2), "grid": idefics2["grid"],
                                    "valid_patches": idefics2["valid_patches"]},
        f"{IDEFICS2_PRESET} loglikelihood": {k: v for k, v in idefics2["loglikelihood"].items() if k != "losses"},
        "checkpoints": {family: _phase_summary(stats) for family, stats in siglip_checkpoints.items()},
    }
    log(f"summary siglip: {json.dumps(siglip_summary)}")
    quantized_keys = ("images", "seconds", "images_per_s", "phase_seconds", "peak_gb", "decode_steps", "counts",
                      "decode_step", "rows", "same_rows")
    v25_summary = {
        "int8 weight-only pooled rows": v25_quantized["pool_rows_int8_weight_only"],
        "int8 + W8A8 + int8 KV, pool 2": {k: v for k, v in v25_quantized["int8_w8a8_kv_int8"].items()
                                          if k in quantized_keys},
        "int8 + W8A8 + int8 KV, unpooled": {k: v for k, v in v25_quantized["int8_w8a8_kv_int8"]["unpooled"].items()
                                            if k in quantized_keys},
        "int4": {k: v for k, v in v25_quantized["int4"].items() if k in quantized_keys + ("pool_rows",)},
    }
    log(f"summary qwen2.5-vl quantized: {json.dumps(v25_summary)}")
    family_summary = {
        f"{INTERNVL_PRESET} bf16": {**served(internvl), "tiles": internvl["tiles"]},
        f"{INTERNVL_PRESET} loglikelihood": {k: v for k, v in internvl["loglikelihood"].items() if k != "losses"},
        f"{BLIP_PRESET} bf16": served(blip),
        f"{BLIP_PRESET} loglikelihood": {k: v for k, v in blip["loglikelihood"].items() if k != "losses"},
        "checkpoints": {family: _phase_summary(stats) for family, stats in family_checkpoints.items()},
    }
    log(f"summary internvl_blip: {json.dumps(family_summary)}")
    phi3v_summary = {
        f"{PHI3V_PRESET} bf16": {**served(phi3v), "image_rows": phi3v["image_rows"], "hostprof": phi3v["hostprof"],
                                 "longrope_attention_factor": phi3v["longrope_attention_factor"]},
        f"{PHI3V_PRESET} loglikelihood": {k: v for k, v in phi3v["loglikelihood"].items() if k != "losses"},
    }
    log(f"summary phi3v: {json.dumps(phi3v_summary)}")
    log(f"summary tensor parallel: {json.dumps(tp)}")
    log(f"summary wall seconds: {json.dumps(wall)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

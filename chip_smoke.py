#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, any failure exits non-zero:

1. build  every hand-written CUDA kernel from ``deepspeed_tpu_torch/csrc`` with
          nvcc (sm_90a), one nvcc per source, all started together;
2. check  each kernel against its plain PyTorch version on the card: RMSNorm and
          paged attention at the serving path's shapes, the latter also over
          int8 and e4m3 pools, and its ALiBi form over bf16, fp32, int8 and
          e4m3 pools at Bloom-7B1's decode and prefill shapes (32 kv heads:
          G = 1) and on the GQA batches (G = 4); then each of the paged
          kernel's forms by name (``check_paged_forms``: "split", W and S in
          bf16, "split" and S in fp32) on every one of those batches, every
          pool, ALiBi on and off, forms "split" and W bit-equal over two
          runs; the int8 quantiser (nearest and stochastic) and
          dequantiser at a Llama-3-8B w_up layer slice, at 2048 * 37 + 123 and
          with an all-zero block, which must equal their plain versions bit for
          bit; the three flash-attention kernels (forward, dq, dkv) at the
          training path's shapes (llama3-1b, GPT-2-125M, Llama-3-8B heads, a
          ragged S = 1000 with a keep-mask, S = 129), each in bf16 (the
          forward through its form W: wgmma fed by TMA) and fp32, and their
          ALiBi form at Bloom-560M's shape (G = 1), the llama3-1b heads (G =
          4), hd 128 and the ragged keep-mask set; the forward alone by form
          (``check_flash_forms``: form W and the mma.sync form, bf16, at
          ``FLASH_FORM_SETS``); the three
          block-sparse kernels (forward, dq, dkv) at the sparse training
          path's shape (BigBird, block 16, S 4096, 32 heads, D 64, causal), a
          ``fixed`` layout at block 32 and D 128, a non-causal BigBird layout
          and a hand-made layout with empty block rows at block 64, each in
          bf16 and fp32; the grouped GEMM, every form of it (``check_grouped``:
          form P, form D, the mma.sync form in bf16, the SIMT form in
          fp32), at Mixtral-8x7B's up (K 4096, N 14336) and down (K 14336, N
          4096) projections on group sizes from top-2 routing of 4096 and of
          16 random tokens, on a skewed set (half the rows in one group, an
          empty group, a single row, m = 4099) and, at m =
          ``GMM_DECODE_MAX_ROWS``, a decode-sized skewed set (one group with
          nearly all rows, single rows, empty groups, a row past the sum);
          at K 328, N 392 with a group boundary inside a 128-row box and rows
          past the sum; and at K 1001, N 299 (the mma.sync form and SIMT only)
          (tolerances stated beside each check);
2b. ops   the public op entry point (``deepspeed_tpu_torch.ops``): the
          registry's op matrix printed, then ``ops.layer_norm`` and
          ``ops.dispatch("layer_norm", "auto")`` (with a backward) on CUDA
          tensors at Bloom-7B1's width ([8, 4096] and [8064, 4096], bf16 and
          fp32), Bloom-560M's ([8192, 1024] bf16) and Falcon-7B's ([8064,
          4544] bf16), the counters zeroed just before and read just after:
          one LayerNorm kernel launch per call, the plain version never
          called on a CUDA tensor; outputs held by RMS_TOL and gradients by
          RMS_TOL scaled to the largest entry, against the plain version;
3. serve  Llama-3-8B at full width and depth (random bf16 weights from a seed,
          a 4 GiB bf16 KV pool: 2048 x 16 slots) through
          ``InferenceEngineV2.generate``: 8 prompts of 32-1000 tokens, 64 new
          tokens each, decode chains of 8, greedy, after one warm-up call. The
          kernels' launch counters are zeroed just before and read just after; every launch of the run
          must come from the path (65 RMSNorm and 32 paged-attention launches
          per forward), every decode forward's paged launches through form
          "split" and every prefill forward's through form W
          (``launches_by_form``, each forward's shape recorded), the plain
          paged attention never called (in every serving phase). One prefill
          step's last-token logits are then held against the same step run
          through the plain versions, and a decode chain and a prefill are
          profiled (device time by kernel, the device's busy share, the paged
          kernel's share by form; Bloom and Mixtral alike);
   quant  the same weights, prompts and 4 GiB pool budget through two
          quantised engines, each built and run with the counters zeroed just
          before and read just after: (a) an int8 KV pool with int8 weight-only
          quantisation (the weights quantised at init, one quantiser launch per
          layer slice and the head: 225; 225 dequantiser and 32 quantised
          paged-attention launches per forward), with a profiled decode chain
          (the dequantiser's share of the device time); (b) an e4m3 KV pool
          with bf16 weights. Each prints tok/s, peak memory, weight bytes, KV
          bytes per token and blocks, holds its prefill logits to the plain
          versions and prints its drift from the bf16 engine. Then one call of
          the public ``quantize_int8(..., stochastic=True)`` at the w_up shape
          (the stochastic kernel's only entry point). The weights are freed
          after;
   bloom  Bloom-7B1 at full width and depth (``BLOOM_7B1``: random bf16
          weights from seed 0, every bias and LayerNorm parameter redrawn
          from seed 1) through ``InferenceEngineV2.generate`` with the same
          prompts, settings and pool budget, over a bf16 pool, an int8 pool
          with int8 WOQ and an e4m3 pool: 30 ALiBi launches of the paged
          kernel per forward, the plain version never called, prefill logits
          held to the plain versions, a decode chain profiled for each; on
          the bf16 engine, an A/B that measures and switches nothing: the
          model's plain LayerNorm replaced by ``ops.layer_norm`` for one
          prefill step (logits within LOGITS_REL_L2 of the unreplaced run,
          62 kernel launches a forward) and a profiled decode chain, between
          two profiled chains without it;
   mixtral Mixtral-8x7B's widths (``MIXTRAL_8X7B``, the public config) at 16
          of its 32 layers (23.5 B parameters, 47 GB of random bf16 weights
          from seed 0: the full 93 GB does not fit the card) through
          ``InferenceEngineV2.generate``: 16 prompts of 32-1000 tokens (the
          8 above and 8 more), 64 new tokens, decode chains of 8, over a
          bf16 pool and an int8 pool. Every forward's token count T (pads
          included) is recorded: the forwards with T >= 2E = 16 (the
          prefill and the 16-row decodes) must launch the grouped GEMM 3
          times a layer, the others take the dense combine, and the plain
          grouped matmul is never called; by form, the prefill forwards'
          launches must be form P's and the decode forwards' form D's;
          prefill logits held to the plain versions, a decode chain profiled;
4. train  Llama-3.2-1B (the ``llama3-1b`` preset) at full width and depth
          through ``initialize`` / ``train_batch``, with the JAX package's
          headline training config (bench.py) less its ``hbm_guard``,
          ``diagnostics`` and ``telemetry`` sections, which are not ported:
          micro 4, gradient accumulation 2, seq 2048, bf16, AdamW (lr 1e-4,
          weight decay 0.1), ZeRO stage 1, clipping 1.0. 2 warm-up and 3
          timed steps on one numpy-seeded batch, the counters zeroed just
          before and read just after: the loss must be finite and fall, and
          the launches must equal 16 per micro-step for each flash kernel and
          33 for RMSNorm; every forward launch must be form W's
          (``flash_fwd.launches_by_form``) and the plain forward is spied on
          and never called on a CUDA tensor (in every training phase). One
          more step is profiled;
   bloom  Bloom-560M (``BLOOM_560M``, the public config's widths, random
          weights from seed 0 with every bias and LayerNorm parameter
          redrawn) through the same entry points and config: 24 ALiBi
          launches of each flash kernel per micro-step, none without ALiBi,
          no RMSNorm (its norms are LayerNorm); the fused cross entropy runs
          with the tied head. One more step is profiled;
   sparse the same preset and config with BigBird block-sparse attention
          (``attn_impl="sparse"``, block 16, 1 random block, a 3-block window,
          1 global block, seed 0) at seq 4096, micro 2, gradient accumulation
          2: each sparse kernel launched 16 times per micro-step, the flash
          kernels never, RMSNorm 33 times; MFU counts the attention FLOPs of
          the layout's live tiles. One more step is profiled. Then the same
          config through the dense flash kernels, in its own run, for its
          step time and peak memory;
5. slice  one micro-step (4 x 2048, a padded row) of a 2-layer, full-width
          llama3-1b through the kernels and through the plain versions: the
          loss and every gradient leaf compared; the same for the sparse
          config (2 x 4096, no padding mask, so the sparse kernels run) and
          for a 2-layer, full-width Bloom-560M (4 x 2048, a padded row, the
          ALiBi form);
6. train  the GPT-2-125M headline (bench.py's ``GPT2_HEADLINE_DIMS`` with
          ``scan_layers=False, fused_ce=False``): micro 4, gradient
          accumulation 8, seq 1024, otherwise as phase 4 (12 launches of each
          flash kernel per micro-step), one more step profiled;
6b. coll the collectives library with 4 ranks of one ``comm.RankGroup`` on the
          card (the test layout of a single-controller group; no NVLink
          crossed): the data-parallel gradient all-reduce of llama3-1b (rank
          r's fp32 gradients from one backward of the port's model on its
          own batch of 1 x 2048; 147 leaves, 1.4985 B elements a rank) leaf by
          leaf with ``op="mean"`` through ``pallas_ring`` with the none, int8
          and e4m3 wires, ``pallas_ring2d`` (2 x 2) int8 and the unfused
          ``ring`` int8; the ZeRO-3 all-gather of the flat bf16 weights, a
          quarter a rank, through ``pallas_ring`` none and int8; the MoE
          dispatch all-to-all at Mixtral-8x7B's width (8192 x 4096 bf16 a
          rank) through ``pallas_ring`` none, int8 and e4m3, the gather and
          the all-to-all twice, the second call timed. Every call is
          held to the same call through the plain versions (bit for bit), to
          the exact result (the mean within n fp32 ulps of the sum of |x|, a
          gather and an exact all-to-all exactly, lossy wires within JAX's
          test bounds) and, after an all-reduce or gather, every rank to rank
          0 byte for byte; the launch counts, zeroed just before and read
          just after, must equal what the schedules imply
          (``collective_launches``); one int8 all-reduce of the embedding's
          gradient is profiled;
6c. fused the fused GEMM collectives with 4 ranks of one group on the card, at
          llama3-1b's MLP widths: x [4096, 2048] a rank, w_up [2048, 8192]
          row-sharded (Ks 512), a row-parallel w_down shard [2048, 2048].
          Rows 14 and 15 one launch at a time, each form by name (T
          "wgmma", S "simt"), against their plain versions (exact, int8 and
          e4m3 wires; integer payloads bit for bit, normal ones by
          ``fused_gemm_close``; received shards, codes and scales bit for
          bit); the forward and ``dx`` of ``sharded_matmul`` and the
          row-parallel reduce-scatter through the kernels against the plain
          versions, and the exact wire against the unfused ops; then, the
          counters zeroed just before and read just after, 3 ZeRO-3 SGD
          steps through ``sharded_matmul``, one with the int8 wire and
          ``row_parallel_linear`` with and without it: n - 1 launches of each
          row a rank and op, every one form T (``launches_by_form``), no
          plain hop called, the trajectory falling and within 1e-4 of the
          same steps unfused; a step fused and unfused in turns (f u u f,
          twice) and one fused step under the profiler (kernel time, idle
          share);
7. time   each kernel with CUDA events beside its bound, its plain version and
          one PyTorch library call computing the same function (the paged
          kernel's forms "split", W and S and SDPA on K/V gathered beforehand
          in ``PAGED_TURN_ROUNDS`` palindromes, a cold L2 before each call,
          at rows 2, 2q and 2a's decode and prefill shapes, then the
          crossover sweep of forms "split" and W, ``PAGED_SWEEP``, and of form
          "split"'s split count, ``PAGED_SPLIT_SWEEP``; for the
          LayerNorm kernel ``F.layer_norm`` at [8, 4096] and [8064, 4096]
          bf16; none for the
          quantisers; for the sparse kernels SDPA with the layout expanded to
          a token mask; for the ALiBi forms SDPA with the bias and the causal
          mask as one float mask; for the grouped GEMM ``torch._grouped_mm``),
          the flash kernels' ALiBi form at Bloom-560M's shape beside the form
          without it; the flash forward's forms (form W, the mma.sync form)
          and SDPA in turns (``FWD_TURN_ROUNDS`` palindromes, each form W /
          SDPA ratio logged) at the llama3-1b, Bloom-560M (ALiBi) and
          Llama-3-8B heads' (hd 128) shapes, with TFLOP/s and the share of
          the bound; the grouped GEMM at Mixtral's up projection for a
          prefill (8192 routed rows) and a decode (32 routed rows), forms P
          and D, the mma.sync form and ``torch._grouped_mm`` timed in turns, then
          the crossover sweep of forms P and D at 32-512 routed rows over the
          up and down projections, the ring
          hop kernels at the largest gradient leaf's chunk (65.7 M
          elements: the int8 wire's relay beside ``Tensor.copy_``, one fused
          int8 hop), their NVLink bounds stated, not measured; the fused GEMM
          hops at phase 6c's four hop shapes (exact and int8 wires), form T,
          form S and the ``addmm`` / ``mm`` yardsticks in 2 palindromes,
          beside the 3xTF32 and SIMT bounds and the plain versions.

The line before the last is a JSON object ``{"kernels": [...]}``; the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing either.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

import deepspeed_tpu_torch
import deepspeed_tpu_torch.collectives.fused_gemm as fg_mod
import deepspeed_tpu_torch.collectives.pallas_backend as hop_mod
import deepspeed_tpu_torch.inference.model as model_mod
import deepspeed_tpu_torch.ops as torch_ops
import deepspeed_tpu_torch.inference.paged as paged_mod
import deepspeed_tpu_torch.inference.woq as woq_mod
import deepspeed_tpu_torch.models.transformer as transformer_mod
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.collectives.codecs import get_codec
from deepspeed_tpu_torch.inference import InferenceEngineV2, init_pool, ragged_forward
from deepspeed_tpu_torch.inference.paged import _kv_block_quant
from deepspeed_tpu_torch.inference.ragged import StateManager, build_ragged_batch
from deepspeed_tpu_torch.models import PRESETS, CausalLM, TransformerConfig, causal_lm_spec, init_params
from deepspeed_tpu_torch.models.transformer import alibi_slopes, flatten, sparse_layout
from deepspeed_tpu_torch.ops import block_sparse as bs
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import grouped_matmul as gmm_mod
from deepspeed_tpu_torch.ops import norms as norms_mod
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import quant as quant_mod
from deepspeed_tpu_torch.ops.norms import (
    layer_norm,
    layer_norm_reference,
    pallas_layer_norm,
    pallas_rms_norm,
    rms_norm,
    rms_norm_reference,
)
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_quant,
    paged_attention_reference,
)
from deepspeed_tpu_torch.ops.sparse_attention import get_sparsity_config
from deepspeed_tpu_torch.parallel import row_parallel_linear, sharded_matmul
from deepspeed_tpu_torch.parallel.zeropp import DEFAULT_BLOCK as ZEROPP_BLOCK
from deepspeed_tpu_torch.utils.checks import (
    GMM_SKEWED_SIZES,
    GMM_TOL,
    LSE_ALIBI_REL,
    bits_differ,
    block_wire,
    check_flash_bwd,
    check_flash_fwd,
    check_flash_kernels,
    check_grouped_matmul,
    check_sparse_kernels,
    flash_inputs,
    fused_gemm_close,
    fused_gemm_qb,
    grouped_inputs,
    plain_collective_kernels,
    routed_group_sizes,
    row_rel_l2,
)

# the module (``deepspeed_tpu_torch.ops`` re-exports its function of the same name)
pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of bytes / memory rate and operations / peak rate for the type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}

# rms_norm kernel vs plain version, (rtol, atol) per element: both compute in
# fp32 and round once; fp32 differs by sum order, bf16 by at most one output
# ulp (2**-8 relative)
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# the public op ``ops.layer_norm`` on the card (phase 2b): (rows, width,
# dtypes) at Bloom-7B1's width for a decode step and the 8-prompt prefill
# (1008-token rows), at Bloom-560M's for a training micro-batch (4 x 2048)
# and at Falcon-7B's for the prefill; held by RMS_TOL (the same rounding:
# fp32 statistics, the variance in two passes, one rounding of the output)
LN_SETS = {"bloom-7b1 decode": (8, 4096, (torch.bfloat16, torch.float32)),
           "bloom-7b1 prefill": (8064, 4096, (torch.bfloat16, torch.float32)),
           "bloom-560m micro-batch": (8192, 1024, (torch.bfloat16,)),
           "falcon-7b prefill": (8064, 4544, (torch.bfloat16,))}
# paged_attention kernel vs plain version: (rtol, atol) per element and a
# limit on the relative L2 error of each query's output vector [hd],
# ||got - want|| / ||want||, which holds a 1000-token row (outputs ~20x
# smaller than a 1-token row's) as tightly as a short one. Dropping the last
# 16-token page of a 1000-token row moves its output by ~15 % in that
# measure. bf16: the kernel scales q by hd**-0.5 in bf16 and keeps scores and
# p in fp32; the plain version rounds the scores and p to bf16 (its einsums
# run in bf16) and divides the scores afterwards; both round the output to
# bf16. Every batch is also checked in fp32, where only summation order
# differs, so a streaming fault cannot hide under bf16 rounding.
PAGED_TOL = {torch.bfloat16: (2e-2, 2e-2, 2e-2), torch.float32: (2e-5, 2e-5, 1e-4)}
# flash kernels vs plain versions: the largest relative L2 error of one (b, s,
# h) row vector [hd] of out, dq, dk and dv, each row's norm floored at 1e-3 of
# the RMS row norm (rows that cancel to ~0: dq of query 0, which sees one key,
# is p * (dO.v0 - dO.o) with o = v0). bf16: P and dS are rounded to bf16 before
# their products in both, but the kernel's sums run in another order and its
# fp32 output is rounded once; fp32: summation order only. lse (fp32 in both,
# from the same operands) by absolute error over rows with a visible key. Rows
# with no visible key must be exactly 0 (lse the finfo(float32).min sentinel),
# and so must dk and dv of keys the keep-mask drops. Limits set from the
# readings of the first full run (H100, 700 W) with a margin of >= 2.7x: bf16
# max 7.4e-3 (dq, Llama-3-8B heads), fp32 max 1.8e-6 (out; dq, dk and dv
# matched bit for bit), lse max 1.9e-6 (one fp32 ulp at |lse| ~ 16).
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LSE_TOL = 1e-5  # the ALiBi form's lse is held to LSE_ALIBI_REL (utils/checks.py)
LOGITS_REL_L2 = 5e-2  # kernels vs plain versions through 32 bf16 layers
# an MoE model's prefill check: the plain run takes the kernels' run's expert
# choices, and where its own would differ, its probability margin between the
# k-th and (k+1)-th expert must be a near tie. bf16 rounding moves a router
# logit by ~1e-2 and a probability by a few 1e-3 (first H100 run: flips at
# margins of at most 8.2e-3 over 16 layers)
MOE_FLIP_MARGIN = 2e-2
# 2-layer llama3-1b micro-step, kernels vs plain versions in bf16: relative
# error of the loss, and relative L2 error of each gradient leaf (first full
# run: 4.4e-6 and at most 1.27e-2, the embedding's; the limits leave 20x and 4x)
SLICE_LOSS_REL = 1e-4
SLICE_GRAD_REL_L2 = 5e-2
# the key bias gets no gradient in exact arithmetic without RoPE (adding one
# vector to every key shifts a row's scores by a constant, which the softmax
# removes): both readings are rounding noise, so its difference is held to
# SLICE_GRAD_REL_L2 of the query bias's gradient norm, the same sums'
# scale, instead of its own
SHIFT_INVARIANT = ("layers.attn.wk.bias", "layers.attn.wq.bias")
SPIN_CYCLES = 4_000_000  # ~2 ms of GPU clock: longer than the host needs to enqueue a timed group

# The JAX package's headline GPT-2-125M dimensions (bench.py GPT2_HEADLINE_DIMS)
GPT2_HEADLINE_DIMS = dict(
    vocab_size=50304, hidden_size=768, intermediate_size=3072,
    num_layers=12, num_heads=12, max_seq_len=1024,
    norm="layernorm", activation="gelu", position="learned",
    tie_embeddings=True,
)
# bench.py's training config without hbm_guard / diagnostics / telemetry
TRAIN_CONFIG = {
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "zero_optimization": {"stage": 1},
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "steps_per_print": 10_000,
}
TRAIN_WARMUP, TRAIN_TIMED = 2, 3
# flash-attention check shapes: [B, S, heads, hd] of the training path's models
FLASH_SETS = {
    "llama3-1b": dict(B=4, S=2048, H=32, kvH=8, hd=64),
    "gpt2-125m": dict(B=4, S=1024, H=12, kvH=12, hd=64),
    "llama3-8b heads": dict(B=1, S=2048, H=32, kvH=8, hd=128),
    # right padding: row 1 keeps 613 keys, row 2 none (every query row masked)
    "ragged S=1000 keep-mask": dict(B=3, S=1000, H=32, kvH=8, hd=64, keep_lens=(1000, 613, 0)),
    # one row past a 128-row tile, 63 rows short of a 192-row one: form W's partial first tile
    "S=129": dict(B=2, S=129, H=32, kvH=8, hd=64),
}
# the ALiBi form of the same kernels (Bloom's slopes): Bloom-560M's
# training shape (G = 1), the llama3-1b heads (G = 4: the slope is the query
# head's, not its kv head's), hd 128, and the ragged keep-mask set
FLASH_ALIBI_SETS = {
    "bloom-560m": dict(B=4, S=2048, H=16, kvH=16, hd=64),
    "llama3-1b heads": dict(B=4, S=2048, H=32, kvH=8, hd=64),
    "llama3-8b heads": dict(B=1, S=2048, H=32, kvH=8, hd=128),
    "ragged S=1000 keep-mask": dict(B=3, S=1000, H=32, kvH=8, hd=64, keep_lens=(1000, 613, 0)),
}
# the flash wrappers the training path calls: the forward and the backward
# (form W for bf16: one kernel for dq, dk and dv)
FLASH_KERNELS = ("flash_fwd", "flash_bwd")
# launch counters of their ALiBi form (``<wrapper>.alibi_launches``)
FLASH_ALIBI_KERNELS = tuple(f"{k}_alibi" for k in FLASH_KERNELS)
# the backward's dq and dkv pair (its "mma" and "simt" forms), held alone by
# phase 2; the training path launches neither
FLASH_PAIR = ("flash_bwd_dq", "flash_bwd_dkv")
FLASH_PAIR_ALIBI = tuple(f"{k}_alibi" for k in FLASH_PAIR)
SPARSE_KERNELS = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
# BigBird as the model config gives it (the JAX defaults: 1 random block, a
# 3-block window, 1 global block, seed 0) at the BigBird paper's length
SPARSE_ATTENTION = {"mode": "bigbird", "block": 16}
SPARSE_SEQ = 4096
# the sparse kernels' timing shape: the sparse training path's attention (q
# [B, S, H, D], k and v [B, S, kvH, D])
SPARSE_TIME_SHAPE = dict(B=2, H=32, kvH=8, S=SPARSE_SEQ, D=64)
# sparse-kernel check shapes (q [B, S, H, D], k and v [B, S, kvH, D]) and
# layouts; the kernels are held by FLASH_TOL / LSE_TOL (the same rounding
# points: P and dS cast before their products, fp32 sums in another order)
SPARSE_SETS = {
    "llama3-1b bigbird S=4096": dict(B=2, H=32, kvH=8, S=4096, D=64, mode="bigbird", kw={},
                                     block=16, causal=True),
    "fixed block 32 D=128": dict(B=1, H=16, kvH=4, S=4096, D=128, mode="fixed",
                                 kw={"num_local_blocks": 4}, block=32, causal=True),
    "bigbird non-causal": dict(B=2, H=32, kvH=8, S=2048, D=64, mode="bigbird", kw={}, block=16,
                               causal=False),
    # block rows 3 (every head) and 7 (head 1) emptied: output, dq 0 there
    "empty rows block 64": dict(B=2, H=8, kvH=8, S=2048, D=64, mode="local",
                                kw={"num_sliding_window_blocks": 2}, block=64, causal=True,
                                empty=((slice(None), 3), (1, 7))),
}
QUANT_KERNELS = ("quantize_int8", "quantize_int8_stochastic", "dequantize_int8")
KV_POOL_BYTES = 4 * 2 ** 30  # every serving engine's KV pool budget
W_UP_SLICE = (4096, 14336)  # one layer of Llama-3-8B's w_up: 58,720,256 elements
KV_CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# grouped-GEMM check shapes (K, N): Mixtral-8x7B's up and down projections;
# and an edge set (sizes, rows, K, N): K and N not multiples of 8 (the
# element-wise copy path), empty groups and 10 rows past the sizes' sum
GMM_SHAPES = {"up": (4096, 14336), "down": (14336, 4096)}
# form D's skewed set at the most rows it is picked for: nearly all in one
# group, single rows, empty groups, one row past the sum
GMM_DECODE_SKEWED = ((0, gmm_mod.GMM_DECODE_MAX_ROWS - 3, 0, 0, 1, 0, 0, 1),
                     gmm_mod.GMM_DECODE_MAX_ROWS)
# the TMA forms' edges: a group boundary inside a 128-row box, K % 64 != 0, N
# % 256 != 0, an empty last group and rows past the sizes' sum
GMM_TMA_EDGE = ((100, 300, 0, 129, 0), 600, 328, 392)
GMM_SWEEP_TOKENS = (16, 32, 64, 128, 256)  # the crossover sweep: 32-512 routed rows, top-2
# the collectives phase: 4 ranks of one group on the card
COLL_KERNELS = ("permute_leaves", "fused_hop")  # rows 12 and 13 (csrc/ring_hop.cu)
COLL_RANKS = 4
COLL_PRESET, COLL_SEQ = "llama3-1b", 2048  # rank r's gradients: one micro-step of 1 x 2048
GRAD_WAYS = (("pallas_ring", "none"), ("pallas_ring", "int8"), ("pallas_ring", "fp8"),
             ("pallas_ring2d", "int8"), ("ring", "int8"))
GATHER_WAYS = (("pallas_ring", "none"), ("pallas_ring", "int8"))
A2A_WAYS = (("pallas_ring", "none"), ("pallas_ring", "int8"), ("pallas_ring", "fp8"))
MOE_A2A_ROWS = (8192, 4096)  # Mixtral-8x7B: 4096 tokens x top-2 routed rows of hidden 4096, bf16
# lossy wires against the exact result, as a share of its largest magnitude:
# JAX's own test bounds (all_reduce 0.15, gather 0.01 int8, all_to_all 0.02
# int8 / 0.06 e4m3)
COLL_LOSSY_BOUND = {"all_reduce": {"int8": 0.15, "fp8": 0.15}, "all_gather": {"int8": 0.01},
                    "all_to_all": {"int8": 0.02, "fp8": 0.06}}
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way
# the fused GEMM phase: 4 ranks of one group at llama3-1b's MLP widths
FUSED_KERNELS = ("ag_hop", "rs_hop")  # rows 14 and 15 (csrc/fused_gemm.cu)
FUSED_RANKS = 4
FUSED_X = (4096, 2048)  # a rank's tokens x hidden
FUSED_W_UP = (2048, 8192)  # w_up, row-sharded over the ranks: Ks = 512
FUSED_W_ROW = (2048, 2048)  # a rank's rows of w_down [8192, 2048]: row_parallel_linear
FUSED_WIRES = ("none", "int8", "fp8")
FUSED_STEPS, FUSED_LR = 3, 100.0  # ZeRO-3 SGD on a mean-squared loss
FUSED_REL = 1e-4  # the fused trajectory against the unfused one (JAX's test bound)
GMM_EDGE = ((0, 37, 1, 200, 0, 5, 64, 3), 320, 1001, 299)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def counted() -> dict:
    """Every kernel's launch counter by name: (wrapper, attribute). The
    paged-attention wrappers count their ALiBi launches, over any pool, in
    ``paged_attention.alibi_launches``; each flash wrapper its own in
    ``<wrapper>.alibi_launches``."""
    return {"rms_norm": (rms_norm, "launches"), "layer_norm": (layer_norm, "launches"),
            "paged_attention": (paged_attention, "launches"),
            "paged_attention_quant": (paged_attention_quant, "launches"),
            "paged_attention_alibi": (paged_attention, "alibi_launches"),
            **{name: (getattr(quant_mod, name), "launches") for name in QUANT_KERNELS},
            **{name: (getattr(fa, name), "launches") for name in FLASH_KERNELS + FLASH_PAIR},
            **{f"{name}_alibi": (getattr(fa, name), "alibi_launches")
               for name in FLASH_KERNELS + FLASH_PAIR},
            **{name: (getattr(bs, name), "launches") for name in SPARSE_KERNELS},
            "grouped_matmul": (gmm_mod.grouped_matmul, "launches"),
            **{name: (getattr(hop_mod, name), "launches") for name in COLL_KERNELS},
            **{name: (getattr(fg_mod, name), "launches") for name in FUSED_KERNELS}}


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counted().items()}


def zero_counts() -> None:
    """Every kernel's launch counter and ``_moe``'s per-regime call counters."""
    for fn, attr in counted().values():
        setattr(fn, attr, 0)
    gmm_mod.grouped_matmul.launches_by_form.update(dict.fromkeys(gmm_mod.FORMS, 0))
    for wrapper in (paged_attention, paged_attention_quant):
        wrapper.launches_by_form.update(dict.fromkeys(pa_mod.PAGED_FORMS, 0))
    fa.flash_fwd.launches_by_form.update(dict.fromkeys(fa.FWD_FORMS, 0))
    fa.flash_bwd.launches_by_form.update(dict.fromkeys(fa.BWD_FORMS, 0))
    for name in FUSED_KERNELS:
        getattr(fg_mod, name).launches_by_form.update(dict.fromkeys(fg_mod.FUSED_FORMS, 0))
    model_mod._moe.dense_calls = model_mod._moe.ragged_calls = 0


def compare_rms(got, want, dtype):
    """Element-wise check: (ok, max abs error, max relative error)."""
    rtol, atol = RMS_TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((err <= atol + rtol * w.abs()).all())
    return ok, float(err.max()), float((err / w.abs().clamp_min(1e-6)).max())


def compare_paged(got, want, dtype):
    """Element-wise and per-query-vector check: (ok, max abs error, max
    relative L2 error of one query's output [hd])."""
    rtol, atol, rel_l2 = PAGED_TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    max_rel = float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-6)).max())
    ok = (bool(torch.isfinite(g).all()) and bool((err <= atol + rtol * w.abs()).all())
          and max_rel <= rel_l2)
    return ok, float(err.max()), max_rel


# ------------------------------------------------------------------ inputs
def quantised_batch(batch, kv):
    """``batch`` with its pools quantised to ``kv`` codes (one fp32 scale per
    slot and kv head, the serving pool's layout)."""
    kq, ks = _kv_block_quant(batch["pool_k_l"], kv)
    vq, vs = _kv_block_quant(batch["pool_v_l"], kv)
    return dict(batch, pool_k_l=kq, pool_v_l=vq, k_scale=ks, v_scale=vs)


def quantizer_inputs(dev, rng):
    """The quantiser check inputs (fp32, cast per check): a w_up layer
    slice, 2048 * 37 + 123 elements with an all-zero block, and 100."""
    x = torch.from_numpy(rng.standard_normal(W_UP_SLICE, dtype=np.float32) * 0.02).to(dev)
    y = torch.from_numpy(rng.standard_normal(2048 * 37 + 123, dtype=np.float32) * 3).to(dev)
    y[2048:4096] = 0
    z = torch.from_numpy(rng.standard_normal(100, dtype=np.float32)).to(dev)
    return {f"w_up slice {list(W_UP_SLICE)}": x, "2048 * 37 + 123, a zero block": y, "100": z}


def check_quantizers(dev, rng):
    """Quantiser and dequantiser kernels against their plain versions: codes,
    scales and dequantised values identical; stochastic codes also floor or
    floor + 1 of x / scale and the same for the same seed."""
    failures = []
    for label, x32 in quantizer_inputs(dev, rng).items():
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            q, s = quant_mod.quantize_int8(x)
            sq, ss = quant_mod.quantize_int8(x, stochastic=True, seed=5)
            sq2, _ = quant_mod.quantize_int8(x, stochastic=True, seed=5)
            torch.cuda.synchronize()
            rq, rs = quant_mod.quantize_int8_reference(x)
            rsq, rss = quant_mod.quantize_int8_stochastic_reference(x, seed=5)
            scaled = (x.float().reshape(-1)[: q.numel()]
                      / s.repeat_interleave(min(2048, q.numel()))[: q.numel()])
            low = torch.floor(scaled)
            codes = sq.float()
            ok = {"nearest": torch.equal(q, rq) and torch.equal(s, rs),
                  "stochastic": torch.equal(sq, rsq) and torch.equal(ss, rss),
                  "floor/floor+1": bool(((codes == low) | (codes == low + 1)).all()),
                  "seeded": torch.equal(sq, sq2)}
            for out in (torch.bfloat16, torch.float32):
                got = quant_mod.dequantize_int8(q, s, x.shape, out)
                torch.cuda.synchronize()
                ok[f"dequant {str(out)[6:]}"] = torch.equal(
                    got, quant_mod.dequantize_int8_reference(q, s, x.shape, out))
            diff = int((q.int() - rq.int()).abs().max())
            log(f"[check] quantizer {label} {str(dtype)[6:]}: {ok}; codes max diff {diff}, "
                f"{int((q != rq).sum())} differ; tol identical {'ok' if all(ok.values()) else 'FAIL'}")
            if not all(ok.values()):
                failures.append(f"quantizer {label} {dtype}")
    return failures


def paged_batch(dev, rng, *, lens, new_lens, H=32, kvH=8, hd=128, bs=16, garbage_tail=False,
                dtype=torch.bfloat16):
    """A paged-attention batch: row n holds ``lens[n]`` tokens in the pool, of
    which the last ``new_lens[n]`` are this step's queries (C = max new_lens;
    a row with new_lens 0 is a pad row: position 0, block-table row 0).
    With ``garbage_tail`` the block-table entries past each row's live pages
    point at pages full of +-1e4 (finite in bf16)."""
    N, C = len(lens), max(max(new_lens), 1)
    pages = [-(-max(n, 1) // bs) for n in lens]
    P = max(pages) + (4 if garbage_tail else 0)
    n_garbage = 8 if garbage_tail else 0
    NB = sum(pages) + n_garbage + 1
    perm = rng.permutation(NB - n_garbage) + n_garbage  # live pages avoid the garbage ids
    bt = np.zeros((N, P), np.int32)
    pos = np.zeros((N, C), np.int32)
    i = 0
    for n, (L, k) in enumerate(zip(lens, new_lens)):
        if k == 0:
            continue  # pad row
        bt[n, :pages[n]] = perm[i:i + pages[n]]
        i += pages[n]
        if garbage_tail:
            bt[n, pages[n]:] = rng.integers(0, n_garbage, P - pages[n])
        pos[n, :k] = np.arange(L - k, L)
    S = NB * bs + 1
    q = torch.from_numpy(rng.standard_normal((N, C, H, hd), dtype=np.float32)).to(dev, dtype)
    pk = torch.from_numpy(rng.standard_normal((S, kvH, hd), dtype=np.float32)).to(dev, dtype)
    pv = torch.from_numpy(rng.standard_normal((S, kvH, hd), dtype=np.float32)).to(dev, dtype)
    if garbage_tail:
        pk[: n_garbage * bs] = 1e4
        pv[: n_garbage * bs] = -1e4
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(q=q, pool_k_l=pk, pool_v_l=pv, block_tables=t(bt), q_positions=t(pos),
                block_size=bs, new_lens=t(np.asarray(new_lens, np.int32))), lens


def dense_sdpa_operands(batch, lens):
    """The library yardstick's operands: K/V gathered dense (and dequantised
    to q's dtype for a quantised pool) outside the timing, q and the causal
    mask in SDPA's [N, H, S, hd] layout."""
    q = batch["q"]
    N, C, H, hd = q.shape
    G = H // batch["pool_k_l"].shape[1]
    T = max(lens)
    bs = batch["block_size"]
    slot = (batch["block_tables"].long()[:, :, None] * bs
            + torch.arange(bs, device=q.device)).reshape(N, -1)[:, :T]
    kd, vd = batch["pool_k_l"][slot], batch["pool_v_l"][slot]
    if "k_scale" in batch:
        kd = (kd.float() * batch["k_scale"][slot]).to(q.dtype)
        vd = (vd.float() * batch["v_scale"][slot]).to(q.dtype)
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= batch["q_positions"].long()[:, :, None])[:, None]
    return kd, vd, q.permute(0, 2, 1, 3).contiguous(), mask


def paged_bytes_and_flops(batch, lens):
    """Bytes the function must move (inputs read once, output written once,
    only the live pages of the pool: hd values, plus a 4-byte scale for a
    quantised pool, per token and kv head; the fp32 slopes with ALiBi) and
    its flops (with ALiBi 2 more per visible score: slope times distance,
    added), for this batch's data."""
    q = batch["q"]
    N, C, H, hd = q.shape
    kvH, it = batch["pool_k_l"].shape[1], q.element_size()
    live_tokens = sum(lens[n] for n in range(N) if int(batch["new_lens"][n]) > 0)
    per_head = hd * batch["pool_k_l"].element_size() + (4 if "k_scale" in batch else 0)
    kv = 2 * live_tokens * kvH * per_head
    other = 2 * q.numel() * it + batch["block_tables"].numel() * 4 + batch["q_positions"].numel() * 4 + N * 4
    # scores and p@V, 2 flops per multiply-add, causal: each query sees up to its position
    pos = batch["q_positions"].cpu().numpy()
    nl = batch["new_lens"].cpu().numpy()
    visible = sum(int(pos[n, c]) + 1 for n in range(N) for c in range(int(nl[n])))
    flops = 4 * visible * H * hd
    if batch.get("alibi_slopes") is not None:
        other += 4 * H
        flops += 2 * visible * H
    return kv + other, flops


def alibi_sdpa_mask(batch, mask):
    """The library yardstick's float mask ``[N, H, C, T]`` in q's dtype: the
    ALiBi bias slope[h] * (t - p) where the boolean causal ``mask`` keeps a
    key, -inf elsewhere."""
    pos = batch["q_positions"].long()
    T = mask.shape[-1]
    rel = (torch.arange(T, device=pos.device)[None, None, :] - pos[:, :, None]).float()
    bias = batch["alibi_slopes"][None, :, None, None] * rel[:, None]
    return torch.where(mask, bias, float("-inf")).to(batch["q"].dtype)


def check_flash(dev, shape, dtype, alibi=False):
    """The three flash kernels (with ``alibi``, their ALiBi form, on the
    model's slopes for the shape's heads) against their plain versions on the
    same inputs (the plain dq/dkv take the kernel's lse and delta, so each
    kernel is held alone). Returns (ok, {name: (row rel L2, max abs)}, lse
    error: absolute, or with ``alibi`` as a share of max(|lse|, 10))."""
    q, k, v, do, keep = flash_inputs(dev, **shape)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    slopes = fa.alibi_log2(alibi_slopes(shape["H"], dev)) if alibi else None
    readings, lse_err, dead_exact = check_flash_kernels(q, k, v, do, keep, slopes)
    ok = (all(rel <= FLASH_TOL[dtype] for rel, _ in readings.values()) and dead_exact
          and lse_err <= (LSE_ALIBI_REL if alibi else LSE_TOL))
    return ok, readings, lse_err


# the forward's bf16 forms, checked and timed by name: form W, which the
# wrapper runs, and the mma.sync form it replaced
FLASH_FWD_FORMS = ("wgmma", "mma")
# form W's forward and the mma.sync form checked by name at these sets (bf16;
# FLASH_SETS / FLASH_ALIBI_SETS names, ALiBi or not)
FLASH_FORM_SETS = (("llama3-1b", False), ("S=129", False), ("llama3-8b heads", False),
                   ("bloom-560m", True), ("ragged S=1000 keep-mask", True))


def check_flash_forms(dev, max_err):
    """Phase 2's forward checks by form: at each ``FLASH_FORM_SETS`` set, bf16,
    form W and the mma.sync form against the plain version, by FLASH_TOL, LSE_TOL (ALiBi: LSE_ALIBI_REL), rows with no
    visible key exactly 0 with the lse sentinel."""
    failures = []
    for label, alibi in FLASH_FORM_SETS:
        shape = (FLASH_ALIBI_SETS if alibi else FLASH_SETS)[label]
        q, k, v, _, keep = flash_inputs(dev, **shape)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        slopes = fa.alibi_log2(alibi_slopes(shape["H"], dev)) if alibi else None
        texts, bad = [], []
        for name in FLASH_FWD_FORMS:
            rel, mabs, lse_err, dead_exact, _ = check_flash_fwd(q, k, v, keep, slopes, name)
            key = "flash_fwd_alibi" if alibi else "flash_fwd"
            max_err[key] = max(max_err[key], mabs)
            ok = (rel <= FLASH_TOL[torch.bfloat16] and dead_exact
                  and lse_err <= (LSE_ALIBI_REL if alibi else LSE_TOL))
            texts.append(f"{name} {rel:.3e}/{lse_err:.1e}")
            if not ok:
                bad.append(name)
        log(f"[check] flash_fwd by form{' alibi' if alibi else ''} {label} bf16 (out row rel L2 / "
            f"lse error; tol {FLASH_TOL[torch.bfloat16]} / "
            f"{LSE_ALIBI_REL if alibi else LSE_TOL}, empty rows exact): " + ", ".join(texts)
            + (f" FAIL {bad}" if bad else " ok"))
        failures += [f"flash_fwd form {name} {label}" for name in bad]
        del q, k, v, keep
        torch.cuda.empty_cache()
    return failures


# the backward's bf16 forms, checked and timed by name: form W, which the
# wrapper runs, and the mma.sync dq and dkv pair it replaced
FLASH_BWD_FORMS = ("wgmma", "mma")


def check_flash_bwd_forms(dev, max_err):
    """Phase 2's backward checks by form: at each ``FLASH_FORM_SETS`` set,
    bf16, with and without ALiBi, form W and the mma pair against the plain
    version by FLASH_TOL (dq, dk and dv each), dq of rows with no visible key
    and dk, dv of keys the keep-mask drops exactly 0; form W run twice on the
    same inputs gives bit-equal dk and dv and dq within FLASH_TOL (its dq
    partial sums land in any order)."""
    failures = []
    tol = FLASH_TOL[torch.bfloat16]
    for label, _ in FLASH_FORM_SETS:
        shape = FLASH_SETS.get(label) or FLASH_ALIBI_SETS[label]
        q, k, v, do, keep = flash_inputs(dev, **shape)
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        for alibi in (False, True):
            slopes = fa.alibi_log2(alibi_slopes(shape["H"], dev)) if alibi else None
            texts, bad = [], []
            for name in FLASH_BWD_FORMS:
                readings, dead_exact, got = check_flash_bwd(q, k, v, do, keep, slopes, name)
                ok = all(rel <= tol for rel, _ in readings.values()) and dead_exact
                text = f"{name} " + "/".join(f"{r:.3e}" for r, _ in readings.values())
                if name == "wgmma":  # its errors are the kernel line's; and a second run
                    key = "flash_bwd_alibi" if alibi else "flash_bwd"
                    max_err[key] = max([max_err[key]] + [a for _, a in readings.values()])
                    again = check_flash_bwd(q, k, v, do, keep, slopes, name)[2]
                    dq_rerun = row_rel_l2(again[0], got[0])
                    bit_equal = torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
                    ok = ok and dq_rerun <= tol and bit_equal
                    text += f" (rerun: dq {dq_rerun:.2e}, dk dv bit-equal {bit_equal})"
                    del again
                texts.append(text)
                if not ok:
                    bad.append(name)
                del got
            log(f"[check] flash_bwd by form{' alibi' if alibi else ''} {label} bf16 (dq/dk/dv row "
                f"rel L2; tol {tol}, empty rows and dropped keys exact): " + ", ".join(texts)
                + (f" FAIL {bad}" if bad else " ok"))
            failures += [f"flash_bwd form {name} {label}{' alibi' if alibi else ''}" for name in bad]
        del q, k, v, do, keep
        torch.cuda.empty_cache()
    return failures


def sparse_set_inputs(dev, shape, dtype):
    """q, dO ``[B, S, H, D]``, k, v ``[B, S, kvH, D]`` in ``dtype`` and the
    layout of one SPARSE_SETS entry (its ``empty`` block rows cleared)."""
    layout = get_sparsity_config(shape["mode"], num_heads=shape["H"], block=shape["block"],
                                 **shape["kw"]).make_layout(shape["S"])
    for index in shape.get("empty", ()):
        layout[index] = 0
    inputs = flash_inputs(dev, shape["B"], shape["S"], shape["H"], shape["kvH"], shape["D"])
    q, k, v, do = (t.to(dtype) for t in inputs[:4])
    return q, k, v, do, layout


def check_sparse(dev, shape, dtype):
    """The three sparse kernels against their plain versions: (ok, {name:
    (row rel L2, max abs)}, lse error)."""
    q, k, v, do, layout = sparse_set_inputs(dev, shape, dtype)
    readings, lse_err, dead_exact = check_sparse_kernels(q, k, v, do, layout, shape["block"],
                                                         shape["causal"])
    ok = (all(rel <= FLASH_TOL[dtype] for rel, _ in readings.values()) and lse_err <= LSE_TOL
          and dead_exact)
    return ok, readings, lse_err


def live_tiles(layout, causal=True):
    """Tiles the kernels compute: layout entries, with ``causal`` only those
    whose key block is not after the query block (summed over heads)."""
    live = np.asarray(layout) != 0
    return int((np.tril(live) if causal else live).sum())


def sparse_flops_per_token(cfg, seq, dev):
    """Training FLOPs per token with the attention term of the layout's live
    tiles: the JAX formula's 12 * L * hidden * S counts every query against
    all S keys (fwd + bwd, 2 products); here each query of a head counts
    ``block * live tiles of its block row`` keys, averaged over rows and
    summed over heads. Returns (flops per token, live tiles)."""
    layout, block, _ = sparse_layout(cfg.sparse_attention, cfg.num_heads, seq, dev)
    live = live_tiles(layout)
    attn = 12 * cfg.num_layers * cfg.dims_per_head * block * live / (seq // block)
    return 6 * cfg.num_params() + attn, live


# ------------------------------------------------------------------ timing
def time_fn(fn, iters=100, warmup=10, flush=None):
    """Median device milliseconds per call, by CUDA events. The GPU is held
    in a spin (``torch.cuda._sleep``) while the host enqueues the timed
    calls, so host-side launch cost stays out of the number. With ``flush``
    each call is timed alone after the flush (a cold L2, as the serving path
    finds the KV pages), else groups of 20 back-to-back calls are timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per = 1 if flush else 20
    times = []
    for _ in range(max(iters // per, 5)):
        torch.cuda._sleep(SPIN_CYCLES)
        if flush is not None:
            flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


def device_profile(fn, union=False):
    """``fn`` run once timed alone and once under torch.profiler (device
    activity only: host op tracing would slow a host-bound loop), its wall
    time and its device time by kernel both from that one run. Returns
    (profiled wall ms, its device kernel ms, unprofiled wall ms, rows). With
    ``union`` the device ms is the time covered by at least one kernel (the
    kernels of concurrent streams overlap, so their sum can pass the wall)."""

    def wall_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_wall_ms = wall_ms()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = wall_ms()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their kernels are listed on their own
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    if not union:
        return wall, sum(r[0] for r in rows), plain_wall_ms, rows
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, None
    for start, stop in spans:
        if end is None or start > end:
            busy_us, end = busy_us + stop - start, stop
        elif stop > end:
            busy_us, end = busy_us + stop - end, stop
    return wall, busy_us / 1e3, plain_wall_ms, rows


def log_profile(tag, what, wall_ms, busy_ms, plain_wall_ms, rows):
    log(f"[{tag}] {what} under the profiler: wall {wall_ms:.2f} ms, device kernels "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f} %; the same unprofiled: wall "
        f"{plain_wall_ms:.2f} ms (profiler overhead {wall_ms - plain_wall_ms:+.2f} ms)")
    for dev_ms, count, name in rows[:12]:
        log(f"[{tag}]   {dev_ms:9.3f} ms  {count:6d}x  {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "unprofiled_wall_ms": plain_wall_ms,
            "top": [list(r) for r in rows[:20]]}


def check_paged_alibi(dev, rng, checks, max_err):
    """The ALiBi form against its plain version over a pool of q's dtype and
    over int8 and e4m3 pools, each with bf16 and fp32 q: on Bloom-7B1's
    decode and prefill batches (32 query and 32 kv heads: G = 1), added to
    ``checks`` for the timing phase, and on the GQA batches (G = 4)."""
    checks["bloom decode C=1, lens 1-1000"] = paged_batch(
        dev, rng, lens=[1, 17, 100, 250, 511, 512, 777, 1000], new_lens=[1] * 8, kvH=32)
    checks["bloom prefill C=512, ragged, pad row"] = paged_batch(
        dev, rng, lens=[512, 500, 1, 977, 64], new_lens=[512, 300, 0, 77, 64], kvH=32)
    failures = []
    for label, (batch, lens) in checks.items():
        slopes = alibi_slopes(batch["q"].shape[2], dev)
        for kv in (None, *KV_CODE_DTYPES):
            pools = batch if kv is None else quantised_batch(batch, kv)
            for dtype in (torch.bfloat16, torch.float32):
                b = dict(pools, q=batch["q"].to(dtype), alibi_slopes=slopes)
                if kv is None:
                    b.update(pool_k_l=batch["pool_k_l"].to(dtype), pool_v_l=batch["pool_v_l"].to(dtype))
                got = paged_attention(**b)
                torch.cuda.synchronize()
                ok, mabs, mrel = compare_paged(got, paged_attention_reference(**b), dtype)
                if dtype == torch.bfloat16:
                    max_err["paged_attention_alibi"] = max(max_err["paged_attention_alibi"], mabs)
                rtol, atol, rel_l2 = PAGED_TOL[dtype]
                G = batch["q"].shape[2] // batch["pool_k_l"].shape[1]
                log(f"[check] paged_attention alibi {label} (G = {G}) {kv or str(dtype)[6:]} pool, "
                    f"{str(dtype)[6:]} q: max_abs {mabs:.3e} max per-query rel L2 {mrel:.3e} tol "
                    f"rtol={rtol} atol={atol} rel_l2={rel_l2} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"paged_attention alibi {label} {kv} {dtype}")
    return failures


# the paged kernel's forms checked by name in phase 2 (bf16 q; fp32 q for the
# forms that take it), and timed in turns with SDPA in phase 7
PAGED_FORMS = ("split", "wgmma", "simt")
PAGED_TURN_ROUNDS = 2


def paged_pools(batch, kv, dtype=torch.bfloat16, alibi=False):
    """``batch`` with q in ``dtype``, its pools in q's dtype (``kv`` None) or as
    int8 / e4m3 codes with scales, and Bloom's slopes with ``alibi``."""
    b = dict(batch if kv is None else quantised_batch(batch, kv), q=batch["q"].to(dtype))
    if kv is None:
        b.update(pool_k_l=batch["pool_k_l"].to(dtype), pool_v_l=batch["pool_v_l"].to(dtype))
    if alibi:
        b["alibi_slopes"] = alibi_slopes(batch["q"].shape[2], batch["q"].device)
    return b


def check_paged_forms(dev, checks, max_err):
    """Phase 2's paged-attention checks by form (``pa_mod._paged_attention_form``):
    every batch of ``checks`` (Llama's and Bloom's decode and prefill, the
    garbage tails), every pool (q's dtype, int8, e4m3), ALiBi on and off,
    forms "split", W and S in bf16 and "split" and S in fp32, each against
    the plain version by PAGED_TOL; forms "split" and W run twice on the
    same inputs must give the same bits."""
    failures = []
    for label, (batch, _) in checks.items():
        for kv in (None, *KV_CODE_DTYPES):
            for alibi in (False, True):
                texts, bad = [], []
                for dtype in (torch.bfloat16, torch.float32):
                    b = paged_pools(batch, kv, dtype, alibi)
                    want = paged_attention_reference(**b)
                    for form in PAGED_FORMS:
                        if not pa_mod.form_takes(form, dtype, b["q"].shape[3], b["block_size"]):
                            continue
                        got = pa_mod._paged_attention_form(form=form, **b)
                        again = (pa_mod._paged_attention_form(form=form, **b)
                                 if form != "simt" else got)
                        torch.cuda.synchronize()
                        ok, mabs, mrel = compare_paged(got, want, dtype)
                        same = torch.equal(got, again)
                        key = ("paged_attention_alibi" if alibi else
                               "paged_attention" if kv is None else "paged_attention_quant")
                        if dtype == torch.bfloat16:
                            max_err[key] = max(max_err[key], mabs)
                        texts.append(f"{form} {str(dtype)[6:]} {mabs:.2e}/{mrel:.2e}"
                                     + ("" if same else " NOT bit-equal"))
                        if not (ok and same):
                            bad.append(f"{form} {dtype}")
                        del got, again
                G = batch["q"].shape[2] // batch["pool_k_l"].shape[1]
                log(f"[check] paged_attention by form{' alibi' if alibi else ''} {label} (G = {G}) "
                    f"{kv or 'q-dtype'} pool (max_abs/max per-query rel L2; tol PAGED_TOL, forms "
                    f"split and W bit-equal over two runs): " + ", ".join(texts)
                    + (f" FAIL {bad}" if bad else " ok"))
                failures += [f"paged_attention form {f} {label} {kv} alibi={alibi}" for f in bad]
    return failures


# ------------------------------------------------------------------ phases
def phase_checks(dev, max_err):
    """Phase 2: each kernel against its plain version. Returns (failures,
    the paged-attention batches reused for timing)."""
    failures = []
    rng = np.random.default_rng(0)
    for rows in (8, 8 * 512, 4099):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(rng.standard_normal((rows, 4096), dtype=np.float32) * 3).to(dev, dtype)
            s = torch.from_numpy(1 + 0.1 * rng.standard_normal(4096, dtype=np.float32)).to(dev, dtype)
            got = rms_norm(x, s, 1e-5)
            torch.cuda.synchronize()
            ok, mabs, mrel = compare_rms(got, rms_norm_reference(x, s, 1e-5), dtype)
            max_err["rms_norm"] = max(max_err["rms_norm"], mabs)
            rtol, atol = RMS_TOL[dtype]
            log(f"[check] rms_norm [{rows}, 4096] {str(dtype)[6:]}: max_abs {mabs:.3e} "
                f"max_rel {mrel:.3e} tol rtol={rtol} atol={atol} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"rms_norm {rows} {dtype}")
    decode_lens = [1, 17, 100, 250, 511, 512, 777, 1000]
    checks = {
        "decode C=1, lens 1-1000": paged_batch(dev, rng, lens=decode_lens, new_lens=[1] * 8),
        "prefill C=512, ragged, pad row": paged_batch(
            dev, rng, lens=[512, 500, 1, 977, 64], new_lens=[512, 300, 0, 77, 64]),
        "garbage block-table tails": paged_batch(
            dev, rng, lens=[5, 40, 300, 16, 1, 129, 64, 999], new_lens=[1, 4, 4, 2, 0, 3, 4, 1],
            garbage_tail=True),
    }
    for label, (batch, lens) in checks.items():
        for dtype in (torch.bfloat16, torch.float32):
            b = dict(batch, **{k: batch[k].to(dtype) for k in ("q", "pool_k_l", "pool_v_l")})
            got = paged_attention(**b)
            torch.cuda.synchronize()
            ok, mabs, mrel = compare_paged(got, paged_attention_reference(**b), dtype)
            if dtype == torch.bfloat16:
                max_err["paged_attention"] = max(max_err["paged_attention"], mabs)
            rtol, atol, rel_l2 = PAGED_TOL[dtype]
            log(f"[check] paged_attention {label} {str(dtype)[6:]}: max_abs {mabs:.3e} max "
                f"per-query rel L2 {mrel:.3e} tol rtol={rtol} atol={atol} rel_l2={rel_l2} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"paged_attention {label} {dtype}")
    failures += check_quantizers(dev, rng)
    for label, (batch, lens) in checks.items():
        for kv in KV_CODE_DTYPES:
            qbatch = quantised_batch(batch, kv)
            for dtype in (torch.bfloat16, torch.float32):
                b = dict(qbatch, q=batch["q"].to(dtype))
                got = paged_attention(**b)
                torch.cuda.synchronize()
                ok, mabs, mrel = compare_paged(got, paged_attention_reference(**b), dtype)
                if dtype == torch.bfloat16:
                    max_err["paged_attention_quant"] = max(max_err["paged_attention_quant"], mabs)
                rtol, atol, rel_l2 = PAGED_TOL[dtype]
                log(f"[check] paged_attention_quant {label} {kv} pool, {str(dtype)[6:]} q: max_abs "
                    f"{mabs:.3e} max per-query rel L2 {mrel:.3e} tol rtol={rtol} atol={atol} "
                    f"rel_l2={rel_l2} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"paged_attention_quant {label} {kv} {dtype}")
    failures += check_paged_alibi(dev, rng, checks, max_err)
    failures += check_paged_forms(dev, checks, max_err)
    flash_sets = [(label, shape, False) for label, shape in FLASH_SETS.items()]
    flash_sets += [(label, shape, True) for label, shape in FLASH_ALIBI_SETS.items()]
    for label, shape, alibi in flash_sets:
        form, suffix = ("flash alibi", "_alibi") if alibi else ("flash", "")
        G = shape["H"] // shape["kvH"]
        for dtype in (torch.bfloat16, torch.float32):
            ok, readings, lse_err = check_flash(dev, shape, dtype, alibi)
            if dtype == torch.bfloat16:
                for kernel, parts in (("flash_fwd", ("out",)), ("flash_bwd_dq", ("dq",)),
                                      ("flash_bwd_dkv", ("dk", "dv"))):
                    key = kernel + suffix
                    max_err[key] = max([max_err[key]] + [readings[p][1] for p in parts])
            text = ", ".join(f"{n} {r:.3e} (max_abs {a:.3e})" for n, (r, a) in readings.items())
            lse_text = (f"lse max error / max(|lse|, 10) {lse_err:.3e}; tol {FLASH_TOL[dtype]} / "
                        f"lse {LSE_ALIBI_REL} of max(|lse|, 10)" if alibi else
                        f"lse max_abs {lse_err:.3e}; tol {FLASH_TOL[dtype]} / lse {LSE_TOL}")
            log(f"[check] {form} {label} (G = {G}) {str(dtype)[6:]}: row rel L2 {text}; "
                f"{lse_text} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{form} {label} {dtype}")
            torch.cuda.empty_cache()
    failures += check_flash_forms(dev, max_err)
    failures += check_flash_bwd_forms(dev, max_err)
    for label, shape in SPARSE_SETS.items():
        for dtype in (torch.bfloat16, torch.float32):
            ok, readings, lse_err = check_sparse(dev, shape, dtype)
            if dtype == torch.bfloat16:
                for kernel, parts in (("sparse_fwd", ("out",)), ("sparse_bwd_dq", ("dq",)),
                                      ("sparse_bwd_dkv", ("dk", "dv"))):
                    max_err[kernel] = max([max_err[kernel]] + [readings[p][1] for p in parts])
            text = ", ".join(f"{n} {r:.3e} (max_abs {a:.3e})" for n, (r, a) in readings.items())
            log(f"[check] sparse {label} {str(dtype)[6:]}: row rel L2 {text}; lse max_abs "
                f"{lse_err:.3e}; tol {FLASH_TOL[dtype]} / lse {LSE_TOL}, empty rows exact "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"sparse {label} {dtype}")
            torch.cuda.empty_cache()
    failures += check_grouped(dev, max_err)
    return failures, checks


def check_grouped(dev, max_err):
    """Phase 2's grouped-GEMM checks, every form through
    ``_grouped_matmul_form``: form
    P, the mma.sync form and the SIMT form (fp32, TF32 off) at
    Mixtral-8x7B's up and down projections on group sizes from top-2 routing
    of 4096 random tokens (a prefill) and of 16 (a 16-row decode forward: 32
    routed rows) and on the skewed set; form D on the 16-token set and on
    ``GMM_DECODE_SKEWED``; the TMA forms' edge set; the mma.sync form and SIMT at
    K, N not multiples of 8 with rows past the sizes' sum. Each held by
    ``GMM_TOL``, rows past the sum exactly 0."""
    sets = {"routed 4096 tokens top-2": ((routed_group_sizes(4096), None), ("wgmma", "mma")),
            "routed 16 tokens top-2": ((routed_group_sizes(16), None), ("wgmma", "stream", "mma")),
            "skewed": ((GMM_SKEWED_SIZES, None), ("wgmma", "mma")),
            "decode skewed": (GMM_DECODE_SKEWED, ("wgmma", "stream", "mma"))}
    cases = [(f"{proj} {label}", sizes, rows, K, N, forms)
             for proj, (K, N) in GMM_SHAPES.items()
             for label, ((sizes, rows), forms) in sets.items()]
    cases.append(("tma edges", *GMM_TMA_EDGE, ("wgmma", "stream", "mma")))
    cases.append(("edges", *GMM_EDGE, ("mma",)))
    failures = []
    for label, sizes, rows, K, N, forms in cases:
        for dtype in (torch.bfloat16, torch.float32):
            lhs, rhs, gs = grouped_inputs(dev, sizes, K, N, dtype, rows=rows)
            picked = gmm_mod.pick_form(dtype, lhs.shape[0], K, N, True)
            for form in forms if dtype == torch.bfloat16 else ("simt",):
                ok, mabs, share = check_grouped_matmul(lhs, rhs, gs, form=form)
                if dtype == torch.bfloat16:
                    max_err["grouped_matmul"] = max(max_err["grouped_matmul"], mabs)
                rtol, atol = GMM_TOL[dtype]
                log(f"[check] grouped_matmul {label} sizes {list(sizes)}: [{lhs.shape[0]}, {K}] x "
                    f"[{len(sizes)}, {K}, {N}] {str(dtype)[6:]} form {form} (the wrapper picks "
                    f"{picked}): max_abs {mabs:.3e}, largest error / "
                    f"bound {share:.3f}; tol rtol={rtol} atol={atol} x RMS {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"grouped_matmul {label} {dtype} {form}")
            del lhs, rhs, gs
            torch.cuda.empty_cache()
    return failures


def compare_grads(got, want, dtype):
    """A gradient against the plain version's: RMS_TOL with the absolute
    part scaled by the largest |want| (dscale and dbias are sums over every
    row). Returns (ok, max abs error)."""
    rtol, atol = RMS_TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = max(1.0, float(w.abs().max()))
    ok = bool(torch.isfinite(g).all()) and bool((err <= atol * scale + rtol * w.abs()).all())
    return ok, float(err.max())


def phase_ops(dev, max_err, results):
    """Phase 2b: the public op entry point on CUDA tensors. Prints the op
    registry; then, with the counters zeroed just before and read just
    after, calls ``ops.layer_norm`` and ``ops.dispatch("layer_norm",
    "auto")`` (with a backward through autograd) on every ``LN_SETS`` shape:
    one kernel launch per call, the plain version never called on a CUDA
    tensor. Outputs and gradients are then held to the plain version's
    (``layer_norm_reference`` and autograd through it). Returns the launch
    counts, or None on failure."""
    for name, impls in torch_ops.op_report().items():
        log(f"[ops] op {name}: {', '.join(impls)}; auto -> "
            f"{torch_ops.dispatch(name, 'auto').__name__}")
    rng = np.random.default_rng(7)
    cases = []
    for label, (rows, dim, dtypes) in LN_SETS.items():
        for dtype in dtypes:
            x = rng.standard_normal((rows, dim), dtype=np.float32) * 3 + 1
            s = 1 + 0.1 * rng.standard_normal(dim, dtype=np.float32)
            b = 0.1 * rng.standard_normal(dim, dtype=np.float32)
            g = rng.standard_normal((rows, dim), dtype=np.float32)
            cases.append((label, dtype, *(torch.from_numpy(a).to(dev, dtype) for a in (x, s, b, g))))
    plain_calls = []
    real_plain = norms_mod.layer_norm_reference

    def spy(x, *a, **k):
        if x.is_cuda:
            plain_calls.append(1)
        return real_plain(x, *a, **k)

    outs, calls = [], 0
    zero_counts()
    with mock.patch.object(norms_mod, "layer_norm_reference", spy):
        for label, dtype, x, s, b, g in cases:
            y = torch_ops.layer_norm(x, s, b, 1e-5)
            leaves = [t.detach().requires_grad_(True) for t in (x, s, b)]
            y2 = torch_ops.dispatch("layer_norm", "auto")(*leaves, 1e-5)
            y2.backward(g)
            calls += 2
            outs.append((y, y2.detach(), [t.grad for t in leaves]))
        torch.cuda.synchronize()
    launches = launch_counts()
    expect = dict({k: 0 for k in launches}, layer_norm=calls)
    log(f"[ops] {calls} calls of ops.layer_norm / dispatch('layer_norm', 'auto'): launches "
        f"{launches['layer_norm']} (expected {calls}, every other kernel 0); plain version "
        f"called {len(plain_calls)} times on CUDA tensors")
    if launches != expect or plain_calls:
        log("[ops] FAILED: the op did not launch its kernel once per call, or ran the plain version")
        return None
    failures = []
    for (label, dtype, x, s, b, g), (y, y2, grads) in zip(cases, outs):
        leaves = [t.detach().requires_grad_(True) for t in (x, s, b)]
        want = real_plain(*leaves, 1e-5)
        want.backward(g)
        ok, mabs, mrel = compare_rms(y, want.detach(), dtype)
        ok2, mabs2, _ = compare_rms(y2, want.detach(), dtype)
        gres = [compare_grads(gt, t.grad, dtype) for gt, t in zip(grads, leaves)]
        if dtype == torch.bfloat16:
            max_err["layer_norm"] = max(max_err["layer_norm"], mabs, mabs2)
        rtol, atol = RMS_TOL[dtype]
        good = ok and ok2 and all(r[0] for r in gres)
        log(f"[check] layer_norm {label} {list(x.shape)} {str(dtype)[6:]}: max_abs {mabs:.3e} "
            f"(dispatch {mabs2:.3e}) max_rel {mrel:.3e}; grads dx/dscale/dbias max_abs "
            f"{' / '.join(f'{r[1]:.3e}' for r in gres)}; tol rtol={rtol} atol={atol} (grads: atol "
            f"x max|want|) {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(f"layer_norm {label} {dtype}")
    results["ops"] = {"op_report": torch_ops.op_report(), "calls": calls, "launches": launches,
                      "max_abs_err_bf16": max_err["layer_norm"]}
    if failures:
        log(f"[ops] FAILED: {failures}")
        return None
    return launches


SERVE_CONFIG = {"dtype": "bf16", "kv_block_size": 16, "kv_pool_bytes": KV_POOL_BYTES,
                "max_seq_len": 2048, "decode_chain": 8}


def serve_prompts(cfg):
    """The serving cell's 8 prompts (numpy seed 1): 32, 1000 and 6 lengths
    drawn from [32, 1000]."""
    prng = np.random.default_rng(1)
    plens = [32, 1000] + [int(n) for n in prng.integers(32, 1001, 6)]
    return plens, [prng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in plens]


def timed_generate(engine, prompts, max_new_tokens=64):
    """``engine.generate`` with the host time of its prefill steps and decode
    chains (each ending in a synchronise). Returns (outputs, wall s, spans,
    peak GB)."""
    spans = {"prefill": 0.0, "decode": 0.0}

    def timed(fn, key):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[key] += time.perf_counter() - t
            return out
        return wrapper

    engine._put_sample = timed(engine._put_sample, "prefill")
    engine.decode_chain = timed(engine.decode_chain, "decode")
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=max_new_tokens)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, spans, torch.cuda.max_memory_allocated() / 1e9


def shared_routing(routing, plain):
    """A stand-in for ``inference.model._route``. The kernels' run appends each
    layer's expert choices ``top_i`` to ``routing["recorded"]``; the plain
    run takes them in the same order in place of its own, so that both runs
    send each token to the same experts, and gates them with its own
    probabilities at those experts, renormalised as ``_route`` does. It
    counts the decisions its own routing would have made otherwise, with the
    largest margin between its k-th and (k+1)-th expert probabilities among
    them."""
    real_route = model_mod._route

    def route(lp, cfg, tokens):
        probs, top_p, top_i = real_route(lp, cfg, tokens)
        if not plain:
            routing["recorded"].append(top_i)
            return probs, top_p, top_i
        shared_i = routing["recorded"][routing["replayed"]]
        routing["replayed"] += 1
        top_p = probs.gather(1, shared_i)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        flip = (top_i.sort(-1).values != shared_i.sort(-1).values).any(-1)
        ranked = probs.sort(-1, descending=True).values
        margin = ranked[:, cfg.moe_top_k - 1] - ranked[:, cfg.moe_top_k]
        routing["decisions"] += flip.numel()
        routing["flips"] += int(flip.sum())
        if bool(flip.any()):
            routing["max_flip_margin"] = max(routing["max_flip_margin"], float(margin[flip].max()))
        return probs, top_p, shared_i

    return mock.patch.object(model_mod, "_route", route)


def prefill_step_logits(dev, cfg, params, prompts, plain, kv_quant=None, routing=None):
    """Last-token logits [3, V] of one ragged prefill step (200, 32 and 77
    tokens) on a fresh 64-block pool, through the kernels or, with ``plain``,
    through the plain versions (which must launch nothing). An MoE model's
    two runs share their routing through ``routing`` (``shared_routing``)."""
    bs = 16
    P = 2048 // bs
    pool = init_pool(cfg, 64, bs, torch.bfloat16, dev, kv_quant=kv_quant)
    b = build_ragged_batch(StateManager(64, bs, max_blocks_per_seq=P), [0, 1, 2],
                           [prompts[1][:200], prompts[0], prompts[2][:77]], P,
                           row_bucket=8, chunk_bucket=16)
    arrs = [torch.from_numpy(a).to(dev) for a in (b.tokens, b.positions, b.new_lens, b.block_tables)]
    routes = shared_routing(routing, plain) if routing is not None else contextlib.nullcontext()
    if not plain:
        with routes:
            return ragged_forward(params, cfg, pool, *arrs, bs)[0][:3].float()
    before = launch_counts()
    with routes, mock.patch.object(transformer_mod, "pallas_rms_norm", rms_norm_reference), \
            mock.patch.object(paged_mod, "pallas_paged_attention", paged_attention_reference), \
            mock.patch.object(woq_mod, "pallas_dequantize_int8",
                              quant_mod.dequantize_int8_reference), \
            mock.patch.object(model_mod, "grouped_matmul", gmm_mod.grouped_matmul_plain):
        out = ragged_forward(params, cfg, pool, *arrs, bs)[0][:3].float()
    if launch_counts() != before:
        raise RuntimeError("the plain run launched a kernel")
    return out


def check_prefill_logits(tag, dev, cfg, params, prompts, results, kv_quant=None):
    """Prefill-step logits through the kernels against the plain versions;
    returns the kernels' logits, or None when they disagree. An MoE model's
    plain run takes the kernels' run's expert choices (a near tie decided
    the other way by rounding would move a token's whole FFN output), and
    each choice its own routing would have made otherwise must be a near
    tie: a margin of at most ``MOE_FLIP_MARGIN``."""
    routing = (dict(recorded=[], replayed=0, decisions=0, flips=0, max_flip_margin=0.0)
               if cfg.num_experts else None)
    logits = {mode: prefill_step_logits(dev, cfg, params, prompts, mode == "plain", kv_quant,
                                        routing)
              for mode in ("kernels", "plain")}
    if routing is not None:
        shared = routing["replayed"] == len(routing["recorded"]) > 0
        results.update(routing_decisions=routing["decisions"], routing_flips=routing["flips"],
                       routing_max_flip_margin=routing["max_flip_margin"])
        log(f"[{tag}] routing shared by the plain run over {routing['replayed']} layer calls: its "
            f"own routing chose other experts for {routing['flips']} of {routing['decisions']} "
            f"tokens x layers, at a largest top-{cfg.moe_top_k} margin of "
            f"{routing['max_flip_margin']:.3e} (bound {MOE_FLIP_MARGIN})")
        if not shared or routing["max_flip_margin"] > MOE_FLIP_MARGIN:
            log(f"[{tag}] FAILED: the routing was not shared, or differed beyond a near tie")
            return None
    diff = logits["kernels"] - logits["plain"]
    rel = float(diff.norm() / logits["plain"].norm())
    same = logits["kernels"].argmax(-1) == logits["plain"].argmax(-1)
    agree = float(same.float().mean())
    # a row whose top-2 margin in the plain logits exceeds twice its largest
    # |kernels - plain| difference cannot change its argmax: each must agree
    top2 = logits["plain"].topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * diff.abs().amax(-1)
    log(f"[{tag}] prefill-step logits, kernels vs plain: rel L2 {rel:.3e} (bound {LOGITS_REL_L2}), "
        f"max_abs {float(diff.abs().max()):.3e}, argmax agreement {agree:.2f} (required on the "
        f"{int(decided.sum())} of {len(same)} rows whose top-2 margin exceeds twice their largest "
        f"difference)")
    results["logits_rel_l2"], results["logits_argmax_agreement"] = rel, agree
    if not (math.isfinite(rel) and rel <= LOGITS_REL_L2) or not bool(same[decided].all()):
        log(f"[{tag}] FAILED: prefill logits disagree with the plain versions")
        return None
    return logits["kernels"]


def profile_chain(tag, engine, prompts):
    """One decode chain (a row per prompt x 8 steps, after a prefill of ``prompts``)
    under the profiler, after the counted run: (``log_profile``'s record,
    the device time by kernel), or None when the profiler saw no device
    time."""
    uids = list(range(len(prompts)))
    engine.put(uids, prompts)
    prof = device_profile(lambda: engine.decode_chain(uids, [0] * len(uids), [8] * len(uids), 8))
    for u in uids:
        engine.flush(u)
    if prof[1] <= 0:
        log(f"[{tag}] FAILED: the profiler saw no device time in the decode chain")
        return None
    return log_profile(tag, f"decode chain ({len(uids)} rows x 8 steps)", *prof), prof[3]


@contextlib.contextmanager
def paged_path(shapes, plain_calls):
    """While active, each forward's tokens shape (N, C) is appended to
    ``shapes`` (``inference.paged._forward_hidden``) and each call of the
    plain paged attention to ``plain_calls``."""
    real_forward, real_plain = paged_mod._forward_hidden, pa_mod.paged_attention_reference

    def record(params_, cfg_, pool, tokens, *a, **k):
        shapes.append(tuple(tokens.shape))
        return real_forward(params_, cfg_, pool, tokens, *a, **k)

    def spy(*a, **k):
        plain_calls.append(1)
        return real_plain(*a, **k)

    with mock.patch.object(paged_mod, "_forward_hidden", record), \
            mock.patch.object(pa_mod, "paged_attention_reference", spy):
        yield


def paged_forms_of_run(tag, cfg, shapes, plain_calls):
    """The paged kernel's launches by form that a run of forwards ``shapes``
    must show, beside what it showed: every decode forward (C == 1) through
    form "split", every prefill forward (C > 1) through form W, L launches a
    forward, the plain version never called. Returns (ok, record)."""
    G, hd, bs = cfg.num_heads // cfg.kv_heads, cfg.dims_per_head, SERVE_CONFIG["kv_block_size"]
    want = dict.fromkeys(pa_mod.PAGED_FORMS, 0)
    off = []
    for N, C in shapes:
        form = pa_mod.paged_form(cfg.dtype, hd, C, G, bs)
        want[form] += cfg.num_layers
        if form != ("split" if C == 1 else "wgmma"):
            off.append((N, C, form))
    got = {f: paged_attention.launches_by_form[f] + paged_attention_quant.launches_by_form[f]
           for f in pa_mod.PAGED_FORMS}
    decode = sum(1 for _, C in shapes if C == 1)
    ok = got == want and not off and not plain_calls and 0 < decode < len(shapes)
    log(f"[{tag}] paged attention by form: {got} (expected {want}: {decode} decode forwards "
        f"through form split, {len(shapes) - decode} prefill forwards through form W); plain "
        f"paged attention called {len(plain_calls)} times{'' if not off else f'; OFF FORM {off}'}"
        f"{'' if ok else ' FAILED'}")
    return ok, {"paged_launches_by_form": got, "decode_forwards": decode,
                "prefill_forwards": len(shapes) - decode}


def paged_ms(rows):
    """Device ms of the paged kernel's forms in a profile's rows, by kernel."""
    names = {"split": "paged_split_kernel", "wgmma": "paged_wgmma_kernel",
             "simt": "paged_attention_kernel"}
    return {form: sum(ms for ms, _, name in rows if f"{kernel}<" in name or f"{kernel}(" in name)
            for form, kernel in names.items()}


def profile_paged(tag, engine, prompts, results):
    """A decode chain (``profile_chain``) and the prefill of ``prompts`` under
    the profiler: the paged kernel's device ms by form and its share of each
    one's device time, into ``results``. Returns None when the profiler saw
    no device time, else the decode chain's rows."""
    prof = profile_chain(tag, engine, prompts)
    if prof is None:
        return None
    results["profile_decode_chain"], rows = prof
    uids = list(range(len(prompts)))
    pre = device_profile(lambda: engine.put(uids, prompts))
    for u in uids:
        engine.flush(u)
    if pre[1] <= 0:
        log(f"[{tag}] FAILED: the profiler saw no device time in the prefill")
        return None
    results["profile_prefill"] = log_profile(tag, f"prefill of {len(prompts)} prompts", *pre)
    for what, rec, rws in (("decode chain", results["profile_decode_chain"], rows),
                           ("prefill", results["profile_prefill"], pre[3])):
        by_form = paged_ms(rws)
        busy = rec["device_busy_ms"]
        rec["paged_ms_by_form"], rec["paged_share_of_device_time"] = by_form, sum(by_form.values()) / busy
        log(f"[{tag}] paged attention in the {what}: {sum(by_form.values()):.3f} ms of {busy:.2f} ms "
            f"device time ({100 * sum(by_form.values()) / busy:.1f} %), by form {by_form}")
    return rows


def woq_reads(engine):
    """(quantised leaves, dequantiser launches a forward) of an engine's
    weights: a stacked leaf is read once per layer. Ints only, so the
    engine's codes die with it."""
    reads = [x.shape[0] if x.stacked else 1 for _, x in woq_mod._leaves(engine.params)
             if isinstance(x, woq_mod.WOQTensor)]
    return len(reads), sum(reads)


def phase_serve(dev, cfg, params, results):
    """Phase 3: Llama-3-8B through InferenceEngineV2.generate. Returns the
    launch counts of the counted run, the outputs and the prefill-step logits
    (the quantised engines' yardstick), or None on failure."""
    engine = InferenceEngineV2(cfg, params, SERVE_CONFIG, device=dev)
    log(f"[serve] KV pool: {engine.pool.k.numel() * 2 * 2 / 2 ** 30:.3f} GiB, "
        f"{engine.num_kv_blocks} blocks ({engine.kv_bytes_per_token} B/token)")
    plens, prompts = serve_prompts(cfg)
    # warm-up (cuBLAS and allocator first calls), so that this engine's times
    # compare with the quantised engines' that follow
    engine.generate(prompts, max_new_tokens=2)
    engine.dispatch_count = engine.host_sync_count = engine.tokens_decoded = 0
    engine.chain_steps = engine.model_forwards = 0
    torch.cuda.reset_peak_memory_stats()
    shapes, plain_calls = [], []
    zero_counts()
    with paged_path(shapes, plain_calls):
        outs, wall, spans, peak_gb = timed_generate(engine, prompts)
    launches = launch_counts()
    forms_ok, forms = paged_forms_of_run("serve", cfg, shapes, plain_calls)
    forwards = engine.model_forwards
    expect = dict({k: 0 for k in launches}, rms_norm=(2 * cfg.num_layers + 1) * forwards,
                  paged_attention=cfg.num_layers * forwards)
    log(f"[serve] prompts {plens}; {forwards} forwards, {engine.dispatch_count} dispatches, "
        f"{engine.host_sync_count} host syncs, launches {launches} (expected {expect})")
    if any(len(o) != 64 or o.min() < 0 or o.max() >= cfg.vocab_size for o in outs):
        log(f"[serve] FAILED: outputs {[(len(o), int(o.min()), int(o.max())) for o in outs]}")
        return None
    if (launches != expect or min(launches["rms_norm"], launches["paged_attention"]) == 0
            or not forms_ok):
        log("[serve] FAILED: kernel launch counts do not match the forwards run")
        return None
    prefill_tokens = sum(plens)
    results["serve"] = {
        "prompt_lens": plens, "forwards": forwards, "launches": launches, "wall_s": wall, **forms,
        "prefill_s": spans["prefill"], "decode_s": spans["decode"],
        "prefill_tok_s": prefill_tokens / spans["prefill"],
        "decode_tok_s": engine.tokens_decoded / spans["decode"],
        "tokens_decoded": engine.tokens_decoded, "peak_mem_gb": peak_gb,
        "kv_bytes_per_token": engine.kv_bytes_per_token, "kv_blocks": engine.num_kv_blocks,
        "first_tokens": [o[:8].tolist() for o in outs[:2]],
    }
    log(f"[serve] generate {wall:.2f} s: prefill {prefill_tokens} tokens in "
        f"{spans['prefill']:.3f} s ({prefill_tokens / spans['prefill']:.1f} tok/s), decode "
        f"{engine.tokens_decoded} tokens in {spans['decode']:.3f} s "
        f"({engine.tokens_decoded / spans['decode']:.1f} tok/s), peak memory {peak_gb:.2f} GB")

    logits = check_prefill_logits("serve", dev, cfg, engine.params, prompts, results["serve"])
    if logits is None:
        return None

    # where a decode chain's and a prefill's time goes (after the counted run)
    prof = {}
    if profile_paged("profile", engine, prompts, prof) is None:
        return None
    results["profile_decode_chain"], results["profile_prefill"] = (
        prof["profile_decode_chain"], prof["profile_prefill"])
    return launches, outs, logits


# (tag, engine settings beside SERVE_CONFIG) of the quantised serving phase
QUANT_ENGINES = {
    "quant int8 kv + woq int8": {"kv_cache_dtype": "int8", "quant": {"enabled": True, "bits": 8}},
    "quant fp8 kv": {"kv_cache_dtype": "fp8"},
}


def phase_quant_serve(dev, cfg, params, bf16_outs, bf16_logits, results):
    """Phase 3b: the quantised engines on phase 3's weights and prompts, each
    built and run with the counters zeroed just before and read just after.
    Returns {tag: launch counts} of the counted runs, or None on failure."""
    plens, prompts = serve_prompts(cfg)
    by_path = {}
    for tag, over in QUANT_ENGINES.items():
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        engine = InferenceEngineV2(cfg, params, dict(SERVE_CONFIG, **over), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        shapes, plain_calls = [], []
        with paged_path(shapes, plain_calls):
            outs, wall, spans, peak_gb = timed_generate(engine, prompts)
        launches = launch_counts()
        forms_ok, forms = paged_forms_of_run(tag, cfg, shapes, plain_calls)
        forwards = engine.model_forwards
        woq = engine.config.quant.enabled
        n_leaves, per_forward = woq_reads(engine)
        expect = dict({k: 0 for k in launches}, rms_norm=(2 * cfg.num_layers + 1) * forwards,
                      paged_attention_quant=cfg.num_layers * forwards,
                      dequantize_int8=per_forward * forwards, quantize_int8=per_forward)
        weight_bytes = woq_mod.woq_bytes(engine.params)
        log(f"[{tag}] init {init_s:.2f} s ({n_leaves} quantised leaves); {forwards} forwards, "
            f"launches {launches} (expected {expect}, {per_forward} dequantiser launches "
            f"per forward)")
        if any(len(o) != 64 or o.min() < 0 or o.max() >= cfg.vocab_size for o in outs):
            log(f"[{tag}] FAILED: outputs {[(len(o), int(o.min()), int(o.max())) for o in outs]}")
            return None
        if launches != expect or launches["paged_attention_quant"] == 0 or not forms_ok or (
                woq and min(launches["quantize_int8"], launches["dequantize_int8"]) == 0):
            log(f"[{tag}] FAILED: kernel launch counts do not match the forwards run")
            return None
        prefill_tokens = sum(plens)
        agree = float(np.mean(np.concatenate([a == b for a, b in zip(outs, bf16_outs)])))
        same_first = sum(int(a[0] == b[0]) for a, b in zip(outs, bf16_outs))
        r = results[tag] = {
            "kv_cache_dtype": engine.config.kv_dtype_name, "woq": woq, "init_s": init_s,
            "forwards": forwards, "launches": launches, "wall_s": wall,
            "prefill_s": spans["prefill"], "decode_s": spans["decode"],
            "prefill_tok_s": prefill_tokens / spans["prefill"],
            "decode_tok_s": engine.tokens_decoded / spans["decode"],
            "tokens_decoded": engine.tokens_decoded, "peak_mem_gb": peak_gb,
            "weight_bytes": weight_bytes, "kv_bytes_per_token": engine.kv_bytes_per_token,
            "kv_blocks": engine.num_kv_blocks,
            "kv_pool_gib": sum(t.numel() * t.element_size() for t in (
                engine.pool.k, engine.pool.v, engine.pool.k_scale, engine.pool.v_scale)) / 2 ** 30,
            "greedy_agreement_with_bf16": agree, "same_first_token_as_bf16": same_first, **forms,
        }
        log(f"[{tag}] generate {wall:.2f} s: prefill {prefill_tokens / spans['prefill']:.1f} tok/s, "
            f"decode {engine.tokens_decoded / spans['decode']:.1f} tok/s, peak memory "
            f"{peak_gb:.2f} GB; weights {weight_bytes / 1e9:.3f} GB; KV {engine.kv_bytes_per_token} "
            f"B/token, {engine.num_kv_blocks} blocks in {r['kv_pool_gib']:.3f} GiB "
            f"({engine.num_kv_blocks / results['serve']['kv_blocks']:.3f}x bf16's); greedy tokens "
            f"equal to the bf16 engine's {100 * agree:.1f} % (first token {same_first}/8)")
        logits = check_prefill_logits(tag, dev, cfg, engine.params, prompts, r,
                                      kv_quant=engine.config.kv_quant)
        if logits is None:
            return None
        drift = float((logits - bf16_logits).norm() / bf16_logits.norm())
        top = float((logits.argmax(-1) == bf16_logits.argmax(-1)).float().mean())
        r["drift_vs_bf16_rel_l2"], r["argmax_agreement_vs_bf16"] = drift, top
        log(f"[{tag}] prefill-step logits against the bf16 engine's: rel L2 {drift:.3e}, argmax "
            f"agreement {top:.2f} (random weights: printed, not held)")
        if woq:
            prof = profile_chain(tag, engine, prompts)
            if prof is None:
                return None
            r["profile_decode_chain"], rows = prof
            busy = prof[0]["device_busy_ms"]
            dequant_ms = sum(ms for ms, _, name in rows if "dequant_kernel" in name)
            r["dequant_share_of_device_time"] = dequant_ms / busy
            log(f"[{tag}] dequantiser: {dequant_ms:.2f} ms of {busy:.2f} ms device time "
                f"({100 * dequant_ms / busy:.1f} %) in the decode chain")
        by_path[tag] = launches
        del engine
        gc.collect()  # the timing wrappers hold the engine in a reference cycle
        torch.cuda.empty_cache()

    # the stochastic kernel's entry point: the public op, once, at the w_up shape
    x = params["layers"]["mlp"]["w_up"]["kernel"][0]
    zero_counts()
    q, s = quant_mod.quantize_int8(x, stochastic=True, seed=1)
    torch.cuda.synchronize()
    by_path["quantize_int8 stochastic"] = launches = launch_counts()
    log(f"[quant] quantize_int8(w_up layer 0 {tuple(x.shape)}, stochastic=True): codes "
        f"{tuple(q.shape)} in [{int(q.min())}, {int(q.max())}], {s.numel()} scales; launches "
        f"{launches}")
    if launches != dict({k: 0 for k in launches}, quantize_int8_stochastic=1):
        log("[quant] FAILED: the stochastic quantiser was not launched once")
        return None
    return by_path


# bigscience/bloom-7b1's public config (vocab_size 250880, hidden_size 4096,
# n_layer 30, n_head 32, layer_norm_epsilon 1e-5), mapped as
# deepspeed_tpu/checkpoint/hf.py:231-248 maps model_type "bloom": FFN 4 x
# hidden, LayerNorm, tanh GELU, ALiBi, q/k/v/dense/MLP biases, embedding
# LayerNorm, tied head, kv heads = heads; max_seq_len hf.py's default 2048
BLOOM_7B1 = dict(vocab_size=250880, hidden_size=4096, intermediate_size=4 * 4096, num_layers=30,
                 num_heads=32, max_seq_len=2048, norm="layernorm", activation="gelu",
                 position="alibi", norm_eps=1e-5, qkv_bias=True, dense_bias=True,
                 embed_norm=True, tie_embeddings=True)
# bigscience/bloom-560m's public config (vocab_size 250880, hidden_size 1024,
# n_layer 24, n_head 16: head dim 64, layer_norm_epsilon 1e-5), mapped the
# same way; max_seq_len 2048, Bloom's pretraining length
BLOOM_560M = dict(vocab_size=250880, hidden_size=1024, intermediate_size=4 * 1024, num_layers=24,
                  num_heads=16, max_seq_len=2048, norm="layernorm", activation="gelu",
                  position="alibi", norm_eps=1e-5, qkv_bias=True, dense_bias=True,
                  embed_norm=True, tie_embeddings=True)
# (tag, engine settings beside SERVE_CONFIG) of the Bloom serving phase
BLOOM_ENGINES = {
    "bloom-7b1 bf16": {},
    "bloom-7b1 int8 kv + woq int8": QUANT_ENGINES["quant int8 kv + woq int8"],
    "bloom-7b1 fp8 kv": QUANT_ENGINES["quant fp8 kv"],
}


def bloom_params(cfg, device, dtype=torch.bfloat16, seed=0):
    """Random weights in ``dtype`` from ``seed``, then every bias, LayerNorm
    scale and LayerNorm bias redrawn from ``seed + 1`` (scales 1 + 0.1 n,
    biases 0.1 n): init makes them 1 and 0, which would hide a bias or a norm
    parameter the forward dropped."""
    params = init_params(cfg, seed=seed, device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    for path, t in flatten(params).items():
        if path.endswith(".bias"):
            t.normal_(0.0, 0.1, generator=gen)
        elif path.endswith(".scale"):
            t.normal_(1.0, 0.1, generator=gen)
    return params


def bloom_layer_norm_ab(tag, dev, cfg, engine, prompts, logits, r):
    """A measurement, no switch of the package: the model's LayerNorm
    (``models/transformer.py:layer_norm``, plain PyTorch) replaced by the
    op's "pallas" impl ``pallas_layer_norm`` (the kernel, called directly as
    the model calls ``pallas_rms_norm``) for one prefill step, held to
    the unreplaced run's logits by LOGITS_REL_L2 with 2L + 2 = 62 launches
    per forward (the embedding norm, two a layer, the final norm), and for
    a profiled decode chain, which runs beside the unreplaced chain profiled
    just before and once more after. Returns False on failure."""

    def op_norm(x, scale, bias, eps, dtype):
        return pallas_layer_norm(x, scale, bias, eps).to(dtype)

    per_forward = 2 * cfg.num_layers + 2
    zero_counts()
    with mock.patch.object(transformer_mod, "layer_norm", op_norm):
        ab_logits = prefill_step_logits(dev, cfg, engine.params, prompts, plain=False)
        prefill_launches = launch_counts()["layer_norm"]
        zero_counts()
        forwards0 = engine.model_forwards
        prof = profile_chain(f"{tag} layer_norm op", engine, prompts)
        chain_forwards = engine.model_forwards - forwards0
        chain_launches = launch_counts()["layer_norm"]
    rel = float((ab_logits - logits).norm() / logits.norm())
    log(f"[{tag} layer_norm op] prefill-step logits against the plain LayerNorm's: rel L2 "
        f"{rel:.3e} (bound {LOGITS_REL_L2}); layer_norm launches {prefill_launches} for one "
        f"forward (expected {per_forward}), {chain_launches} over the chain's {chain_forwards} "
        f"forwards (expected {per_forward * chain_forwards})")
    if prof is None:
        return False
    again = profile_chain(f"{tag} again", engine, prompts)
    if again is None:
        return False
    ln_ms = sum(ms for ms, _, name in prof[1] if "layer_norm_kernel" in name)
    r["layer_norm_op_ab"] = {
        "logits_rel_l2": rel, "launches_per_forward": prefill_launches,
        "chain_forwards": chain_forwards, "chain_launches": chain_launches,
        "profile_decode_chain_layer_norm_op": prof[0], "layer_norm_kernel_ms": ln_ms,
        "profile_decode_chain_plain_again": again[0]}
    for name, rec in (("plain LayerNorm", r["profile_decode_chain"]),
                      ("ops.layer_norm", prof[0]), ("plain LayerNorm, again", again[0])):
        log(f"[{tag} layer_norm op] chain with {name}: unprofiled wall "
            f"{rec['unprofiled_wall_ms']:.2f} ms, profiled wall {rec['wall_ms']:.2f} ms, device "
            f"kernels {rec['device_busy_ms']:.2f} ms, idle "
            f"{100 * (1 - rec['device_busy_ms'] / rec['wall_ms']):.1f} %")
    log(f"[{tag} layer_norm op] the LayerNorm kernel: {ln_ms:.3f} ms of the chain's device time")
    if not (math.isfinite(rel) and rel <= LOGITS_REL_L2) or prefill_launches != per_forward \
            or chain_launches != per_forward * chain_forwards or chain_forwards == 0:
        log(f"[{tag} layer_norm op] FAILED: logits or launch counts off")
        return False
    return True


def phase_bloom_serve(dev, results):
    """Phase 3c: Bloom-7B1 at full width and depth through
    InferenceEngineV2.generate, over a bf16 pool, an int8 pool with int8 WOQ
    and an e4m3 pool, each engine built with the counters zeroed just before
    and read just after (WOQ's quantiser launches), warmed up, then run with
    the counters zeroed just before and read just after: 30 ALiBi launches of
    the paged kernel per forward, the plain version never called. Returns
    {tag: launch counts} of the counted runs, or None on failure."""
    cfg = TransformerConfig(**BLOOM_7B1, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = bloom_params(cfg, dev)
    torch.cuda.synchronize()
    log(f"[bloom] init bloom-7b1: {cfg.num_params() / 1e9:.3f} B params (JAX count), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated in {time.perf_counter() - t0:.1f} s")
    plens, prompts = serve_prompts(cfg)
    by_path, bf16 = {}, None
    for tag, over in BLOOM_ENGINES.items():
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        engine = InferenceEngineV2(cfg, params, dict(SERVE_CONFIG, **over), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_launches = launch_counts()
        engine.generate(prompts, max_new_tokens=2)  # warm-up: cuBLAS and allocator first calls
        engine.dispatch_count = engine.host_sync_count = engine.tokens_decoded = 0
        engine.chain_steps = engine.model_forwards = 0
        shapes, plain_calls = [], []
        zero_counts()
        with paged_path(shapes, plain_calls):
            outs, wall, spans, peak_gb = timed_generate(engine, prompts)
        launches = launch_counts()
        forms_ok, forms = paged_forms_of_run(tag, cfg, shapes, plain_calls)
        forwards = engine.model_forwards
        n_leaves, per_forward = woq_reads(engine)
        expect = dict({k: 0 for k in launches}, paged_attention_alibi=cfg.num_layers * forwards,
                      dequantize_int8=per_forward * forwards)
        expect_init = dict({k: 0 for k in launches}, quantize_int8=per_forward)
        weight_bytes = woq_mod.woq_bytes(engine.params)
        log(f"[{tag}] init {init_s:.2f} s ({n_leaves} quantised leaves, launches {init_launches}, "
            f"expected {expect_init}); prompts {plens}; {forwards} forwards, "
            f"{engine.dispatch_count} dispatches, launches {launches} (expected {expect}); plain "
            f"paged attention called {len(plain_calls)} times")
        if any(len(o) != 64 or o.min() < 0 or o.max() >= cfg.vocab_size for o in outs):
            log(f"[{tag}] FAILED: outputs {[(len(o), int(o.min()), int(o.max())) for o in outs]}")
            return None
        if (launches != expect or init_launches != expect_init or plain_calls or forwards == 0
                or not forms_ok):
            log(f"[{tag}] FAILED: kernel launch counts do not match the forwards run")
            return None
        prefill_tokens = sum(plens)
        r = results[tag] = {
            "kv_cache_dtype": engine.config.kv_dtype_name, "woq": engine.config.quant.enabled,
            "init_s": init_s, "prompt_lens": plens, "forwards": forwards, "launches": launches,
            "init_launches": init_launches, "wall_s": wall, "prefill_s": spans["prefill"],
            "decode_s": spans["decode"], "prefill_tok_s": prefill_tokens / spans["prefill"],
            "decode_tok_s": engine.tokens_decoded / spans["decode"],
            "tokens_decoded": engine.tokens_decoded, "peak_mem_gb": peak_gb,
            "weight_bytes": weight_bytes, "kv_bytes_per_token": engine.kv_bytes_per_token,
            "kv_blocks": engine.num_kv_blocks, "first_tokens": [o[:8].tolist() for o in outs[:2]],
            **forms,
        }
        log(f"[{tag}] generate {wall:.2f} s: prefill {prefill_tokens} tokens in "
            f"{spans['prefill']:.3f} s ({r['prefill_tok_s']:.1f} tok/s), decode "
            f"{engine.tokens_decoded} tokens in {spans['decode']:.3f} s ({r['decode_tok_s']:.1f} "
            f"tok/s), peak memory {peak_gb:.2f} GB; weights {weight_bytes / 1e9:.3f} GB; KV "
            f"{engine.kv_bytes_per_token} B/token, {engine.num_kv_blocks} blocks of 16")
        logits = check_prefill_logits(tag, dev, cfg, engine.params, prompts, r,
                                      kv_quant=engine.config.kv_quant)
        if logits is None:
            return None
        if bf16 is None:
            bf16 = outs, logits
        else:
            agree = float(np.mean(np.concatenate([a == b for a, b in zip(outs, bf16[0])])))
            drift = float((logits - bf16[1]).norm() / bf16[1].norm())
            r["greedy_agreement_with_bf16"], r["drift_vs_bf16_rel_l2"] = agree, drift
            log(f"[{tag}] against the bf16 engine: greedy tokens equal {100 * agree:.1f} %, "
                f"prefill-step logits rel L2 {drift:.3e} (random weights: printed, not held)")
        if profile_paged(tag, engine, prompts, r) is None:
            return None
        r["paged_attention_share_of_device_time"] = r["profile_decode_chain"]["paged_share_of_device_time"]
        if not over and not bloom_layer_norm_ab(tag, dev, cfg, engine, prompts, logits, r):
            return None
        by_path[tag] = {k: launches[k] + init_launches[k] for k in launches}
        del engine, logits
        gc.collect()  # the timing wrappers hold the engine in a reference cycle
        torch.cuda.empty_cache()
    del params, bf16
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


# mistralai/Mixtral-8x7B-v0.1's public config.json (vocab_size 32000,
# hidden_size 4096, intermediate_size 14336, num_hidden_layers 32,
# num_attention_heads 32, num_key_value_heads 8, num_local_experts 8,
# num_experts_per_tok 2, rope_theta 1e6, rms_norm_eps 1e-5,
# max_position_embeddings 32768, tie_word_embeddings false), mapped as
# deepspeed_tpu/checkpoint/hf.py:87-108 maps model_type "mixtral": RMSNorm,
# SiLU-GLU experts, RoPE, untied head
MIXTRAL_8X7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
                    num_heads=32, num_kv_heads=8, max_seq_len=32768, rope_theta=1e6,
                    norm_eps=1e-5, num_experts=8, moe_top_k=2)
# 46.7 B parameters (93 GB in bf16) do not fit one 80 GB card: the phase
# serves the first 16 of the 32 layers at full width (23.5 B, 47 GB)
MIXTRAL_LAYERS = 16
# (tag, engine settings beside SERVE_CONFIG) of the Mixtral serving phase
MIXTRAL_ENGINES = {"mixtral-8x7b bf16": {}, "mixtral-8x7b int8 kv": {"kv_cache_dtype": "int8"}}


def mixtral_prompts(cfg):
    """The serving cell's 8 prompts and 8 more drawn the same way (numpy seed
    2, lengths in [32, 1000]): 16 rows, so that the decode forwards have T =
    16 = 2E tokens and take the grouped GEMM."""
    plens, prompts = serve_prompts(cfg)
    prng = np.random.default_rng(2)
    more = [int(n) for n in prng.integers(32, 1001, 8)]
    return plens + more, prompts + [prng.integers(0, cfg.vocab_size, n).astype(np.int32)
                                    for n in more]


def phase_mixtral_serve(dev, results):
    """Phase 3d: Mixtral-8x7B's widths at 16 of its 32 layers through
    InferenceEngineV2.generate over a bf16 pool and an int8 pool, each
    engine warmed up, then run with the counters zeroed just before and read
    just after. Every forward's token count T = N * C (pads included) is
    recorded: the forwards with T >= 2E must have run the grouped GEMM 3
    times a layer and the others the dense combine, the plain grouped
    matmul never. Returns {tag: launch counts} of the counted runs, or None
    on failure."""
    cfg = dataclasses.replace(TransformerConfig(**MIXTRAL_8X7B, dtype=torch.bfloat16),
                              num_layers=MIXTRAL_LAYERS)
    full = TransformerConfig(**MIXTRAL_8X7B, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in flatten(params).values())
    log(f"[mixtral] init mixtral-8x7b widths at {cfg.num_layers} of {full.num_layers} layers: "
        f"{cfg.num_params() / 1e9:.3f} B params of the full model's {full.num_params() / 1e9:.3f} B "
        f"(JAX count), {weight_bytes / 1e9:.2f} GB of weights; {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB allocated in {time.perf_counter() - t0:.1f} s")
    plens, prompts = mixtral_prompts(cfg)
    L, E = cfg.num_layers, cfg.num_experts
    by_path = {}
    for tag, over in MIXTRAL_ENGINES.items():
        torch.cuda.reset_peak_memory_stats()
        engine = InferenceEngineV2(cfg, params, dict(SERVE_CONFIG, **over), device=dev)
        engine.generate(prompts, max_new_tokens=2)  # warm-up: cuBLAS and allocator first calls
        engine.dispatch_count = engine.host_sync_count = engine.tokens_decoded = 0
        engine.chain_steps = engine.model_forwards = 0
        shapes, plain_calls, paged_plain = [], [], []
        real_plain = gmm_mod.grouped_matmul_plain

        def spy(*a, **k):
            plain_calls.append(1)
            return real_plain(*a, **k)

        zero_counts()
        with paged_path(shapes, paged_plain), mock.patch.object(gmm_mod, "grouped_matmul_plain", spy):
            outs, wall, spans, peak_gb = timed_generate(engine, prompts)
        launches = launch_counts()
        forms_ok, forms = paged_forms_of_run(tag, cfg, shapes, paged_plain)
        by_form = dict(gmm_mod.grouped_matmul.launches_by_form)
        calls = (model_mod._moe.dense_calls, model_mod._moe.ragged_calls)
        forwards = engine.model_forwards
        ragged = [(n, c) for n, c in shapes if n * c >= 2 * E]
        ragged_prefill = sum(1 for _, c in ragged if c > 1)
        ragged_decode = len(ragged) - ragged_prefill
        paged = "paged_attention" if engine.config.kv_quant is None else "paged_attention_quant"
        expect = dict({k: 0 for k in launches}, rms_norm=(2 * L + 1) * forwards,
                      grouped_matmul=3 * L * len(ragged), **{paged: L * forwards})
        expect_calls = (L * (len(shapes) - len(ragged)), L * len(ragged))
        # prefill forwards through form P, the decode forwards through form D
        expect_forms = dict.fromkeys(gmm_mod.FORMS, 0)
        expect_forms.update(wgmma=3 * L * ragged_prefill, stream=3 * L * ragged_decode)
        log(f"[{tag}] {len(prompts)} prompts {plens}; {forwards} forwards ({len(ragged)} with T >= "
            f"2E = {2 * E}: {ragged_prefill} prefill, {ragged_decode} decode), "
            f"{engine.dispatch_count} dispatches, launches {launches} (expected {expect}); _moe "
            f"calls dense/ragged {calls} (expected {expect_calls}); plain grouped matmul called "
            f"{len(plain_calls)} times; grouped GEMM launches by form {by_form} (expected "
            f"{expect_forms})")
        if any(len(o) != 64 or o.min() < 0 or o.max() >= cfg.vocab_size for o in outs):
            log(f"[{tag}] FAILED: outputs {[(len(o), int(o.min()), int(o.max())) for o in outs]}")
            return None
        if (launches != expect or calls != expect_calls or plain_calls or len(shapes) != forwards
                or ragged_prefill == 0 or ragged_decode == 0 or by_form != expect_forms
                or not forms_ok):
            log(f"[{tag}] FAILED: kernel launch or regime counts do not match the forwards run")
            return None
        prefill_tokens = sum(plens)
        r = results[tag] = {
            "layers": L, "full_layers": full.num_layers, "kv_cache_dtype": engine.config.kv_dtype_name,
            "prompt_lens": plens, "forwards": forwards, "ragged_forwards": len(ragged),
            "ragged_prefill_forwards": ragged_prefill, "ragged_decode_forwards": ragged_decode,
            "forward_shapes": shapes, "launches": launches, "moe_calls_dense_ragged": list(calls),
            "grouped_matmul_launches_by_form": by_form, **forms,
            "wall_s": wall, "prefill_s": spans["prefill"], "decode_s": spans["decode"],
            "prefill_tok_s": prefill_tokens / spans["prefill"],
            "decode_tok_s": engine.tokens_decoded / spans["decode"],
            "tokens_decoded": engine.tokens_decoded, "peak_mem_gb": peak_gb,
            "weight_bytes": weight_bytes, "kv_bytes_per_token": engine.kv_bytes_per_token,
            "kv_blocks": engine.num_kv_blocks, "first_tokens": [o[:8].tolist() for o in outs[:2]],
        }
        log(f"[{tag}] generate {wall:.2f} s: prefill {prefill_tokens} tokens in "
            f"{spans['prefill']:.3f} s ({r['prefill_tok_s']:.1f} tok/s), decode "
            f"{engine.tokens_decoded} tokens in {spans['decode']:.3f} s ({r['decode_tok_s']:.1f} "
            f"tok/s), peak memory {peak_gb:.2f} GB; weights {weight_bytes / 1e9:.3f} GB; KV "
            f"{engine.kv_bytes_per_token} B/token, {engine.num_kv_blocks} blocks of 16")
        if check_prefill_logits(tag, dev, cfg, engine.params, prompts, r,
                                kv_quant=engine.config.kv_quant) is None:
            return None
        rows = profile_paged(tag, engine, prompts, r)
        if rows is None:
            return None
        gmm_ms = {kernel: sum(ms for ms, _, name in rows if f"{kernel}(" in name)
                  for kernel in ("gmm_wgmma_kernel", "gmm_stream_kernel", "gmm_bf16_kernel")}
        r["grouped_matmul_ms_by_kernel"] = gmm_ms
        busy = r["profile_decode_chain"]["device_busy_ms"]
        r["grouped_matmul_share_of_device_time"] = sum(gmm_ms.values()) / busy
        log(f"[{tag}] grouped GEMM: {sum(gmm_ms.values()):.2f} ms of "
            f"{busy:.2f} ms device time "
            f"({100 * r['grouped_matmul_share_of_device_time']:.1f} %) in the decode chain, by "
            f"kernel {gmm_ms}")
        by_path[tag] = launches
        del engine
        gc.collect()  # the timing wrappers hold the engine in a reference cycle
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def phase_train(dev, tag, cfg, micro, seq, gas, expect_per_micro, results, profile=False,
                flops_per_token=None, init=init_params):
    """Phases 4 and 6: ``initialize`` + ``train_batch`` at full size, from fp32
    masters ``init(cfg, seed=0, device=dev, dtype=torch.float32)``. Returns
    the launch counts of the counted steps, or None on failure. MFU uses
    ``flops_per_token`` where given, else the JAX formula."""
    t0 = time.perf_counter()
    masters = init(cfg, seed=0, device=dev, dtype=torch.float32)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=causal_lm_spec(cfg, example_seq_len=seq),
        config=dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro,
                    gradient_accumulation_steps=gas),
        model_parameters=masters, device=dev)
    del masters
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in engine.params.values())
    log(f"[{tag}] initialize: {n_params / 1e9:.4f} B params (JAX count {cfg.num_params() / 1e9:.4f} B), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s; "
        f"batch {engine.train_batch_size} x {seq} (micro {micro}, gas {gas})")
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (engine.train_batch_size, seq),
                                       dtype=np.int32)}
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    # the flash forward's and backward's plain versions, spied on: never
    # called on a CUDA tensor
    plain_on_cuda = []

    def plain_spy(real):
        def spy(qs, *a, **kw):
            if qs.is_cuda:
                plain_on_cuda.append(real.__name__)
            return real(qs, *a, **kw)
        return spy

    zero_counts()
    with mock.patch.object(fa, "flash_fwd_reference", plain_spy(fa.flash_fwd_reference)), \
            mock.patch.object(fa, "flash_bwd_reference", plain_spy(fa.flash_bwd_reference)):
        for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = engine.train_batch(batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(metrics["loss"])
    launches = launch_counts()
    by_form = dict(fa.flash_fwd.launches_by_form)
    bwd_by_form = dict(fa.flash_bwd.launches_by_form)
    # every bf16 forward and backward launch is form W's
    forms_ok = (by_form == dict(dict.fromkeys(fa.FWD_FORMS, 0),
                                wgmma=launches["flash_fwd"] + launches["flash_fwd_alibi"])
                and bwd_by_form == dict(dict.fromkeys(fa.BWD_FORMS, 0),
                                        wgmma=launches["flash_bwd"] + launches["flash_bwd_alibi"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    grad_norm = float(metrics["grad_norm"])
    micro_steps = gas * (TRAIN_WARMUP + TRAIN_TIMED)
    expect = {k: expect_per_micro.get(k, 0) * micro_steps for k in launches}
    timed = float(np.median(step_s[TRAIN_WARMUP:]))
    tokens = engine.train_batch_size * seq
    tok_s = tokens / timed
    fpt = cfg.flops_per_token(seq) if flops_per_token is None else flops_per_token
    mfu = tok_s * fpt / PEAK_FLOPS[torch.bfloat16]
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}, last grad_norm {grad_norm:.4f}; "
        f"step times {[round(x, 4) for x in step_s]} s")
    log(f"[{tag}] step {timed:.4f} s (median of {TRAIN_TIMED}), {tok_s:.1f} tokens/s, MFU "
        f"{100 * mfu:.2f} % ({fpt / 1e9:.3f} GFLOP/token, 989 TFLOP/s bf16), peak memory "
        f"{peak_gb:.2f} GB; launches {launches} (expected {expect}); flash_fwd launches by form "
        f"{by_form}, flash_bwd by form {bwd_by_form}; the plain forward or backward called on a "
        f"CUDA tensor {len(plain_on_cuda)} times")
    results[tag] = {"losses": losses, "step_s": step_s, "median_step_s": timed, "tokens_per_s": tok_s,
                    "mfu": mfu, "flops_per_token": fpt, "peak_mem_gb": peak_gb,
                    "launches": launches, "grad_norm": grad_norm, "flash_fwd_by_form": by_form,
                    "flash_bwd_by_form": bwd_by_form}
    if not all(math.isfinite(x) for x in losses + [grad_norm]) or not losses[-1] < losses[0]:
        log(f"[{tag}] FAILED: the loss is not finite or did not fall")
        return None
    if launches != expect or min(v for k, v in launches.items() if expect[k]) == 0:
        log(f"[{tag}] FAILED: kernel launch counts do not match the micro-steps run")
        return None
    if not forms_ok or plain_on_cuda:
        log(f"[{tag}] FAILED: a flash forward or backward launch was not form W's, or a plain "
            f"version ran on a CUDA tensor ({plain_on_cuda[:2]})")
        return None
    if profile:
        prof = device_profile(lambda: engine.train_batch(batch))
        if prof[1] <= 0:
            log(f"[{tag}] FAILED: the profiler saw no device time in the step")
            return None
        results[tag]["profile_step"] = log_profile(tag, "one training step", *prof)
    del engine, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def slice_config(kind):
    """Phase 5's micro-step of one kind, as a dict: the model's ``name``,
    ``config``, batch ``shape``, whether a row is ``padded``, its weights'
    ``init`` and the launch ``counters`` its kernels bump. ``llama``: flash
    attention with a padded row; ``sparse``: the sparse config without a
    padding mask (which would take the dense path); ``bloom``: 2-layer
    full-width Bloom-560M, the ALiBi form, a padded row."""
    if kind == "bloom":
        cfg = TransformerConfig(**dict(BLOOM_560M, num_layers=2), dtype=torch.bfloat16)
        return dict(name="bloom-560m", config=cfg, shape=(4, 2048), padded=True,
                    init=bloom_params, counters=FLASH_ALIBI_KERNELS)
    over = dict(attn_impl="sparse", sparse_attention=SPARSE_ATTENTION) if kind == "sparse" else {}
    cfg = dataclasses.replace(PRESETS["llama3-1b"], num_layers=2, dtype=torch.bfloat16, **over)
    if kind == "sparse":
        return dict(name="llama3-1b", config=cfg, shape=(2, SPARSE_SEQ), padded=False,
                    init=init_params, counters=SPARSE_KERNELS)
    return dict(name="llama3-1b", config=cfg, shape=(4, 2048), padded=True, init=init_params,
                counters=FLASH_KERNELS)


def phase_slice_check(dev, results, kind="llama") -> bool:
    """Phase 5: loss and gradients of one micro-step of a 2-layer full-width
    model through the kernels and through the plain versions (``slice_config``
    names the three kinds); every gradient leaf is compared, the key bias
    (``SHIFT_INVARIANT``) on its query bias's scale."""
    tag = "slice" if kind == "llama" else f"slice {kind}"
    kind_cfg = slice_config(kind)
    cfg, (B, S), counters = kind_cfg["config"], kind_cfg["shape"], kind_cfg["counters"]
    # the kernel family the counters name, swapped for its plain versions below
    module, wrappers = (bs, SPARSE_KERNELS) if counters == SPARSE_KERNELS else (fa, FLASH_KERNELS)
    params = kind_cfg["init"](cfg, seed=1, device=dev, dtype=torch.bfloat16)
    flat = flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    model = CausalLM(cfg)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    batch = {"input_ids": ids}
    if kind_cfg["padded"]:
        mask = torch.ones(B, S, dtype=torch.int32, device=dev)
        mask[1, 1500:] = 0
        batch["attention_mask"] = mask

    def step():
        loss, _ = model(params, batch, train=True)
        return loss.detach().float(), torch.autograd.grad(loss, list(flat.values()))

    zero_counts()
    loss_k, grads_k = step()
    torch.cuda.synchronize()
    launches = launch_counts()
    rms = 2 * cfg.num_layers + 1 if cfg.norm == "rmsnorm" else 0
    expect = dict({k: 0 for k in launches}, rms_norm=rms, **{k: cfg.num_layers for k in counters})
    with contextlib.ExitStack() as stack:
        for k in wrappers:
            stack.enter_context(mock.patch.object(module, k, getattr(module, f"{k}_reference")))
        stack.enter_context(mock.patch.object(norms_mod, "rms_norm_fwd", rms_norm_reference))
        loss_p, grads_p = step()
    torch.cuda.synchronize()
    plain_launches = launch_counts()
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grads_k, grads_p = dict(zip(flat, grads_k)), dict(zip(flat, grads_p))
    rels = {}
    for path in flat:
        gk, gp = grads_k[path].float(), grads_p[path].float()
        scale = gp
        if path == SHIFT_INVARIANT[0] and cfg.position != "rope":
            scale = grads_p[SHIFT_INVARIANT[1]].float()
        rels[path] = float((gk - gp).norm() / scale.norm().clamp_min(1e-30))
    worst = max(rels, key=rels.get)
    ok = (launches == expect and plain_launches == launches and math.isfinite(loss_rel)
          and loss_rel <= SLICE_LOSS_REL and all(r <= SLICE_GRAD_REL_L2 for r in rels.values())
          and all(bool(torch.isfinite(g).all()) for g in grads_k.values()))
    log(f"[{tag}] 2-layer {kind_cfg['name']} micro-step {B} x {S}: loss kernels {float(loss_k):.5f} plain "
        f"{float(loss_p):.5f} (rel {loss_rel:.2e}, bound {SLICE_LOSS_REL}); gradient leaves rel L2 "
        f"max {rels[worst]:.3e} at {worst} (bound {SLICE_GRAD_REL_L2}); launches {launches} "
        f"(expected {expect}), plain run launched none: {plain_launches == launches} "
        f"{'ok' if ok else 'FAIL'}")
    for path, r in sorted(rels.items()):
        note = " (on the query bias's scale)" if path == SHIFT_INVARIANT[0] else ""
        log(f"[{tag}]   {path}: {r:.3e}{note}")
    results[tag] = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
                    "loss_rel": loss_rel, "grad_rel_l2": rels}
    return ok


def flash_bytes_flops(B, S, H, kvH, hd, itemsize, kernel, alibi=False):
    """Bytes the kernel must move (each input read once, each output written
    once) and the flops of its products over the S(S+1)/2 causal pairs; with
    ``alibi`` also the fp32 slopes and 2 flops per pair (slope times
    distance, added), which each kernel computes."""
    q_bytes, kv_bytes, row_bytes = B * S * H * hd * itemsize, B * S * kvH * hd * itemsize, B * H * S * 4
    pairs = S * (S + 1) // 2
    extra_bytes, extra_flops = (4 * H, 2 * B * H * pairs) if alibi else (0, 0)
    if kernel == "flash_fwd":  # q, k, v -> out, lse; products q.k, p.v
        nbytes, flops = 2 * q_bytes + 2 * kv_bytes + row_bytes, 2 * 2 * B * H * pairs * hd
    elif kernel == "flash_bwd_dq":  # q, k, v, dO, lse, delta -> dq; q.k, dO.v, ds.k
        nbytes, flops = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 3 * 2 * B * H * pairs * hd
    elif kernel == "flash_bwd_dkv":  # q, k, v, dO, lse, delta -> dk, dv; q.k, dO.v, p.dO, ds.q
        nbytes, flops = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 4 * 2 * B * H * pairs * hd
    else:  # form W's backward: q, k, v, dO, lse, delta -> dq, dk, dv; q.k, dO.v, p.dO, ds.q, ds.k
        nbytes, flops = 3 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 5 * 2 * B * H * pairs * hd
    return nbytes + extra_bytes, flops + extra_flops


# palindromes (w m s s m w) of the forward's forms and SDPA in time_fwd_forms
FWD_TURN_ROUNDS = 4


def time_fwd_forms(qs, k, v, sl, sdpa, bound_ms, flops, tag):
    """The forward's bf16 forms (``FLASH_FWD_FORMS``) and the SDPA yardstick
    timed in turns (``time_turns``, ``FWD_TURN_ROUNDS`` rounds) on the same
    inputs, logged with TFLOP/s, the share of the bound and the spread of
    form W's time over SDPA's across the turns: ({label: mean ms}, {label:
    [ms of each reading]})."""
    fns = {name: functools.partial(fa._flash_fwd_form, qs, k, v, None, sl, name)
           for name in FLASH_FWD_FORMS}
    readings = {}
    got = time_turns(dict(fns, sdpa=sdpa), iters=100, rounds=FWD_TURN_ROUNDS, readings=readings)
    ratios = [w / s for w, s in zip(readings["wgmma"], readings["sdpa"])]
    log(f"[time] flash_fwd forms {tag}, in turns: " + ", ".join(
        f"{name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f} % of "
        f"the bound)" for name, ms in got.items()))
    log(f"[time] flash_fwd {tag}: readings {readings}; form W / SDPA reading by reading "
        f"{[round(x, 4) for x in ratios]} (min {min(ratios):.4f}, max {max(ratios):.4f})")
    return got, readings


def time_flash(dev, launches, max_err, timing, alibi=False):
    """The flash kernels, bf16, no keep-mask, beside their bounds, plain
    versions and SDPA: at the llama3-1b training shape, or with ``alibi``
    their ALiBi form at Bloom-560M's (SDPA with the bias and the causal mask
    folded into one float mask built beforehand; the SDPA backend that ran is
    logged). The forward's forms (form W, the mma.sync form) are timed in
    turns with SDPA's forward (``time_fwd_forms``), the backward's (form W,
    the mma dq and dkv pair) with SDPA's whole backward (``time_bwd_forms``);
    without ``alibi`` both also at the Llama-3-8B heads' hd 128."""
    shape = FLASH_ALIBI_SETS["bloom-560m"] if alibi else FLASH_SETS["llama3-1b"]
    B, S, H, kvH, hd = (shape[k] for k in ("B", "S", "H", "kvH", "hd"))
    q, k, v, do, _ = flash_inputs(dev, **shape)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    qs = fa.prescale_q(q)
    natural = alibi_slopes(H, dev) if alibi else None
    sl = fa.alibi_log2(natural) if alibi else None
    # library yardstick (never called by the port): SDPA in its [B, H, S, hd]
    # layout, forward alone and its whole backward
    if alibi:  # natural-log slopes: SDPA's softmax is base e, its scale hd**-0.5
        pos = torch.arange(S, device=dev)
        rel = (pos[None, :] - pos[:, None]).float()
        bias = natural[:, None, None] * rel
        sdpa_kw = {"attn_mask": torch.where(rel <= 0, bias, float("-inf")).to(torch.bfloat16)[None]}
        del bias, rel
    else:
        sdpa_kw = {"is_causal": True, "enable_gqa": True}
    sdpa, sdpa_bwd, sdpa_in = sdpa_calls(q, k, v, do, sdpa_kw)
    tag = f"B {B} S {S} H {H} kvH {kvH} hd {hd}{' ALiBi' if alibi else ''}"
    fwd_bytes, fwd_flops = flash_bytes_flops(B, S, H, kvH, hd, 2, "flash_fwd", alibi)
    fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S, fwd_flops / PEAK_FLOPS[torch.bfloat16]) * 1e3
    forms, fwd_readings = time_fwd_forms(qs, k, v, sl, sdpa, fwd_bound, fwd_flops, tag)
    sdpa_fwd = forms.pop("sdpa")
    form, suffix = ("ALiBi", "_alibi") if alibi else ("", "")
    # the backend SDPA's dispatcher picks for these inputs
    choice = int(torch._fused_sdp_choice(*sdpa_in, **sdpa_kw))
    backend = {int(b.value): name for name, b in SDPBackend.__members__.items()}.get(choice,
                                                                                  str(choice))
    timing[f"sdpa_backend{suffix}"] = backend
    log(f"[time] SDPA{' ' + form if form else ''} runs its {backend} backend on these inputs")
    key = f"[{B},{S},{H},{kvH},{hd}]"
    t = {"ms": forms["wgmma"], "plain_ms": time_fn(lambda: fa.flash_fwd_reference(qs, k, v, None, sl),
                                                   iters=20, warmup=2),
         "bound_ms": fwd_bound, "bound_by": bound_by(fwd_bytes, fwd_flops), "library_ms": sdpa_fwd}
    timing[f"flash_fwd{suffix}{key}"] = t
    log(f"[time] flash_fwd{suffix} {tag} bf16: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"SDPA forward {sdpa_fwd:.4f} ms, bound {fwd_bound:.4f} ms ({t['bound_by']}: "
        f"{fwd_bytes / 1e6:.1f} MB, {fwd_flops / 1e9:.1f} GFLOP; {fwd_flops / t['ms'] / 1e9:.1f} TFLOP/s)")
    fwd_entry = dict(name=f"flash_fwd{suffix}", route="cuda",
                     source="deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
                     replaces="deepspeed_tpu/ops/pallas/flash_attention.py:216",
                     launches=launches[f"flash_fwd{suffix}"], max_abs_err=max_err[f"flash_fwd{suffix}"],
                     shape=f"q [{B}, {S}, {H}, {hd}], kv heads {kvH}, bf16",
                     **{k2: t[k2] for k2 in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                     form="wgmma", mma_ms=forms["mma"], turns_ms=fwd_readings)
    out, lse = fa.flash_fwd(qs, k, v, None, sl)
    delta = fa.flash_delta(do, out)
    bwd_entry = dict(name=f"flash_bwd{suffix}", launches=launches[f"flash_bwd{suffix}"],
                     max_abs_err=max_err[f"flash_bwd{suffix}"],
                     shape=f"q [{B}, {S}, {H}, {hd}], kv heads {kvH}, bf16",
                     **time_bwd_forms(qs, k, v, do, out, lse, delta, sl, sdpa_bwd, tag, timing,
                                      suffix))
    for pair in FLASH_PAIR:  # the mma form's pieces alone, with their phase-2 errors
        bwd_entry["mma"][pair]["max_abs_err"] = max_err[pair + suffix]
    if alibi:
        note = "_alibi_add, deepspeed_tpu/ops/pallas/flash_attention.py:158"
        fwd_entry["alibi"] = bwd_entry["alibi"] = note
        # the forms without ALiBi at the same shape: what the bias costs
        for name, fn in (("flash_fwd", lambda: fa.flash_fwd(qs, k, v, None)),
                         ("flash_bwd", lambda: fa.flash_bwd(qs, k, v, None, do, lse, delta))):
            with_bias = timing[f"{name}{suffix}{key}"]["ms"]
            without = time_fn(fn, iters=100)
            timing[f"{name}{key}"] = {"ms": without}
            log(f"[time] {name} without ALiBi at the same shape: {without:.4f} ms; the ALiBi "
                f"form {with_bias:.4f} ms ({100 * (with_bias / without - 1):+.1f} %)")
    else:
        fwd_entry["launches_by_form"] = launches["flash_fwd_by_form"]
        bwd_entry["launches_by_form"] = launches["flash_bwd_by_form"]
        # hd 128 (the Llama-3-8B heads): the forms of both beside SDPA
        s8 = FLASH_SETS["llama3-8b heads"]
        q8, k8, v8, do8 = (t.to(torch.bfloat16) for t in flash_inputs(dev, **s8)[:4])
        qs8 = fa.prescale_q(q8)
        tag8 = f"B {s8['B']} S {s8['S']} H {s8['H']} kvH {s8['kvH']} hd {s8['hd']}"
        causal = {"is_causal": True, "enable_gqa": True}
        _, sdpa8_bwd, sdpa8_in = sdpa_calls(q8, k8, v8, do8, causal)
        # the forward alone on detached inputs: no autograd record in its time
        sdpa8 = functools.partial(F.scaled_dot_product_attention,
                                  *(t.detach() for t in sdpa8_in), **causal)
        nbytes8, flops8 = flash_bytes_flops(s8["B"], s8["S"], s8["H"], s8["kvH"], s8["hd"], 2,
                                            "flash_fwd")
        bound8 = max(nbytes8 / HBM_BYTES_PER_S, flops8 / PEAK_FLOPS[torch.bfloat16]) * 1e3
        forms8, readings8 = time_fwd_forms(qs8, k8, v8, None, sdpa8, bound8, flops8, tag8)
        hd128 = {"shape": f"q [{s8['B']}, {s8['S']}, {s8['H']}, {s8['hd']}], kv heads {s8['kvH']}, "
                          f"bf16", "ms": forms8["wgmma"], "mma_ms": forms8["mma"],
                 "library_ms": forms8.pop("sdpa"), "bound_ms": bound8,
                 "bound_by": bound_by(nbytes8, flops8), "turns_ms": readings8}
        timing["flash_fwd hd128"] = fwd_entry["hd128"] = hd128
        out8, lse8 = fa.flash_fwd(qs8, k8, v8)
        bwd8 = time_bwd_forms(qs8, k8, v8, do8, out8, lse8, fa.flash_delta(do8, out8), None,
                              sdpa8_bwd, tag8, timing, " hd128")
        bwd8["shape"] = hd128["shape"]
        timing["flash_bwd hd128"] = bwd_entry["hd128"] = bwd8
        del q8, k8, v8, do8, qs8, out8, lse8, sdpa8, sdpa8_bwd, sdpa8_in
    del q, k, v, do, qs, out, lse, delta, sdpa, sdpa_bwd, sdpa_in
    torch.cuda.empty_cache()
    return [fwd_entry, bwd_entry]


def bound_by(nbytes, flops):
    """Which of the card's two rates bounds work of ``nbytes`` and ``flops``."""
    return "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_FLOPS[torch.bfloat16] else "operations"


def sdpa_calls(q, k, v, do, sdpa_kw):
    """The SDPA yardstick on q ``[B, S, H, hd]``, k, v ``[B, S, kvH, hd]``
    (never called by the port): (its forward, its whole backward on ``do``
    through one retained graph, its inputs q, k, v in its ``[B, heads, S,
    hd]`` layout)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    fwd = functools.partial(F.scaled_dot_product_attention, qt, kt, vt, **sdpa_kw)
    out = fwd()
    return fwd, lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), (qt, kt, vt)


def time_bwd_forms(qs, k, v, do, out, lse, delta, sl, sdpa_bwd, tag, timing, suffix):
    """The backward's bf16 forms (``FLASH_BWD_FORMS``: form W and the mma dq
    and dkv pair) and SDPA's whole backward timed in turns (``time_turns``,
    ``FWD_TURN_ROUNDS`` palindromes) on the same inputs; then form W with
    ``flash_delta`` before it (SDPA's backward computes its own delta), the
    pair's two kernels alone and the plain version. Logs every reading, form
    W / SDPA reading by reading, TFLOP/s on form W's five products and the
    share of their bound. Returns the kernel entry (without name, launches,
    errors)."""
    B, S, H, hd = qs.shape
    kvH = k.shape[2]
    alibi = sl is not None
    fns = {name: functools.partial(fa._flash_bwd_form, qs, k, v, None, do, lse, delta, sl, name)
           for name in FLASH_BWD_FORMS}
    readings = {}
    got = time_turns(dict(fns, sdpa=sdpa_bwd), iters=50, rounds=FWD_TURN_ROUNDS, readings=readings)
    ratios = [w / s for w, s in zip(readings["wgmma"], readings["sdpa"])]
    nbytes, flops = flash_bytes_flops(B, S, H, kvH, hd, 2, "flash_bwd", alibi)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.bfloat16]) * 1e3
    with_delta = time_fn(lambda: fa.flash_bwd(qs, k, v, None, do, lse, fa.flash_delta(do, out), sl),
                         iters=50)
    delta_ms = time_fn(lambda: fa.flash_delta(do, out), iters=50)
    pair = {}
    for name in FLASH_PAIR:
        nb, fl = flash_bytes_flops(B, S, H, kvH, hd, 2, name, alibi)
        fn = getattr(fa, name)
        pair[name] = {"ms": time_fn(lambda: fn(qs, k, v, None, do, lse, delta, sl), iters=50),
                      "bound_ms": max(nb / HBM_BYTES_PER_S, fl / PEAK_FLOPS[torch.bfloat16]) * 1e3,
                      "bound_by": bound_by(nb, fl)}
    plain = time_fn(lambda: fa.flash_bwd_reference(qs, k, v, None, do, lse, delta, sl), iters=10,
                    warmup=2)
    log(f"[time] flash_bwd forms {tag}, in turns: " + ", ".join(
        f"{name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s on 5 products, {100 * bound / ms:.1f} % "
        f"of their bound)" for name, ms in got.items()))
    log(f"[time] flash_bwd {tag}: readings {readings}; form W / SDPA's backward reading by reading "
        f"{[round(x, 4) for x in ratios]} (min {min(ratios):.4f}, max {max(ratios):.4f})")
    log(f"[time] flash_bwd {tag}: form W {got['wgmma']:.4f} ms alone, {with_delta:.4f} ms with "
        f"flash_delta ({delta_ms:.4f} ms alone, plain fp32); the mma pair's kernels alone: "
        + ", ".join(f"{n} {p['ms']:.4f} ms (bound {p['bound_ms']:.4f})" for n, p in pair.items())
        + f"; plain {plain:.4f} ms; bound {bound:.4f} ms ({bound_by(nbytes, flops)}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
    entry = dict(route="cuda", source="deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
                 replaces="deepspeed_tpu/ops/pallas/flash_attention.py:364, "
                          "deepspeed_tpu/ops/pallas/flash_attention.py:432",
                 ms=got["wgmma"], plain_ms=plain, bound_ms=bound, bound_by=bound_by(nbytes, flops),
                 library_ms=got["sdpa"], form="wgmma", with_delta_ms=with_delta, delta_ms=delta_ms,
                 mma_ms=got["mma"], mma=pair, turns_ms=readings)
    timing[f"flash_bwd{suffix}[{B},{S},{H},{kvH},{hd}]"] = {
        k2: entry[k2] for k2 in ("ms", "plain_ms", "bound_ms", "library_ms", "with_delta_ms",
                                 "mma_ms")}
    return entry


def sparse_bytes_flops(B, H, kvH, S, D, itemsize, layout, block, kernel):
    """Bytes the kernel must move (each input read once, each output written
    once: q, dO and out at H heads and k, v at kvH in the input dtype, lse and
    delta fp32, dq and the per-query-head dk, dv fp32, and of the layout
    lists the counts and the entries below them, the only ones read) and the
    flops of its products over the live tiles."""
    x, kv, x32, row = (B * S * H * D * itemsize, B * S * kvH * D * itemsize, B * S * H * D * 4,
                       B * H * S * 4)
    _, ncols = bs.layout_to_lists(layout)
    _, nrows = bs.layout_to_lists_t(layout)
    lists = lambda counts: (counts.size + int(counts.sum())) * 4  # noqa: E731
    tile = 2 * block * block * D * B * live_tiles(layout)  # one product over the live tiles
    if kernel == "sparse_fwd":  # q, k, v -> out, lse; products q.k, p.v
        return 2 * x + 2 * kv + row + lists(ncols), 2 * tile
    if kernel == "sparse_bwd_dq":  # q, k, v, dO, lse, delta -> dq; q.k, dO.v, ds.k
        return 2 * x + 2 * kv + 2 * row + x32 + lists(ncols), 3 * tile
    # q, k, v, dO, lse, delta -> dk, dv; q.k, dO.v, p.dO, ds.q
    return 2 * x + 2 * kv + 2 * row + 2 * x32 + lists(nrows), 4 * tile


def time_sparse(dev, launches, max_err, timing):
    """The sparse kernels at the sparse training path's shape (B 2, 32 query
    and 8 kv heads, S 4096, D 64, BigBird block 16, causal, bf16) beside their
    bounds, plain versions and SDPA with the layout expanded to a token mask
    (the same function, dense)."""
    B, H, kvH, S, D = (SPARSE_TIME_SHAPE[key] for key in ("B", "H", "kvH", "S", "D"))
    layout, block, (cols, ncols, rows, nrows) = sparse_layout(
        tuple(sorted(SPARSE_ATTENTION.items())), H, S, dev)
    q, k, v, do = (t.to(torch.bfloat16) for t in flash_inputs(dev, B, S, H, kvH, D)[:4])
    qs = bs.prescale_q(q)
    out, lse = bs.sparse_fwd(qs, k, v, cols, ncols, block)
    delta = bs.sparse_delta(do, out)
    calls = {
        "sparse_fwd": (lambda: bs.sparse_fwd(qs, k, v, cols, ncols, block),
                       lambda: bs.sparse_fwd_reference(qs, k, v, cols, ncols, block)),
        "sparse_bwd_dq": (lambda: bs.sparse_bwd_dq(qs, k, v, do, lse, delta, cols, ncols, block),
                          lambda: bs.sparse_bwd_dq_reference(qs, k, v, do, lse, delta, cols,
                                                             ncols, block)),
        "sparse_bwd_dkv": (lambda: bs.sparse_bwd_dkv(qs, k, v, do, lse, delta, rows, nrows,
                                                     block),
                           lambda: bs.sparse_bwd_dkv_reference(qs, k, v, do, lse, delta, rows,
                                                               nrows, block)),
    }
    # library yardstick (never called by the port): SDPA on [B, H, S, D] with
    # k and v repeated to H heads and a [1, H, S, S] boolean mask, the layout
    # expanded to tokens and the causal mask
    mask = bs.token_mask(torch.as_tensor(layout != 0, device=dev), block, True)[None]
    ql = q.transpose(1, 2).contiguous().requires_grad_(True)
    kl, vl = (t.repeat_interleave(H // kvH, 2).transpose(1, 2).contiguous().requires_grad_(True)
              for t in (k, v))
    dol = do.transpose(1, 2).contiguous()
    sdpa_fwd = time_fn(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
                       iters=20)
    sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    sdpa_bwd = time_fn(lambda: torch.autograd.grad(sdpa_out, (ql, kl, vl), dol,
                                                   retain_graph=True), iters=20)
    library = {"sparse_fwd": sdpa_fwd, "sparse_bwd_dq": None, "sparse_bwd_dkv": None}
    sources = {"sparse_fwd": ("sparse_attention_fwd.cu", 85),
               "sparse_bwd_dq": ("sparse_attention_bwd_dq.cu", 171),
               "sparse_bwd_dkv": ("sparse_attention_bwd_dkv.cu", 205)}
    live = live_tiles(layout)
    kernels = []
    for name, (kernel_fn, plain_fn) in calls.items():
        nbytes, flops = sparse_bytes_flops(B, H, kvH, S, D, 2, layout, block, name)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        t = {"ms": time_fn(kernel_fn, iters=100),
             "plain_ms": time_fn(plain_fn, iters=5, warmup=1, flush=lambda: None),
             "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library[name]}
        timing[f"{name}[{B},{H},{S},{D}]"] = t
        lib_text = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        log(f"[time] {name} B {B} H {H} kvH {kvH} S {S} D {D} bigbird block {block} ({live} live "
            f"tiles) "
            f"bf16: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA(token mask) "
            f"forward {lib_text}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; {nbytes / t['ms'] / 1e6:.1f} GB/s)")
        src, line = sources[name]
        kernels.append(dict(name=name, route="cuda", source=f"deepspeed_tpu_torch/csrc/{src}",
                            replaces=f"deepspeed_tpu/ops/pallas/sparse_attention.py:{line}",
                            launches=launches[name], max_abs_err=max_err[name],
                            shape=f"q [{B}, {S}, {H}, {D}], k, v [{B}, {S}, {kvH}, {D}], "
                                  f"bigbird block {block}, bf16",
                            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms")}))
    bwd_sum = timing[f"sparse_bwd_dq[{B},{H},{S},{D}]"]["ms"] + \
        timing[f"sparse_bwd_dkv[{B},{H},{S},{D}]"]["ms"]
    timing["sdpa_masked_backward_vs_sparse_dq_plus_dkv"] = {"sdpa_bwd_ms": sdpa_bwd,
                                                            "dq_plus_dkv_ms": bwd_sum}
    log(f"[time] sparse backward: SDPA's whole backward with the token mask {sdpa_bwd:.4f} ms "
        f"beside dq + dkv {bwd_sum:.4f} ms (delta, plain fp32, excluded)")
    return kernels


# (kernel line entry, label, phase-2 batch, pool, ALiBi) of phase 7's paged timings
PAGED_TIME_SETS = (
    ("paged_attention", "decode", "decode C=1, lens 1-1000", None, False),
    ("paged_attention", "prefill", "prefill C=512, ragged, pad row", None, False),
    ("paged_attention_quant", "int8 decode", "decode C=1, lens 1-1000", "int8", False),
    ("paged_attention_quant", "int8 prefill", "prefill C=512, ragged, pad row", "int8", False),
    ("paged_attention_quant", "fp8 decode", "decode C=1, lens 1-1000", "fp8", False),
    ("paged_attention_quant", "fp8 prefill", "prefill C=512, ragged, pad row", "fp8", False),
    ("paged_attention_alibi", "decode", "bloom decode C=1, lens 1-1000", None, True),
    ("paged_attention_alibi", "prefill", "bloom prefill C=512, ragged, pad row", None, True),
    ("paged_attention_alibi", "int8 decode", "bloom decode C=1, lens 1-1000", "int8", True),
    ("paged_attention_alibi", "fp8 decode", "bloom decode C=1, lens 1-1000", "fp8", True),
)
# the crossover sweep of forms "split" and W: (kv heads, C) at 32 query heads,
# 8 rows of lengths 1-1000 (at least C)
PAGED_SWEEP = ((8, 2), (8, 4), (8, 8), (32, 2), (32, 4), (32, 8), (32, 16))
# form "split"'s split counts swept at the decode batches (the plan's SPLIT_PLAN)
PAGED_SPLIT_SWEEP = (2, 4, 8, 16)
PAGED_ENTRIES = {
    "paged_attention": ("deepspeed_tpu/ops/pallas/paged_attention.py:59",
                        "Llama-3-8B decode q [8, 1, 32, 128], 8 kv heads, lens 1-1000, bf16 pool"),
    "paged_attention_quant": ("deepspeed_tpu/ops/pallas/paged_attention.py:94",
                              "decode q [8, 1, 32, 128] bf16, int8 pool, lens 1-1000"),
    "paged_attention_alibi": ("deepspeed_tpu/ops/pallas/paged_attention.py:124",
                              "Bloom-7B1 decode q [8, 1, 32, 128], 32 kv heads, bf16 pool, lens 1-1000"),
}


def time_paged(dev, checks, launches, max_err, timing, flush):
    """The paged kernel at the decode and prefill shapes of rows 2, 2q and 2a:
    its forms ("split", W, S) by name and SDPA on K/V gathered (and
    dequantised) beforehand, the ALiBi bias as a float mask, timed in turns
    (``PAGED_TURN_ROUNDS`` palindromes, a cold L2 before each call), beside
    the bound and the plain version; then the crossover sweep of forms
    "split" and W (``PAGED_SWEEP``) and form "split"'s split counts at the
    decode batches (``PAGED_SPLIT_SWEEP``, beside the plan's). Returns the
    kernel line's three entries: the form the wrapper picks at decode, with
    the prefill's beside it."""
    for name, label, key, kv, alibi in PAGED_TIME_SETS:
        batch, lens = checks[key]
        b = paged_pools(batch, kv, alibi=alibi)
        N, C, H, hd = b["q"].shape
        nbytes, flops = paged_bytes_and_flops(b, lens)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        kd, vd, qd, mask = dense_sdpa_operands(b, lens)
        if alibi:
            mask = alibi_sdpa_mask(b, mask)
        fns = {form: functools.partial(pa_mod._paged_attention_form, form=form, **b)
               for form in PAGED_FORMS if pa_mod.form_takes(form, b["q"].dtype, hd, b["block_size"])}
        fns["sdpa"] = functools.partial(F.scaled_dot_product_attention, qd, kd, vd, attn_mask=mask)
        readings = {}
        got = time_turns(fns, iters=50, rounds=PAGED_TURN_ROUNDS, readings=readings, flush=flush)
        picked = pa_mod.paged_form(b["q"].dtype, hd, C, H // b["pool_k_l"].shape[1], b["block_size"])
        t = {"form": picked, "ms": got[picked], "forms_ms": {f: got[f] for f in PAGED_FORMS if f in got},
             "library_ms": got["sdpa"], "turns_ms": readings,
             "plain_ms": time_fn(lambda: paged_attention_reference(**b), iters=20, flush=flush),
             "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "shape": f"q {list(b['q'].shape)}, {b['pool_k_l'].shape[1]} kv heads, {kv or 'bf16'} pool"
                      f"{', ALiBi' if alibi else ''}",
             # the picked form and SDPA with the L2 warm, back to back: what a
             # cold read costs beside the kernel's own work
             "warm_ms": {f: time_fn(fns[f], iters=100) for f in (picked, "sdpa")}}
        timing[f"{name}[{label}]"] = t
        log(f"[time] {name} {label} {t['shape']}, in turns: " + ", ".join(
            f"{f} {ms:.4f} ms" for f, ms in got.items()) + f"; the wrapper picks {picked}; plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes / 1e6:.2f} "
            f"MB, {flops / 1e9:.3f} GFLOP); {picked} / SDPA {got[picked] / got['sdpa']:.3f}; L2 warm: "
            + ", ".join(f"{f} {ms:.4f} ms" for f, ms in t["warm_ms"].items()))
        del kd, vd, qd, mask, fns, b
    sweep = {}
    rng = np.random.default_rng(5)
    for kvH, C in PAGED_SWEEP:
        lens = [max(n, C) for n in (1, 17, 100, 250, 511, 512, 777, 1000)]
        b, lens = paged_batch(dev, rng, lens=lens, new_lens=[C] * 8, kvH=kvH)
        got = time_turns({f: functools.partial(pa_mod._paged_attention_form, form=f, **b)
                          for f in ("split", "wgmma")}, iters=50, flush=flush)
        rows = C * 32 // kvH
        sweep[f"G={32 // kvH} C={C}"] = dict(got, rows=rows, picked=pa_mod.paged_form(
            torch.bfloat16, 128, C, 32 // kvH, 16))
        log(f"[time] paged crossover G = {32 // kvH}, C = {C} ({rows} (c, g) rows): split "
            f"{got['split']:.4f} ms, W {got['wgmma']:.4f} ms; faster "
            f"{min(got, key=got.get)}; the wrapper picks {sweep[f'G={32 // kvH} C={C}']['picked']}")
        del b
    timing["paged_attention[crossover]"] = sweep
    splits_sweep = {}
    for tag, key, kv in (("llama bf16", "decode C=1, lens 1-1000", None),
                         ("llama int8", "decode C=1, lens 1-1000", "int8"),
                         ("bloom bf16", "bloom decode C=1, lens 1-1000", None),
                         ("bloom int8", "bloom decode C=1, lens 1-1000", "int8")):
        b = paged_pools(checks[key][0], kv, alibi=tag.startswith("bloom"))
        got = time_turns({f"splits={n}": functools.partial(pa_mod._paged_attention_form, form="split",
                                                           splits=n, **b)
                          for n in PAGED_SPLIT_SWEEP}, iters=50, flush=flush)
        N, kvH, P = b["q"].shape[0], b["pool_k_l"].shape[1], b["block_tables"].shape[1]
        planned = pa_mod.split_plan(N, kvH, P, torch.cuda.get_device_properties(dev).multi_processor_count,
                                    kv is None)[0]
        splits_sweep[tag] = dict(got, planned=planned)
        log(f"[time] paged split count sweep {tag} (P {P}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in got.items()) + f"; the plan takes {planned}")
        del b
    timing["paged_attention[split sweep]"] = splits_sweep
    entries = []
    for name, (replaces, shape) in PAGED_ENTRIES.items():
        dec = timing[f"{name}[{'int8 decode' if name == 'paged_attention_quant' else 'decode'}]"]
        pre = timing[f"{name}[{'int8 prefill' if name == 'paged_attention_quant' else 'prefill'}]"]
        entries.append(dict(
            name=name, route="cuda", source="deepspeed_tpu_torch/csrc/paged_attention.cu",
            replaces=replaces, launches=launches[name], max_abs_err=max_err[name], shape=shape,
            form=dec["form"], forms_ms=dec["forms_ms"],
            launches_by_form=launches["paged_by_form"][name],
            prefill={k: pre[k] for k in ("shape", "form", "ms", "forms_ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            **{k: dec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))
    return entries


def grouped_library_call(lhs, rhs, gs):
    """(label, fn) of the library yardstick: ``torch._grouped_mm`` (bf16, the
    groups' end offsets) where this PyTorch has it, else a loop of one cuBLAS
    matmul per group, each with its own host-read row range."""
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        return "torch._grouped_mm", lambda: torch._grouped_mm(lhs, rhs, offs=offs)
    bounds = np.concatenate([[0], np.cumsum(gs.tolist())])

    def loop():
        return [lhs[a:b] @ rhs[g] for g, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]
    return "per-group cuBLAS loop", loop


def time_turns(fns, iters, rounds=1, readings=None, flush=None):
    """Each function of ``fns`` timed twice a round by ``time_fn`` (with
    ``flush`` before each call, if given), in the order given and then in
    reverse (a b c c b a), on one card: the mean of its readings.
    ``readings``, if given, receives each one's list."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name in list(fns) + list(reversed(fns)):
            got[name].append(time_fn(fns[name], iters=iters, flush=flush))
    if readings is not None:
        readings.update(got)
    return {name: sum(ts) / len(ts) for name, ts in got.items()}


def grouped_bound(sizes, m, K, N):
    """(bound ms, bound by, bytes, operations) of one grouped product: lhs and
    the output once, the weights of every group with rows."""
    nbytes = 2 * (m * K + sum(1 for n in sizes if n) * K * N + m * N)
    flops = 2 * m * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, flops


def grouped_form_fns(lhs, rhs, gs):
    """{form: call} for the bf16 forms, each through ``_grouped_matmul_form``."""
    return {form: functools.partial(gmm_mod._grouped_matmul_form, lhs, rhs, gs, form)
            for form in ("wgmma", "stream", "mma")}


def time_grouped(dev, launches, max_err, timing):
    """The grouped GEMM at Mixtral-8x7B's up projection (K 4096, N 14336,
    bf16): a prefill (8192 routed rows: top-2 routing of 4096 tokens) and a
    decode (32 routed rows: 16 tokens), forms P ("wgmma") and D ("stream"),
    the mma.sync form ("mma") and the library call timed in turns, beside the
    bound and the plain version; then the crossover sweep: every form and the
    library call at 32-512 routed rows over the up and down projections.
    Returns the kernel line's entry: the form the wrapper picks at each
    shape, with its times."""
    K, N = GMM_SHAPES["up"]
    for label, tokens in (("prefill", 4096), ("decode", 16)):
        sizes = routed_group_sizes(tokens)
        lhs, rhs, gs = grouped_inputs(dev, sizes, K, N, torch.bfloat16)
        m = lhs.shape[0]
        bound, bound_by, nbytes, flops = grouped_bound(sizes, m, K, N)
        picked = gmm_mod.pick_form(torch.bfloat16, m, K, N, True)
        lib_name, lib_fn = grouped_library_call(lhs, rhs, gs)
        forms = time_turns(dict(grouped_form_fns(lhs, rhs, gs), library=lib_fn), iters=40)
        t = {"form": picked, "ms": forms[picked], "forms_ms": forms,
             "plain_ms": time_fn(lambda: gmm_mod.grouped_matmul_plain(lhs, rhs, gs), iters=20),
             "library_ms": forms.pop("library"), "library": lib_name, "bound_ms": bound,
             "bound_by": bound_by}
        timing[f"grouped_matmul[{label}]"] = t
        log(f"[time] grouped_matmul {label} [{m}, {K}] x [8, {K}, {N}] bf16, sizes {list(sizes)}: "
            + ", ".join(f"form {f} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                        f"{nbytes / ms / 1e9:.3f} TB/s)" for f, ms in forms.items())
            + f"; the wrapper picks {picked}; plain {t['plain_ms']:.4f} ms, {lib_name} "
            f"{t['library_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e12:.4f} TFLOP)")
        del lhs, rhs, gs, lib_fn
        torch.cuda.empty_cache()
    sweep = {}
    for proj, (K, N) in GMM_SHAPES.items():
        for tokens in GMM_SWEEP_TOKENS:
            sizes = routed_group_sizes(tokens)
            lhs, rhs, gs = grouped_inputs(dev, sizes, K, N, torch.bfloat16)
            m = lhs.shape[0]
            bound, bound_by, _, _ = grouped_bound(sizes, m, K, N)
            lib_name, lib_fn = grouped_library_call(lhs, rhs, gs)
            t = time_turns(dict(grouped_form_fns(lhs, rhs, gs), library=lib_fn), iters=40)
            picked = gmm_mod.pick_form(torch.bfloat16, m, K, N, True)
            fastest = min(("wgmma", "stream"), key=t.get)
            sweep[f"{proj} m={m}"] = dict(t, bound_ms=bound, bound_by=bound_by, picked=picked,
                                          faster_tma_form=fastest)
            log(f"[time] grouped_matmul crossover {proj} [{m}, {K}] x [8, {K}, {N}] sizes "
                f"{list(sizes)}: " + ", ".join(f"{f} {ms:.4f}" for f, ms in t.items())
                + f" ms, bound {bound:.4f} ({bound_by}); faster of P and D: {fastest}; the "
                f"wrapper picks {picked} (GMM_DECODE_MAX_ROWS {gmm_mod.GMM_DECODE_MAX_ROWS})")
            del lhs, rhs, gs, lib_fn
            torch.cuda.empty_cache()
    timing["grouped_matmul[crossover]"] = sweep
    d, dec = timing["grouped_matmul[prefill]"], timing["grouped_matmul[decode]"]
    for label, t in (("prefill", d), ("decode", dec)):
        log(f"[time] grouped_matmul {label}: the picked form {t['form']} {t['ms']:.4f} ms against "
            f"the mma.sync form {t['forms_ms']['mma']:.4f} ms "
            f"({'faster' if t['ms'] < t['forms_ms']['mma'] else 'NOT faster'})")
    return dict(name="grouped_matmul", route="cuda", source="deepspeed_tpu_torch/csrc/grouped_gemm.cu",
                replaces="deepspeed_tpu/inference/model.py:234", launches=launches["grouped_matmul"],
                max_abs_err=max_err["grouped_matmul"],
                shape="Mixtral-8x7B up projection [8192, 4096] x [8, 4096, 14336] bf16, top-2 "
                      "routed sizes",
                form=d["form"], mma_ms=d["forms_ms"]["mma"],
                decode={"shape": "[32, 4096] x [8, 4096, 14336] bf16", "form": dec["form"],
                        "mma_ms": dec["forms_ms"]["mma"],
                        **{k: dec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")}},
                **{k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})


def phase_time(dev, checks, launches, max_err, results):
    """Phase 7: per-kernel device times at the main path's shapes."""
    l2_flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)

    def flush():
        l2_flush_buf.zero_()

    kernels = []
    timing = {}
    for rows in (8, 8 * 1008):  # one decode step; the 8-prompt prefill step
        x = torch.randn(rows, 4096, device=dev, dtype=torch.bfloat16)
        s = torch.ones(4096, device=dev, dtype=torch.bfloat16)
        nbytes = 2 * x.numel() * 2 + s.numel() * 2
        flops = 4 * x.numel()
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]) * 1e3
        lib = None
        if hasattr(F, "rms_norm"):
            lib = time_fn(lambda: F.rms_norm(x, (4096,), s, 1e-5))
        t = {"ms": time_fn(lambda: pallas_rms_norm(x, s, 1e-5)),
             "plain_ms": time_fn(lambda: rms_norm_reference(x, s, 1e-5)),
             "bound_ms": bound, "library_ms": lib}
        timing[f"rms_norm[{rows},4096]"] = t
        log(f"[time] rms_norm [{rows}, 4096] bf16: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, F.rms_norm {lib if lib is None else round(lib, 4)} ms, "
            f"bound {bound:.4f} ms (bytes)")
    kernels.append(dict(name="rms_norm", route="cuda", source="deepspeed_tpu_torch/csrc/rms_norm.cu",
                        replaces="deepspeed_tpu/ops/pallas/norms.py:32",
                        launches=launches["rms_norm"], max_abs_err=max_err["rms_norm"],
                        bound_by="bytes", shape="[8, 4096] bf16",
                        **{k: timing["rms_norm[8,4096]"][k]
                           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}))

    for rows in (8, 8 * 1008):  # Bloom-7B1's width: one decode step; the 8-prompt prefill
        x = torch.randn(rows, 4096, device=dev, dtype=torch.bfloat16) * 3 + 1
        s = (1 + 0.1 * torch.randn(4096, device=dev)).to(torch.bfloat16)
        b = (0.1 * torch.randn(4096, device=dev)).to(torch.bfloat16)
        # bytes: x read, y written, scale and bias read once; operations:
        # ~8 fp32 a element (sum, subtract, square-add, subtract, two
        # multiplies, add, convert)
        nbytes = 2 * x.numel() * 2 + 2 * 4096 * 2
        flops = 8 * x.numel()
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]) * 1e3
        t = {"ms": time_fn(lambda: pallas_layer_norm(x, s, b, 1e-5)),
             "plain_ms": time_fn(lambda: layer_norm_reference(x, s, b, 1e-5)),
             "library_ms": time_fn(lambda: F.layer_norm(x, (4096,), s, b, 1e-5)),
             "bound_ms": bound}
        timing[f"layer_norm[{rows},4096]"] = t
        log(f"[time] layer_norm [{rows}, 4096] bf16: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, F.layer_norm {t['library_ms']:.4f} ms, bound {bound:.4f} ms "
            f"(bytes: {nbytes / 1e6:.2f} MB; {nbytes / t['ms'] / 1e6:.1f} GB/s)")
    kernels.append(dict(name="layer_norm", route="cuda",
                        source="deepspeed_tpu_torch/csrc/layer_norm.cu",
                        replaces="deepspeed_tpu/ops/pallas/norms.py:39",
                        launches=launches["layer_norm"], max_abs_err=max_err["layer_norm"],
                        bound_by="bytes", shape="[8064, 4096] bf16",
                        **{k: timing["layer_norm[8064,4096]"][k]
                           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}))
    del x, s, b

    kernels += time_paged(dev, checks, launches, max_err, timing, flush)

    # the quantisers at a w_up layer slice, bf16 (what WOQ quantises and reads)
    x = torch.randn(W_UP_SLICE, device=dev, dtype=torch.bfloat16) * 0.02
    q, s = quant_mod.quantize_int8(x)
    n, nb = x.numel(), s.numel()
    calls = {
        "quantize_int8": (lambda: quant_mod.quantize_int8(x),
                          lambda: quant_mod.quantize_int8_reference(x),
                          2 * n + n + 4 * nb, 4 * n, ":38"),
        "quantize_int8_stochastic": (
            lambda: quant_mod.quantize_int8(x, stochastic=True, seed=1),
            lambda: quant_mod.quantize_int8_stochastic_reference(x, seed=1),
            2 * n + n + 4 * nb, 20 * n, ":46"),
        "dequantize_int8": (lambda: quant_mod.dequantize_int8(q, s, x.shape, torch.bfloat16),
                            lambda: quant_mod.dequantize_int8_reference(q, s, x.shape, torch.bfloat16),
                            n + 4 * nb + 2 * n, n, ":60"),
    }
    for name, (kernel_fn, plain_fn, nbytes, ops, line) in calls.items():
        # bytes: each input read once, each output written once; operations
        # (abs, max, divide, round per element; the hash's ~16 integer ops
        # more for the stochastic form; one multiply to dequantise) at the
        # fp32 rate, far below the bytes' time
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[torch.float32] * 1e3
        t = {"ms": time_fn(kernel_fn, iters=50, flush=flush),
             "plain_ms": time_fn(plain_fn, iters=5, warmup=2, flush=flush),
             "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None}
        timing[f"{name}{list(W_UP_SLICE)}"] = t
        log(f"[time] {name} {list(W_UP_SLICE)} bf16: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"no library call, bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes / 1e6:.2f} MB; "
            f"{nbytes / t['ms'] / 1e6:.1f} GB/s)")
        kernels.append(dict(name=name, route="cuda", source="deepspeed_tpu_torch/csrc/quantizer.cu",
                            replaces=f"deepspeed_tpu/ops/pallas/quantizer.py{line}",
                            launches=launches[name], max_abs_err=0.0,
                            shape=f"w_up layer slice {list(W_UP_SLICE)} bf16",
                            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}))
    del x, q, s

    # the flash kernels at the llama3-1b training shape, and their ALiBi form
    # at Bloom-560M's, bf16, no keep-mask
    kernels += time_flash(dev, launches, max_err, timing)
    kernels += time_flash(dev, launches, max_err, timing, alibi=True)
    kernels += time_sparse(dev, launches, max_err, timing)
    kernels.append(time_grouped(dev, launches, max_err, timing))
    kernels += time_collective_kernels(dev, launches, max_err, results["collectives"]["chunk"],
                                       timing)
    kernels += time_fused_kernels(dev, launches, max_err, timing,
                                  results["fused"]["launches_by_form"])
    results["timing"] = timing
    return kernels

# ------------------------------------------------------------------ collectives
def collective_launches(op, alg, codec, n):
    """Kernel launches of one collective over ``n`` ranks, from its schedule
    (summed over the ranks). A ring reduce-scatter over m ranks: with a
    fusable wire (int8/fp8, pallas) one fused hop to encode and m - 1 to
    move a rank; with an exact wire m - 1 permute_leaves a rank; unfused
    int8 encodes (row 7) and decodes (row 8) at each of m - 1 hops. A ring
    all-gather over m ranks: m - 1 permute_leaves a rank (pallas); int8
    encodes once and decodes m times (its own row too). The ring2d
    all-reduce on 2 x 2: reduce-scatters over b = 2 and a = 2, gathers over
    a and b. The all-to-all: a fusable wire n fused hops a rank, else n - 1
    permute_leaves and, for int8, one encode and n - 1 decodes."""
    pallas, fused = alg.startswith("pallas_"), codec in ("int8", "fp8")
    c = {"permute_leaves": 0, "fused_hop": 0, "quantize_int8": 0, "dequantize_int8": 0}

    def rs(m):
        if pallas and fused:
            c["fused_hop"] += n * m
            return
        c["permute_leaves"] += n * (m - 1) if pallas else 0
        if codec == "int8":
            c["quantize_int8"] += n * (m - 1)
            c["dequantize_int8"] += n * (m - 1)

    def gather(m):
        c["permute_leaves"] += n * (m - 1) if pallas else 0
        if codec == "int8":
            c["quantize_int8"] += n
            c["dequantize_int8"] += n * m

    if op == "all_reduce":
        if alg.endswith("ring2d"):
            a, b = 2, 2
            rs(b), rs(a), gather(a), gather(b)
        else:
            rs(n), gather(n)
    elif op == "all_gather":
        gather(n)
    elif pallas and fused:
        c["fused_hop"] += n * n
    else:
        c["permute_leaves"] += n * (n - 1) if pallas else 0
        if codec == "int8":
            c["quantize_int8"] += n
            c["dequantize_int8"] += n * (n - 1)
    return c


def rank_gradients(dev, cfg, n, seq):
    """Rank r's gradients of ``cfg`` from one real backward of the port's
    model on rank r's seeded batch (1 x seq), in fp32 as the engine holds its
    master gradients, leaf by leaf as the engine's autograd leaves (one per
    layer); and the flat bf16 compute weights. Returns (grads[leaf][rank],
    leaf names, flat weights)."""
    masters = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=causal_lm_spec(cfg, example_seq_len=seq),
        config=dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=1, gradient_accumulation_steps=1),
        model_parameters=masters, device=dev)
    del masters
    tree, leaves, index = engine._compute_params()
    grads = [[] for _ in leaves]
    for r in range(n):
        ids = np.random.default_rng(100 + r).integers(0, cfg.vocab_size, (1, seq), dtype=np.int32)
        out = engine.model.loss_fn(tree, {"input_ids": torch.from_numpy(ids).to(dev)})
        loss = out[0] if isinstance(out, tuple) else out
        for i, g in enumerate(torch.autograd.grad(loss.float(), leaves, allow_unused=True,
                                                  materialize_grads=True)):
            grads[i].append(g.detach().float())
        del out, loss
    names = [path if layer is None else f"{path}[{layer}]" for path, layer in index]
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    del tree, leaves, engine
    gc.collect()
    torch.cuda.empty_cache()
    return grads, names, flat


def run_collective(op, xs, group, alg, codec):
    if op == "all_reduce":
        return comm.all_reduce(xs, group, op="mean", algorithm=alg, codec=codec)
    if op == "all_gather":
        return comm.all_gather(xs, group, algorithm=alg, codec=codec)
    return comm.all_to_all(xs, group, split_axis=0, concat_axis=0, algorithm=alg, codec=codec)


def error_vs_exact(op, codec, got0, xs, n):
    """Rank 0's result against the exact one: (the largest error as a share
    of the exact result's largest magnitude, whether it passes). An exact
    mean must lie within n fp32 ulps of the sum of |x| over the ranks of
    the float64 mean; an exact gather or all-to-all must equal its pieces
    bit for bit, piece by piece (no float64 copy of a 1.5 B-element gather);
    a lossy wire must stay within ``COLL_LOSSY_BOUND``."""
    if op == "all_reduce":
        exact = sum(x.double() for x in xs) / n
        err = (got0.double() - exact).abs()
        rel = float(err.max()) / (float(exact.abs().max()) or 1.0)
        if codec != "none":
            return rel, rel < COLL_LOSSY_BOUND[op][codec]
        slack = n * 2.0 ** -24 * sum(x.double().abs() for x in xs) / n + 2.0 ** -149
        return rel, bool((err <= slack).all())
    pieces = got0.chunk(n)  # by source rank
    want = xs if op == "all_gather" else [x.chunk(n)[0] for x in xs]
    if codec == "none":
        same = all(bits_differ([p], [w]) == 0 for p, w in zip(pieces, want))
        return (0.0 if same else math.inf), same
    scale = max(float(w.abs().max()) for w in want) or 1.0
    rel = max(float((p.float() - w.float()).abs().max()) for p, w in zip(pieces, want)) / scale
    return rel, rel < COLL_LOSSY_BOUND[op][codec]


def check_collective(tag, op, alg, codec, xs, group, stats, max_err, repeat=1):
    """One collective through the kernels, ``repeat`` times (the last timed:
    a first call of a shape pays the rank streams' allocations), and through
    the plain versions on the card: equal bit for bit, every rank's bytes
    equal after an all-reduce or all-gather, an exact wire equal to the
    float64 result within fp32 rounding (the mean) or exactly, a lossy one
    within ``COLL_LOSSY_BOUND``. Returns a failure string or None."""
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_collective(op, xs, group, alg, codec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with plain_collective_kernels():
        want = run_collective(op, xs, group, alg, codec)
    differ = bits_differ(got, want)
    worst = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    del want
    for name in COLL_KERNELS:
        if collective_launches(op, alg, codec, group.n)[name]:
            max_err[name] = max(max_err[name], worst)
    replicas = 0 if op == "all_to_all" else sum(bits_differ([g], [got[0]]) for g in got)
    rel, good = error_vs_exact(op, codec, got[0], xs, group.n)
    if op == "all_to_all":  # the own block never crosses a link
        own = xs[0].chunk(group.n)[0]
        good = good and bits_differ([got[0][:own.shape[0]]], [own]) == 0
    st = stats.setdefault(tag, {"wall_s": 0.0, "calls": 0, "bits_differ": 0, "replicas_differ": 0,
                                "max_rel_err_vs_exact": 0.0, "largest_ms": 0.0, "largest_numel": 0})
    st["wall_s"] += wall
    st["calls"] += 1
    st["bits_differ"] += differ
    st["replicas_differ"] += replicas
    st["max_rel_err_vs_exact"] = max(st["max_rel_err_vs_exact"], rel)
    if xs[0].numel() > st["largest_numel"]:
        st["largest_numel"], st["largest_ms"] = xs[0].numel(), wall * 1e3
    del got
    if differ or replicas or not good:
        return (f"{tag}: {differ} elements differ from the plain versions (max abs {worst:.3e}), "
                f"{replicas} replica elements differ, rel err vs exact {rel:.3e}")
    return None


def phase_collectives(dev, max_err, results):
    """The collectives phase: 4 ranks of one ``RankGroup`` on the card, at
    full width. (a) the data-parallel gradient all-reduce of llama3-1b
    (rank r's fp32 gradients from a backward on its own batch), leaf by
    leaf, ``op="mean"``, each of ``GRAD_WAYS``; (b) the ZeRO-3 parameter
    all-gather of the flat bf16 weights, a quarter a rank, each of
    ``GATHER_WAYS``; (c) the MoE dispatch all-to-all at Mixtral-8x7B's
    width, each of ``A2A_WAYS``; (b) and (c) twice, the second call timed.
    Every collective is held to the same call
    through the plain versions and to the exact result (``check_collective``);
    the counters are zeroed just before (a) and read just after (c) and
    must equal ``collective_launches`` summed over the calls. Returns the
    launch counts, or None on failure."""
    cfg = dataclasses.replace(PRESETS[COLL_PRESET], dtype=torch.bfloat16)
    n = COLL_RANKS
    t0 = time.perf_counter()
    grads, names, flat = rank_gradients(dev, cfg, n, COLL_SEQ)
    sizes = [g[0].numel() for g in grads]
    log(f"[coll] {COLL_PRESET} gradients of {n} ranks (micro 1 x {COLL_SEQ}, seeds 100-{99 + n}): "
        f"{len(grads)} leaves, {sum(sizes) / 1e9:.4f} B elements ({4 * sum(sizes) / 1e9:.2f} GB "
        f"fp32 a rank), largest {names[int(np.argmax(sizes))]} {max(sizes) / 1e6:.1f} M, in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    group = comm.RankGroup("dp", n, device=dev)
    stats, failures, expect = {}, [], {}

    def add_expect(op, alg, codec, calls):
        for k, v in collective_launches(op, alg, codec, n).items():
            expect[k] = expect.get(k, 0) + v * calls

    zero_counts()
    for i, leaf in enumerate(grads):
        for alg, codec in GRAD_WAYS:
            err = check_collective(f"all_reduce {alg} {codec}", "all_reduce", alg, codec, leaf,
                                   group, stats, max_err)
            if err:
                failures.append(f"{names[i]}: {err}")
        grads[i] = None
    for alg, codec in GRAD_WAYS:
        add_expect("all_reduce", alg, codec, len(names))
    del grads
    torch.cuda.empty_cache()
    shard = -(-flat.numel() // n)
    shards = list(torch.nn.functional.pad(flat, (0, shard * n - flat.numel())).chunk(n))
    del flat
    for alg, codec in GATHER_WAYS:
        err = check_collective(f"all_gather {alg} {codec}", "all_gather", alg, codec, shards, group,
                               stats, max_err, repeat=2)
        failures += [err] if err else []
        add_expect("all_gather", alg, codec, 2)
    del shards
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(3)
    rows = [torch.randn(MOE_A2A_ROWS, generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(n)]
    for alg, codec in A2A_WAYS:
        err = check_collective(f"all_to_all {alg} {codec}", "all_to_all", alg, codec, rows, group,
                               stats, max_err, repeat=2)
        failures += [err] if err else []
        add_expect("all_to_all", alg, codec, 2)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = dict({k: 0 for k in launches}, **expect)
    for tag, st in stats.items():
        log(f"[coll] {tag}: {st['calls']} calls, wall {st['wall_s']:.4f} s (largest, "
            f"{st['largest_numel'] / 1e6:.1f} M elements a rank: {st['largest_ms']:.3f} ms); "
            f"kernels vs plain: {st['bits_differ']} elements differ; replicas: "
            f"{st['replicas_differ']} differ; max rel err vs exact {st['max_rel_err_vs_exact']:.3e}")
    log(f"[coll] launches {launches} (expected {want})")
    # one profiled pallas_ring int8 all-reduce of the embedding's gradient:
    # the wall not covered by kernels is the ranks' event waits and the
    # host's launch gaps
    emb = [torch.randn(max(sizes), generator=g, device=dev) for _ in range(n)]
    wall, busy, plain_wall, top = device_profile(
        lambda: comm.all_reduce(emb, group, op="mean", algorithm="pallas_ring", codec="int8"))
    prof = log_profile("coll", f"a pallas_ring int8 all-reduce of {max(sizes) / 1e6:.1f} M elements "
                       f"a rank (kernel time summed over the {n} ranks' streams)", wall, busy,
                       plain_wall, top)
    del emb, rows
    torch.cuda.empty_cache()
    results["collectives"] = {"ranks": n, "preset": COLL_PRESET, "leaves": len(names),
                              "elements": sum(sizes), "largest_leaf": max(sizes), "stats": stats,
                              "launches": launches, "expected": want, "profile": prof}
    if failures:
        log(f"[coll] FAILED: {failures[:10]}")
        return None
    if launches != want or not all(launches[k] for k in COLL_KERNELS):
        log("[coll] FAILED: launch counts do not match the schedules")
        return None
    results["collectives"]["chunk"] = -(-max(sizes) // n)
    return launches


def time_collective_kernels(dev, launches, max_err, chunk, timing):
    """Rows 12 and 13 at the largest leaf's chunk (its reduce-scatter rows):
    the int8 wire's relay and one fused int8 hop, bytes read and written in
    HBM against 3.35 TB/s (every rank shares the one card); the NVLink bound
    of a 4-card run (the wire bytes at 450 GB/s each way) stated, not
    measured."""
    C, B, qb = hop_mod._chunk_geometry(chunk, get_codec("int8").block_size)
    Lp = C * B
    nb = Lp // qb
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(Lp, generator=g, device=dev) * 3
    q, s = get_codec("int8").encode_rows(x[None])
    wire = [q[0].contiguous(), s[0].contiguous()]
    copies = [torch.empty_like(t) for t in wire]
    nbytes = 2 * sum(t.numel() * t.element_size() for t in wire)
    kernels = []
    t = {"ms": time_fn(lambda: hop_mod.permute_leaves(wire, dev), iters=50),
         "plain_ms": time_fn(lambda: hop_mod.permute_leaves_plain(wire, dev), iters=50),
         "library_ms": time_fn(lambda: [c.copy_(w) for c, w in zip(copies, wire)], iters=50),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "nvlink_bound_ms": nbytes / 2 / NVLINK_BYTES_PER_S * 1e3}
    timing[f"permute_leaves[int8 wire {Lp}]"] = t
    log(f"[time] permute_leaves int8 wire of {Lp} codes + {nb} scales: kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, Tensor.copy_ {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms (bytes: {nbytes / 1e6:.2f} MB in HBM; "
        f"{nbytes / t['ms'] / 1e6:.1f} GB/s); a 4-card NVLink hop's bound "
        f"{t['nvlink_bound_ms']:.4f} ms (not measured)")
    kernels.append(dict(name="permute_leaves", route="cuda",
                        source="deepspeed_tpu_torch/csrc/ring_hop.cu",
                        replaces="deepspeed_tpu/collectives/pallas_backend.py:237",
                        launches=launches["permute_leaves"], max_abs_err=max_err["permute_leaves"],
                        shape=f"int8 wire [{Lp}] + scales [{nb}]",
                        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))
    y = torch.empty_like(x)
    t32 = {"ms": time_fn(lambda: hop_mod.permute_leaves([x], dev), iters=20),
           "library_ms": time_fn(lambda: y.copy_(x), iters=20),
           "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3}
    timing[f"permute_leaves[fp32 wire {Lp}]"] = t32
    log(f"[time] permute_leaves fp32 wire of {Lp}: kernel {t32['ms']:.4f} ms, Tensor.copy_ "
        f"{t32['library_ms']:.4f} ms, bound {t32['bound_ms']:.4f} ms")

    tgt = torch.randn(Lp, generator=g, device=dev)
    own_q, own_s = torch.empty_like(wire[0]), torch.empty_like(wire[1])
    hop = lambda: hop_mod.fused_hop(wire[0], wire[1], tgt, tgt, own_q, own_s, qb=qb)
    plain = lambda: hop_mod.fused_hop_plain(wire[0], wire[1], tgt, tgt, own_q, own_s, qb=qb)
    nbytes = (Lp + 4 * nb) + 2 * 4 * Lp + (Lp + 4 * nb)  # wire in, row read and written, wire out
    flops = 8 * Lp  # multiply, add, abs, max, divide, round, clip, convert
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.float32] * 1e3
    t = {"ms": time_fn(hop, iters=50), "plain_ms": time_fn(plain, iters=10, warmup=2),
         "library_ms": None, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "nvlink_bound_ms": (Lp + 4 * nb) / NVLINK_BYTES_PER_S * 1e3}
    timing[f"fused_hop[int8 {Lp}, qb {qb}]"] = t
    log(f"[time] fused_hop int8 accumulate + requantise, row of {Lp} (qb {qb}): kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, no library call on one card (NCCL's "
        f"all-reduce on a multi-card machine), bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
        f"{nbytes / 1e6:.2f} MB; {nbytes / t['ms'] / 1e6:.1f} GB/s); a 4-card NVLink hop's bound "
        f"{t['nvlink_bound_ms']:.4f} ms (not measured)")
    kernels.append(dict(name="fused_hop", route="cuda", source="deepspeed_tpu_torch/csrc/ring_hop.cu",
                        replaces="deepspeed_tpu/collectives/pallas_backend.py:321",
                        launches=launches["fused_hop"], max_abs_err=max_err["fused_hop"],
                        shape=f"int8, row [{Lp}], qb {qb}",
                        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))
    return kernels

# ------------------------------------------------------------------ fused GEMM collectives
def fused_payload(shape, ints, g, dev):
    if ints:
        return torch.randint(-4, 5, shape, generator=g, device=dev).float()
    return torch.randn(shape, generator=g, device=dev)


def check_fused_hops(dev, max_err):
    """Rows 14 and 15 one launch at a time, each form by name (form T
    "wgmma" and form S "simt"), against their plain versions on the same
    inputs, at the phase's shapes (rank 2's hop: the shard held at column
    block 2), every wire, integer and normal payloads: products bit for bit
    on integers, else by ``fused_gemm_close``; the received shard and every
    code and scale bit for bit (row 15's codes against the plain block math
    of the kernel's own partial). Returns failure strings."""
    n, (M, H), (_, F) = FUSED_RANKS, FUSED_X, FUSED_W_UP
    Ks = FUSED_W_UP[0] // n
    Kr, Nr = FUSED_W_ROW
    Mb = M // n
    g = torch.Generator(device=dev).manual_seed(11)
    failures, shares = [], {}
    for ints in (True, False):
        for kind in FUSED_WIRES:
            tag = f"{'ints' if ints else 'normal'} {kind}"
            held = fused_payload((Ks, F), ints, g, dev)
            up_vals = fused_payload((Ks, F), ints, g, dev)
            qb = fused_gemm_qb(kind, Ks, F)
            up = block_wire(kind, up_vals, qb)
            for out_block in (False, True):
                x = fused_payload((M, F) if out_block else (M, H), ints, g, dev)
                y0 = fused_payload((M, H) if out_block else (M, F), ints, g, dev)

                def run(fn, **kw):
                    y, recv = y0.clone(), torch.empty(Ks, F, device=dev)
                    own = None if kind == "none" else (torch.empty_like(up[0]),
                                                       torch.empty_like(up[1]))
                    fn(x, held, y, 2 * Ks, up, recv, own, qb=qb, out_block=out_block, **kw)
                    return y, recv, own

                wy, wrecv, wown = run(fg_mod.ag_hop_plain)
                for form in fg_mod.FUSED_FORMS:
                    y, recv, own = run(fg_mod.ag_hop, form=form)
                    err, ok = fused_gemm_close(y, wy, F if out_block else Ks)
                    note_share(shares, f"ag_hop {form}", err, wy, F if out_block else Ks)
                    ok = ok and (not ints or bits_differ([y], [wy]) == 0)
                    ok = ok and bits_differ([recv], [wrecv]) == 0
                    ok = ok and (own is None or bits_differ(list(own), list(wown)) == 0)
                    max_err["ag_hop"] = max(max_err["ag_hop"], err)
                    if not ok:
                        failures.append(f"ag_hop {form} {'out_block' if out_block else 'accumulate'} "
                                        f"{tag}: max abs {err:.3e}")
                    del y, recv, own
                del x, y0, wy, wrecv, wown
            del held, up_vals, up
            x = fused_payload((M, Kr), ints, g, dev)
            w = fused_payload((Kr, Nr), ints, g, dev)
            qb = fused_gemm_qb(kind, Mb, Nr)
            up = block_wire(kind, fused_payload((Mb, Nr), ints, g, dev), qb)

            def run_rs(fn, **kw):
                part = torch.empty(Mb, Nr, device=dev)
                own = None if kind == "none" else (torch.empty(Mb * Nr, dtype=up[0].dtype, device=dev),
                                                   torch.empty(Mb * Nr // qb, device=dev))
                fn(x, w, Mb, up, part, own, qb=qb, **kw)
                return part, own

            wpart, wown = run_rs(fg_mod.rs_hop_plain)
            for form in fg_mod.FUSED_FORMS:
                part, own = run_rs(fg_mod.rs_hop, form=form)
                err, ok = fused_gemm_close(part, wpart, Kr)
                note_share(shares, f"rs_hop {form}", err, wpart, Kr)
                ok = ok and (not ints or bits_differ([part], [wpart]) == 0)
                if own is not None:
                    ok = ok and bits_differ(list(own), list(block_wire(kind, part, qb))) == 0
                    ok = ok and (not ints or bits_differ(list(own), list(wown)) == 0)
                max_err["rs_hop"] = max(max_err["rs_hop"], err)
                if not ok:
                    failures.append(f"rs_hop {form} {tag}: max abs {err:.3e}")
                del part, own
            del x, w, up, wpart, wown
    log("[fused] each form's largest error as a share of fused_gemm_close's absolute bound "
        "(1e-6 x sqrt(K) x max|want|): " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    return failures


def note_share(shares, key, err, want, K):
    """The largest ``err`` of ``key`` so far as a share of ``fused_gemm_close``'s
    absolute bound for ``want`` over K products."""
    atol = 1e-6 * max(float(want.abs().max()), 1.0) * K ** 0.5
    shares[key] = max(shares.get(key, 0.0), err / atol)


def fused_ops(group, xs, gs, ws, a, w_row, kind):
    """The three ops of the phase at one wire (``sharded_matmul``'s block):
    the forward and ``dx`` of ``sharded_matmul`` (both all_gather_matmul
    forms) and the row-parallel reduce-scatter."""
    kw = dict(codec=None if kind == "none" else kind, block_size=ZEROPP_BLOCK)
    return (fg_mod.all_gather_matmul(xs, ws, group, **kw),
            fg_mod.all_gather_matmul(gs, ws, group, out_block=True, **kw),
            fg_mod.matmul_reduce_scatter(a, w_row, group, **kw))


def fused_sgd(group, xs, ts, w_shards, steps, quantize=False):
    """``steps`` of ZeRO-3 SGD through ``sharded_matmul``: rank r's batch
    ``xs[r]``, the weight row-sharded; a rank's loss is its mean squared
    error. Returns (losses, the final shards)."""
    ws, losses = [w.clone() for w in w_shards], []
    for _ in range(steps):
        ws = [w.detach().requires_grad_() for w in ws]
        ys = sharded_matmul(xs, ws, group, quantize)
        per_rank = [((y - t) * (y - t)).mean() for y, t in zip(ys, ts)]
        sum(per_rank).backward()
        losses.append(sum(float(lv.detach()) for lv in per_rank))
        ws = [(w - FUSED_LR * w.grad).detach() for w in ws]
        del ys, per_rank
    return losses, ws


def phase_fused(dev, max_err, results):
    """The fused GEMM collectives with 4 ranks of one ``RankGroup`` on the
    card, at llama3-1b's MLP widths: rows 14-15 one launch at a time against
    their plain versions (``check_fused_hops``); the three ops through the
    kernels against the same ops through the plain versions, every wire
    (integer payloads: exact wires bit for bit and equal to the unfused
    product; lossy wires by ``fused_gemm_close``); then, with the counters zeroed
    just before and read just after, the main path: 3 steps of ZeRO-3 SGD
    through ``sharded_matmul`` (exact wire), one with ``quantize=True`` (the
    int8 wire) and ``row_parallel_linear`` with and without it; the launch
    counts must equal n - 1 a rank and op for rows 14-15 (and the rows 12-13
    launches that receive or encode outside them). The exact trajectory must
    fall and lie within ``FUSED_REL`` of the same steps unfused (knob off).
    Returns the launch counts, or None on failure."""
    n = FUSED_RANKS
    group = comm.RankGroup("tp", n, device=dev)
    t0 = time.perf_counter()
    failures = check_fused_hops(dev, max_err)
    log(f"[fused] rows 14-15, one launch each against the plain versions at x {list(FUSED_X)}, "
        f"w_up {list(FUSED_W_UP)} ({n} shards), w_row {list(FUSED_W_ROW)}, wires "
        f"{list(FUSED_WIRES)}, integer and normal payloads: {len(failures)} failures, max abs "
        f"err {max_err['ag_hop']:.3e} / {max_err['rs_hop']:.3e} ({time.perf_counter() - t0:.1f} s)")
    M, H = FUSED_X
    F = FUSED_W_UP[1]
    g = torch.Generator(device=dev).manual_seed(12)
    xs = [fused_payload((M, H), True, g, dev) for _ in range(n)]
    gs = [fused_payload((M, F), True, g, dev) for _ in range(n)]
    ws = list(fused_payload(FUSED_W_UP, True, g, dev).chunk(n))
    a = [fused_payload((M, FUSED_W_ROW[0]), True, g, dev) for _ in range(n)]
    w_row = [fused_payload(FUSED_W_ROW, True, g, dev) for _ in range(n)]
    fg_mod.configure(enabled=True)
    try:
        for kind in FUSED_WIRES:
            got = fused_ops(group, xs, gs, ws, a, w_row, kind)
            with plain_collective_kernels():
                want = fused_ops(group, xs, gs, ws, a, w_row, kind)
            for name, K, got_op, want_op in zip(("all_gather_matmul", "dx", "reduce_scatter"),
                                                 (FUSED_W_UP[0], F, FUSED_W_ROW[0]), got, want):
                key = "rs_hop" if name == "reduce_scatter" else "ag_hop"
                errs = [fused_gemm_close(a_, b_, K) for a_, b_ in zip(got_op, want_op)]
                err = max(e for e, _ in errs)
                max_err[key] = max(max_err[key], err)
                bad = bits_differ(got_op, want_op) if kind == "none" else 0
                if bad or not all(ok for _, ok in errs):
                    failures.append(f"{name} {kind}: {bad} elements differ from the plain "
                                    f"versions, max abs {err:.3e}")
            if kind == "none":
                fg_mod.configure(enabled=False)
                unfused = fused_ops(group, xs, gs, ws, a, w_row, "none")
                fg_mod.configure(enabled=True)
                bad = sum(bits_differ(u, v) for u, v in zip(unfused, got))
                if bad:
                    failures.append(f"exact wire: {bad} elements differ from the unfused ops")
            del got, want
        torch.cuda.synchronize()
        log(f"[fused] the ops through the kernels against the plain versions, wires "
            f"{list(FUSED_WIRES)}: {len(failures)} failures so far; max abs err "
            f"{max_err['ag_hop']:.3e} / {max_err['rs_hop']:.3e}")
        del gs, a
        # the main path, counted
        xs = [torch.randn(FUSED_X, generator=g, device=dev) for _ in range(n)]
        ts = [torch.randn(M, F, generator=g, device=dev) for _ in range(n)]
        w0 = list((torch.randn(FUSED_W_UP, generator=g, device=dev) * 0.02).chunk(n))
        xr = [torch.randn(M, FUSED_W_ROW[0], generator=g, device=dev) for _ in range(n)]
        wr = [torch.randn(FUSED_W_ROW, generator=g, device=dev) * 0.02 for _ in range(n)]
        torch.cuda.synchronize()
        plain_calls = {"ag_hop": 0, "rs_hop": 0}
        real = {k: getattr(fg_mod, f"{k}_plain") for k in plain_calls}

        def spy(key):
            def counted_plain(*a_, **k_):
                plain_calls[key] += 1
                return real[key](*a_, **k_)
            return counted_plain

        for k in plain_calls:
            setattr(fg_mod, f"{k}_plain", spy(k))
        try:
            zero_counts()
            t1 = time.perf_counter()
            losses, w_on = fused_sgd(group, xs, ts, w0, FUSED_STEPS)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t1) / FUSED_STEPS
            q_losses, _ = fused_sgd(group, xs, ts, w0, 1, quantize=True)
            rows_exact = row_parallel_linear(xr, wr, group)
            rows_int8 = row_parallel_linear(xr, wr, group, quantize=True)
            torch.cuda.synchronize()
            launches = launch_counts()
            by_form = {k: dict(getattr(fg_mod, k).launches_by_form) for k in FUSED_KERNELS}
        finally:
            for k in plain_calls:
                setattr(fg_mod, f"{k}_plain", real[k])
        # the step fused and unfused in turns (f u u f, twice), then one fused
        # step under the profiler
        turns = {True: [], False: []}
        for on in (True, False, False, True) * 2:
            fg_mod.configure(enabled=on)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fused_sgd(group, xs, ts, w0, 1)
            torch.cuda.synchronize()
            turns[on].append((time.perf_counter() - t1) * 1e3)
        fg_mod.configure(enabled=True)
        prof = device_profile(lambda: fused_sgd(group, xs, ts, w0, 1), union=True)
    finally:
        fg_mod.configure(enabled=False)
    t1 = time.perf_counter()
    l_off, w_off = fused_sgd(group, xs, ts, w0, FUSED_STEPS)
    torch.cuda.synchronize()
    step_off_s = (time.perf_counter() - t1) / FUSED_STEPS
    rows_off = row_parallel_linear(xr, wr, group)
    hops = n * (n - 1)
    steps = FUSED_STEPS + 1
    want = dict({k: 0 for k in launches}, ag_hop=2 * hops * steps, rs_hop=hops * (steps + 2),
                fused_hop=3 * n + n, permute_leaves=FUSED_STEPS * n + n)
    want_by_form = {k: dict(dict.fromkeys(fg_mod.FUSED_FORMS, 0), wgmma=want[k])
                    for k in FUSED_KERNELS}
    wall, busy, plain_wall, rows = prof
    log_profile("fused", "one fused ZeRO-3 SGD step (4 ranks; device kernels: the time covered "
                "by at least one)", wall, busy, plain_wall, rows)
    hop_ms = sum(ms for ms, _, key in rows if "hop_tf32_kernel" in key or "ag_hop_kernel" in key
                 or "rs_hop_kernel" in key)
    log(f"[fused] the profiled step's kernels summed over the 4 ranks' streams: "
        f"{sum(r[0] for r in rows):.2f} ms, the hop kernels {hop_ms:.2f} ms")
    step_turns = {"fused": turns[True], "unfused": turns[False]}
    log(f"[fused] a ZeRO-3 SGD step in turns (f u u f, twice), host ms: fused {turns[True]}, "
        f"unfused {turns[False]}; mean fused {np.mean(turns[True]):.2f}, unfused "
        f"{np.mean(turns[False]):.2f} ({'fused faster' if np.mean(turns[True]) < np.mean(turns[False]) else 'fused NOT faster'})")
    rel_loss = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(losses, l_off))
    rel_w = max(float((u - v).abs().max()) for u, v in zip(w_on, w_off)) / max(
        float(v.abs().max()) for v in w_off)
    rows_err = max(fused_gemm_close(u, v, FUSED_W_ROW[0])[0] for u, v in zip(rows_exact, rows_off))
    exact = [sum(xr[r2][r * (M // n):(r + 1) * (M // n)] @ wr[r2] for r2 in range(n)) for r in range(n)]
    q_rel = max(float((u - v).abs().max()) / float(v.abs().max()) for u, v in zip(rows_int8, exact))
    log(f"[fused] ZeRO-3 SGD through sharded_matmul, {FUSED_STEPS} steps (x {list(FUSED_X)} a rank, "
        f"w_up {list(FUSED_W_UP)} in {n} shards, lr {FUSED_LR}): losses fused {losses}, unfused "
        f"{l_off}, rel diff {rel_loss:.3e}, weights rel diff {rel_w:.3e}; a step {step_s * 1e3:.1f} "
        f"ms fused, {step_off_s * 1e3:.1f} ms unfused; the int8 wire's step loss {q_losses[0]:.6f}; "
        f"row_parallel_linear fused vs unfused max abs {rows_err:.3e}, int8 wire rel err vs "
        f"exact {q_rel:.3e}")
    log(f"[fused] launches {launches} (expected {want}); rows 14-15 by form {by_form} (expected "
        f"{want_by_form}); plain hop calls on the counted path {plain_calls}")
    results["fused"] = {"ranks": n, "x": list(FUSED_X), "w_up": list(FUSED_W_UP),
                        "w_row": list(FUSED_W_ROW), "losses_fused": losses, "losses_unfused": l_off,
                        "rel_loss": rel_loss, "rel_w": rel_w, "step_ms_fused": step_s * 1e3,
                        "step_ms_unfused": step_off_s * 1e3, "int8_step_loss": q_losses[0],
                        "rows_int8_rel_err": q_rel, "launches": launches, "expected": want,
                        "launches_by_form": by_form, "plain_calls": plain_calls,
                        "step_turns_ms": step_turns,
                        "profiled_step": {"wall_ms": wall, "kernel_union_ms": busy,
                                          "kernel_sum_ms": sum(r[0] for r in rows),
                                          "idle_share": 1 - busy / wall, "hop_kernels_ms": hop_ms,
                                          "top": [[ms, c, k[:110]] for ms, c, k in rows[:8]]},
                        "max_err": {k: max_err[k] for k in FUSED_KERNELS}}
    if not losses[-1] < losses[0]:
        failures.append(f"the fused trajectory does not fall: {losses}")
    if rel_loss >= FUSED_REL or rel_w >= FUSED_REL or not fused_gemm_close(
            torch.stack(rows_exact), torch.stack(rows_off), FUSED_W_ROW[0])[1]:
        failures.append("fused against unfused: outside FUSED_REL")
    if q_rel >= 2e-2:
        failures.append(f"row_parallel_linear int8: rel err {q_rel:.3e} past JAX's 2e-2")
    del xs, ts, w0, xr, wr, w_on, w_off
    torch.cuda.empty_cache()
    if failures:
        log(f"[fused] FAILED: {failures[:10]}")
        return None
    if launches != want:
        log("[fused] FAILED: launch counts do not match n - 1 a rank and op")
        return None
    if by_form != want_by_form or any(plain_calls.values()):
        log("[fused] FAILED: a hop of the counted path did not run form T (wgmma), or a plain "
            "hop ran")
        return None
    return launches


def fused_bounds(flops, nbytes):
    """(3xTF32 bound ms, SIMT bound ms, bytes ms): 3 x the operations at the
    TF32 rate (form T's three passes), the operations at fp32's CUDA-core
    rate (form S), and the bytes at the HBM rate; each bound is the larger of
    its operations' time and the bytes'."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(3 * flops / PEAK_FLOPS["tf32"] * 1e3, t_bytes),
            max(flops / PEAK_FLOPS[torch.float32] * 1e3, t_bytes), t_bytes)


def time_fused_kernels(dev, launches, max_err, timing, by_form):
    """Rows 14 and 15 at phase 6c's four hop shapes (the gather's accumulate
    and ``out_block`` hops, the reduce-scatter's ``dw`` and
    ``row_parallel_linear`` hops), each with the exact and the int8 wire:
    form T ("wgmma"), form S ("simt") and the library yardstick timed in
    turns (``time_turns``, 2 palindromes, L2 warm: a hop's operands are read
    where the previous hop left them), the plain version beside them. The
    yardstick is the PyTorch calls computing the same: ``Tensor.addmm_`` of
    the product and ``Tensor.copy_`` of the received shard (accumulate),
    ``torch.mm`` into the block and the same ``copy_`` (``out_block``),
    ``torch.addmm`` of the upstream partial and the product (row 15). Each
    time is logged with its TFLOP/s, the 3xTF32 bound (the row's bound) and
    the SIMT bound (the log's, not the kernel line's). Returns the kernel
    line's two entries: the form the wrapper picks at the accumulate (row
    14) and ``row_parallel_linear`` (row 15, as its first entry had it) hop,
    the other shapes and forms inside."""
    n, (M, H), (_, F) = FUSED_RANKS, FUSED_X, FUSED_W_UP
    Ks = FUSED_W_UP[0] // n
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(M, H, generator=g, device=dev)
    gout = torch.randn(M, F, generator=g, device=dev)
    held = torch.randn(Ks, F, generator=g, device=dev)
    y = torch.randn(M, F, generator=g, device=dev)
    dx = torch.randn(M, H, generator=g, device=dev)
    blk = torch.empty(M, Ks, device=dev)
    upstream = torch.randn(Ks, F, generator=g, device=dev)
    recv = torch.empty_like(held)
    xs = x[:, 2 * Ks:3 * Ks]
    entries = {}
    for out_block in (False, True):
        label = "out_block" if out_block else "accumulate"
        for kind in ("none", "int8"):
            qb = fused_gemm_qb(kind, Ks, F)
            up = block_wire(kind, upstream, qb)
            own = None if kind == "none" else (torch.empty_like(up[0]), torch.empty_like(up[1]))
            wire_b = sum(t.numel() * t.element_size() for t in up)
            a_, out = (gout, dx) if out_block else (x, y)
            # x's block (or g) and held read once, out read (accumulate) and
            # written, the wire read and the received shard written (and its
            # codes, before the last hop)
            nbytes = (M * (F if out_block else Ks) + Ks * F + (1 if out_block else 2) * M *
                      (Ks if out_block else F) + Ks * F) * 4 + wire_b * (2 if own else 1)
            flops = 2 * M * Ks * F
            fns = {form: functools.partial(fg_mod.ag_hop, a_, held, out, 2 * Ks, up, recv, own, qb=qb,
                                           out_block=out_block, form=form)
                   for form in fg_mod.FUSED_FORMS}
            if out_block:
                fns["library"] = lambda: (torch.mm(gout, held.t(), out=blk), recv.copy_(upstream))
            else:
                fns["library"] = lambda: (y.addmm_(xs, held), recv.copy_(upstream))
            readings = {}
            got = time_turns(fns, iters=20, rounds=2, readings=readings)
            t3, ts, t_bytes = fused_bounds(flops, nbytes)
            t = {"form": fg_mod._ag_form(a_, held, out, out_block), "forms_ms": {
                     f: got[f] for f in fg_mod.FUSED_FORMS}, "readings": readings,
                 "library_ms": got["library"], "bound_ms": t3, "simt_bound_ms": ts,
                 "bound_by": "operations" if 3 * flops / PEAK_FLOPS["tf32"] * 1e3 >= t_bytes else "bytes",
                 "bytes_ms": t_bytes,
                 "plain_ms": time_fn(lambda: fg_mod.ag_hop_plain(a_, held, out, 2 * Ks, up, recv, own,
                                                                 qb=qb, out_block=out_block),
                                     iters=10, warmup=2)}
            t["ms"] = t["forms_ms"][t["form"]]
            shape = (f"g [{M}, {F}] @ held^T [{F}, {Ks}] into a block of [{M}, {H}]" if out_block
                     else f"y [{M}, {F}] += x[:, {Ks} cols] @ held [{Ks}, {F}]")
            timing[f"ag_hop[{label} {kind}]"] = t
            log(f"[time] ag_hop {label}, {kind} wire, {shape} and the shard received: "
                + ", ".join(f"form {f} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
                            for f, ms in t["forms_ms"].items())
                + f"; the wrapper picks {t['form']}; library {t['library_ms']:.4f} ms "
                f"({flops / t['library_ms'] / 1e9:.1f} TFLOP/s), plain {t['plain_ms']:.4f} ms; "
                f"bounds 3xTF32 {t3:.4f} ms, SIMT {ts:.4f} ms ({flops / 1e9:.2f} GFLOP; bytes alone "
                f"{t_bytes:.4f} ms)")
            entries[(label, kind)] = dict(t, shape=shape)
    del x, gout, held, y, dx, blk, upstream, recv, xs
    torch.cuda.empty_cache()
    for label, (rows, Kr, Nr) in (("dw", (FUSED_W_UP[0], M, F)), ("row_parallel", (M,) + FUSED_W_ROW)):
        Mb = rows // n
        x = torch.randn(rows, Kr, generator=g, device=dev)
        w = torch.randn(Kr, Nr, generator=g, device=dev)
        part = torch.empty(Mb, Nr, device=dev)
        prev = torch.randn(Mb, Nr, generator=g, device=dev)
        xb = x[Mb:2 * Mb]
        for kind in ("none", "int8"):
            qb = fused_gemm_qb(kind, Mb, Nr)
            up = block_wire(kind, prev, qb)
            own = None if kind == "none" else (torch.empty_like(up[0]), torch.empty_like(up[1]))
            wire_b = sum(t.numel() * t.element_size() for t in up)
            nbytes = (Mb * Kr + Kr * Nr + Mb * Nr) * 4 + wire_b * (2 if own else 1)
            flops = 2 * Mb * Kr * Nr
            fns = {form: functools.partial(fg_mod.rs_hop, x, w, Mb, up, part, own, qb=qb, form=form)
                   for form in fg_mod.FUSED_FORMS}
            fns["library"] = lambda: torch.addmm(prev, xb, w, out=part)
            readings = {}
            got = time_turns(fns, iters=20, rounds=2, readings=readings)
            t3, ts, t_bytes = fused_bounds(flops, nbytes)
            t = {"form": fg_mod._rs_form(x, w, up, part, 0 if kind == "none" else 1),
                 "forms_ms": {f: got[f] for f in fg_mod.FUSED_FORMS}, "readings": readings,
                 "library_ms": got["library"], "bound_ms": t3, "simt_bound_ms": ts,
                 "bound_by": "operations" if 3 * flops / PEAK_FLOPS["tf32"] * 1e3 >= t_bytes else "bytes",
                 "bytes_ms": t_bytes,
                 "plain_ms": time_fn(lambda: fg_mod.rs_hop_plain(x, w, Mb, up, part, own, qb=qb),
                                     iters=10, warmup=2)}
            t["ms"] = t["forms_ms"][t["form"]]
            shape = f"part [{Mb}, {Nr}] = rprev + x[{Mb} rows] @ w [{Kr}, {Nr}]"
            timing[f"rs_hop[{label} {kind}]"] = t
            log(f"[time] rs_hop {label}, {kind} wire, {shape}{' and its codes' if own else ''}: "
                + ", ".join(f"form {f} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
                            for f, ms in t["forms_ms"].items())
                + f"; the wrapper picks {t['form']}; addmm {t['library_ms']:.4f} ms "
                f"({flops / t['library_ms'] / 1e9:.1f} TFLOP/s), plain {t['plain_ms']:.4f} ms; "
                f"bounds 3xTF32 {t3:.4f} ms, SIMT {ts:.4f} ms ({flops / 1e9:.2f} GFLOP; bytes alone "
                f"{t_bytes:.4f} ms)")
            entries[(label, kind)] = dict(t, shape=shape)
        del x, w, part, prev, xb
        torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(name, replaces, head, others):
        t = entries[head]
        return dict(name=name, route="cuda", source="deepspeed_tpu_torch/csrc/fused_gemm.cu",
                    replaces=replaces, launches=launches[name], max_abs_err=max_err[name],
                    launches_by_form=by_form[name], form=t["form"], forms_ms=t["forms_ms"],
                    shape=f"fp32 wire, {t['shape']}", **{k: t[k] for k in keys},
                    shapes={f"{label} {kind}": dict(
                        {k: entries[(label, kind)][k] for k in keys + ("form", "forms_ms", "shape")})
                        for label, kind in others})

    return [entry("ag_hop", "deepspeed_tpu/collectives/fused_gemm.py:198", ("accumulate", "none"),
                  [("accumulate", "int8"), ("out_block", "none"), ("out_block", "int8")]),
            entry("rs_hop", "deepspeed_tpu/collectives/fused_gemm.py:257", ("row_parallel", "none"),
                  [("row_parallel", "int8"), ("dw", "none"), ("dw", "int8")])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = card_line()
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    results = {"card": card, "device_name": torch.cuda.get_device_name(0)}
    max_err = {"rms_norm": 0.0, "layer_norm": 0.0, "paged_attention": 0.0, "paged_attention_quant": 0.0,
               "paged_attention_alibi": 0.0, "grouped_matmul": 0.0, "permute_leaves": 0.0,
               "fused_hop": 0.0, "ag_hop": 0.0, "rs_hop": 0.0,
               **{k: 0.0 for k in FLASH_KERNELS + FLASH_ALIBI_KERNELS + FLASH_PAIR
                  + FLASH_PAIR_ALIBI + SPARSE_KERNELS}}

    # ---- 1. build
    t0 = time.perf_counter()
    built = op_builder.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] compiled {built or 'nothing (cached)'} in {build_s:.1f} s")
    for name, text in op_builder.BUILD_LOGS.items():
        for line in text.splitlines():
            # ptxas -v: registers, spills, errors, wgmma serialisation (C75xx)
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "(C75" in line):
                log(f"[build:{name}] {line.strip()}")
    results["build_s"] = build_s

    # ---- 2. kernel checks against the plain versions
    failures, checks = phase_checks(dev, max_err)
    if failures:
        log(f"[check] FAILED: {failures}")
        return 1

    # ---- 2b. the public op entry point: ops.layer_norm through its kernel
    ops_launches = phase_ops(dev, max_err, results)
    if ops_launches is None:
        return 1

    # ---- 3. serving, bf16 then quantised, on one set of weights; then its
    # memory is freed
    cfg = dataclasses.replace(PRESETS["llama3-8b"], dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[serve] init_params llama3-8b: {cfg.num_params() / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s")
    served = phase_serve(dev, cfg, params, results)
    if served is None:
        return 1
    serve_launches, bf16_outs, bf16_logits = served
    gc.collect()  # the engine's timing wrappers hold it in a reference cycle
    torch.cuda.empty_cache()
    quant_launches = phase_quant_serve(dev, cfg, params, bf16_outs, bf16_logits, results)
    if quant_launches is None:
        return 1
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3c. serving Bloom-7B1 through the ALiBi form, on the memory the
    # Llama weights, engines and pools held
    torch.cuda.reset_peak_memory_stats()
    log(f"[bloom] before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB since the Llama engines were freed")
    bloom_launches = phase_bloom_serve(dev, results)
    if bloom_launches is None:
        return 1

    # ---- 3d. serving Mixtral-8x7B's widths at 16 of 32 layers through the
    # grouped GEMM, on the memory the Bloom weights held
    torch.cuda.reset_peak_memory_stats()
    log(f"[mixtral] before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB since the Bloom engines were freed")
    mixtral_launches = phase_mixtral_serve(dev, results)
    if mixtral_launches is None:
        return 1
    log(f"[mixtral] after the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # ---- 4. training Llama-3.2-1B
    llama = dataclasses.replace(PRESETS["llama3-1b"], dtype=torch.bfloat16)
    per_micro = dict({k: llama.num_layers for k in FLASH_KERNELS},
                     rms_norm=2 * llama.num_layers + 1)
    llama_launches = phase_train(dev, "train llama3-1b", llama, micro=4, seq=2048, gas=2,
                                 expect_per_micro=per_micro, results=results, profile=True)
    if llama_launches is None:
        return 1

    # ---- 4a. training Bloom-560M through the ALiBi form of the flash kernels
    bloom = TransformerConfig(**BLOOM_560M, dtype=torch.bfloat16)
    bloom_train_launches = phase_train(
        dev, "train bloom-560m", bloom, micro=4, seq=2048, gas=2,
        expect_per_micro={k: bloom.num_layers for k in FLASH_ALIBI_KERNELS},
        results=results, profile=True, init=bloom_params)
    if bloom_train_launches is None:
        return 1

    # ---- 4b. the same preset with BigBird block-sparse attention at seq
    # 4096; then the same config through the dense flash kernels, a run of
    # its own whose launches are not summed below
    sparse = dataclasses.replace(llama, attn_impl="sparse", sparse_attention=SPARSE_ATTENTION)
    sparse_fpt, live = sparse_flops_per_token(sparse, SPARSE_SEQ, dev)
    log(f"[train llama3-1b sparse] layout: {live} live causal tiles of 16 x 16 over "
        f"{sparse.num_heads} heads ({live / sparse.num_heads / (SPARSE_SEQ // 16):.3f} per block "
        f"row); {sparse_fpt / 1e9:.3f} GFLOP/token against the dense formula's "
        f"{sparse.flops_per_token(SPARSE_SEQ) / 1e9:.3f}")
    sparse_launches = phase_train(
        dev, "train llama3-1b sparse", sparse, micro=2, seq=SPARSE_SEQ, gas=2,
        expect_per_micro=dict({k: sparse.num_layers for k in SPARSE_KERNELS},
                              rms_norm=2 * sparse.num_layers + 1),
        results=results, profile=True, flops_per_token=sparse_fpt)
    if sparse_launches is None:
        return 1
    results["train llama3-1b sparse"]["live_tiles"] = live
    dense_tag = "train llama3-1b dense S=4096"
    if phase_train(dev, dense_tag, llama, micro=2, seq=SPARSE_SEQ, gas=2,
                   expect_per_micro=per_micro, results=results) is None:
        return 1
    sp, dn = results["train llama3-1b sparse"], results[dense_tag]
    log(f"[train llama3-1b sparse] against the dense flash kernels at seq {SPARSE_SEQ}: step "
        f"{sp['median_step_s']:.4f} s vs {dn['median_step_s']:.4f} s "
        f"({dn['median_step_s'] / sp['median_step_s']:.3f}x), peak memory "
        f"{sp['peak_mem_gb']:.2f} GB vs {dn['peak_mem_gb']:.2f} GB")

    # ---- 5. whole-slice checks, kernels vs plain versions
    for kind in ("llama", "sparse", "bloom"):
        if not phase_slice_check(dev, results, kind):
            log("[slice] FAILED: the kernels' micro-step disagrees with the plain versions'")
            return 1
        torch.cuda.empty_cache()

    # ---- 6. training the GPT-2-125M headline
    gpt2 = TransformerConfig(**GPT2_HEADLINE_DIMS, scan_layers=False, fused_ce=False,
                             dtype=torch.bfloat16)
    gpt2_launches = phase_train(dev, "train gpt2-125m", gpt2, micro=4, seq=1024, gas=8,
                                expect_per_micro={k: gpt2.num_layers for k in FLASH_KERNELS},
                                results=results, profile=True)
    if gpt2_launches is None:
        return 1

    # ---- 6b. the collectives: 4 ranks of one group on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    coll_launches = phase_collectives(dev, max_err, results)
    if coll_launches is None:
        return 1
    log(f"[coll] phase in {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # ---- 6c. the fused GEMM collectives: 4 ranks of one group on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fused_launches = phase_fused(dev, max_err, results)
    if fused_launches is None:
        return 1
    log(f"[fused] phase in {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # ---- 7. per-kernel timing at the main path's shapes; launches summed
    # over the counted runs of the paths (the op entry point's layer_norm
    # calls, serving Llama bf16 and quantised,
    # the stochastic quantiser's call, serving Bloom and Mixtral, the four
    # trainings, the collectives, the fused GEMM collectives)
    by_path = {"ops layer_norm": ops_launches, "serve": serve_launches, **quant_launches, **bloom_launches, **mixtral_launches,
               "train llama3-1b": llama_launches, "train bloom-560m": bloom_train_launches,
               "train llama3-1b sparse": sparse_launches, "train gpt2-125m": gpt2_launches,
               "collectives": coll_launches, "fused gemm": fused_launches}
    launches = {k: sum(path[k] for path in by_path.values()) for k in serve_launches}
    results["launches_by_path"] = by_path
    trainings = ("train llama3-1b", "train bloom-560m", "train llama3-1b sparse", "train gpt2-125m")
    launches["flash_fwd_by_form"] = {f: sum(results[tag]["flash_fwd_by_form"][f] for tag in trainings)
                                     for f in fa.FWD_FORMS}
    launches["flash_bwd_by_form"] = {f: sum(results[tag]["flash_bwd_by_form"][f] for tag in trainings)
                                     for f in fa.BWD_FORMS}
    # the paged kernel's launches by form, by kernel line entry: the serving runs
    servings = {"paged_attention": ["serve", "mixtral-8x7b bf16"],
                "paged_attention_quant": [*QUANT_ENGINES, "mixtral-8x7b int8 kv"],
                "paged_attention_alibi": list(BLOOM_ENGINES)}
    launches["paged_by_form"] = {
        entry: {f: sum(results[tag]["paged_launches_by_form"][f] for tag in tags)
                for f in pa_mod.PAGED_FORMS} for entry, tags in servings.items()}
    kernels = phase_time(dev, checks, launches, max_err, results)
    if any(kernel["launches"] == 0 for kernel in kernels):
        log("[time] FAILED: a kernel was launched no time on the main path")
        return 1
    results["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, any failure exits non-zero:

1. build  both hand-written CUDA kernels from ``deepspeed_tpu_torch/csrc`` with
          nvcc (sm_90a), one nvcc per source, in parallel;
2. check  each kernel against its plain PyTorch version on the card, at the
          serving path's shapes (tolerances stated beside each check);
3. serve  Llama-3-8B at full width and depth (random bf16 weights from a seed,
          a 2048 x 16-slot bf16 KV pool) through ``InferenceEngineV2.generate``:
          8 prompts of 32-1000 tokens, 64 new tokens each, decode chains of 8,
          greedy. The kernels' launch counters are zeroed just before and read
          just after; every launch of the run must come from the path (65
          RMSNorm and 32 paged-attention launches per forward). One prefill
          step's last-token logits are then held against the same step run
          through the plain versions.
          A decode chain of the same engine is then profiled (device time by
          kernel, the device's busy share);
4. time   each kernel with CUDA events beside its bound, its plain version and
          one PyTorch library call computing the same function.

The line before the last is a JSON object ``{"kernels": [...]}``; the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing either.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch.inference.paged as paged_mod
import deepspeed_tpu_torch.models.transformer as transformer_mod
from deepspeed_tpu_torch.inference import InferenceEngineV2, init_pool, ragged_forward
from deepspeed_tpu_torch.inference.ragged import StateManager, build_ragged_batch
from deepspeed_tpu_torch.models import PRESETS, init_params
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from deepspeed_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of bytes / memory rate and operations / peak rate for the type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# rms_norm kernel vs plain version, (rtol, atol) per element: both compute in
# fp32 and round once; fp32 differs by sum order, bf16 by at most one output
# ulp (2**-8 relative)
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
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
LOGITS_REL_L2 = 5e-2  # kernels vs plain versions through 32 bf16 layers
SPIN_CYCLES = 4_000_000  # ~2 ms of GPU clock: longer than the host needs to enqueue a timed group


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


def paged_bytes_and_flops(batch, lens):
    """Bytes the function must move (inputs read once, output written once,
    only the live pages of the pool) and its flops, for this batch's data."""
    q = batch["q"]
    N, C, H, hd = q.shape
    kvH, it = batch["pool_k_l"].shape[1], q.element_size()
    live_tokens = sum(lens[n] for n in range(N) if int(batch["new_lens"][n]) > 0)
    kv = 2 * live_tokens * kvH * hd * it
    other = 2 * q.numel() * it + batch["block_tables"].numel() * 4 + batch["q_positions"].numel() * 4 + N * 4
    # scores and p@V, 2 flops per multiply-add, causal: each query sees up to its position
    pos = batch["q_positions"].cpu().numpy()
    nl = batch["new_lens"].cpu().numpy()
    visible = sum(int(pos[n, c]) + 1 for n in range(N) for c in range(int(nl[n])))
    flops = 4 * visible * H * hd
    return kv + other, flops


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


def profile_decode_chain(engine, prompts, k):
    """Two K-step decode chains over ``prompts`` (prefilled first): the first
    timed alone, the second under torch.profiler (device activity only: host
    op tracing would slow the host-bound chain), its wall time and its device
    time by kernel both from that one chain. Returns (profiled chain wall ms,
    its device kernel ms, unprofiled chain wall ms, rows)."""
    uids = list(range(len(prompts)))
    engine.put(uids, prompts)

    def chain_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_chain(uids, [0] * len(uids), [k] * len(uids), k)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_wall_ms = chain_ms()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_ms = chain_ms()
    for u in uids:
        engine.flush(u)
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
    return wall_ms, sum(r[0] for r in rows), plain_wall_ms, rows


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
    max_err = {"rms_norm": 0.0, "paged_attention": 0.0}
    failures = []

    # ---- 1. build
    t0 = time.perf_counter()
    built = op_builder.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] compiled {built or 'nothing (cached)'} in {build_s:.1f} s")
    for name, text in op_builder.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build:{name}] {line.strip()}")
    results["build_s"] = build_s

    # ---- 2. kernel checks against the plain versions
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
    if failures:
        log(f"[check] FAILED: {failures}")
        return 1

    # ---- 3. the slice: Llama-3-8B through InferenceEngineV2.generate
    cfg = dataclasses.replace(PRESETS["llama3-8b"], dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[serve] init_params llama3-8b: {cfg.num_params() / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s")
    engine = InferenceEngineV2(cfg, params, {"dtype": "bf16", "kv_block_size": 16,
                                             "num_kv_blocks": 2048, "max_seq_len": 2048,
                                             "decode_chain": 8}, device=dev)
    log(f"[serve] KV pool: {engine.pool.k.numel() * 2 * 2 / 2 ** 30:.3f} GiB "
        f"({engine.kv_bytes_per_token} B/token)")
    prng = np.random.default_rng(1)
    plens = [32, 1000] + [int(n) for n in prng.integers(32, 1001, 6)]
    prompts = [prng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in plens]
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
    torch.cuda.reset_peak_memory_stats()
    rms_norm.launches = 0
    paged_attention.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rms_norm": rms_norm.launches, "paged_attention": paged_attention.launches}
    forwards = engine.model_forwards
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = {"rms_norm": (2 * cfg.num_layers + 1) * forwards,
              "paged_attention": cfg.num_layers * forwards}
    log(f"[serve] prompts {plens}; {forwards} forwards, {engine.dispatch_count} dispatches, "
        f"{engine.host_sync_count} host syncs, launches {launches} (expected {expect})")
    if any(len(o) != 64 or o.min() < 0 or o.max() >= cfg.vocab_size for o in outs):
        log(f"[serve] FAILED: outputs {[(len(o), int(o.min()), int(o.max())) for o in outs]}")
        return 1
    if launches != expect or min(launches.values()) == 0:
        log("[serve] FAILED: kernel launch counts do not match the forwards run")
        return 1
    prefill_tokens = sum(plens)
    results["serve"] = {
        "prompt_lens": plens, "forwards": forwards, "launches": launches, "wall_s": wall,
        "prefill_s": spans["prefill"], "decode_s": spans["decode"],
        "prefill_tok_s": prefill_tokens / spans["prefill"],
        "decode_tok_s": engine.tokens_decoded / spans["decode"],
        "tokens_decoded": engine.tokens_decoded, "peak_mem_gb": peak_gb,
        "first_tokens": [o[:8].tolist() for o in outs[:2]],
    }
    log(f"[serve] generate {wall:.2f} s: prefill {prefill_tokens} tokens in "
        f"{spans['prefill']:.3f} s ({prefill_tokens / spans['prefill']:.1f} tok/s), decode "
        f"{engine.tokens_decoded} tokens in {spans['decode']:.3f} s "
        f"({engine.tokens_decoded / spans['decode']:.1f} tok/s), peak memory {peak_gb:.2f} GB")

    # one prefill step through the kernels and through the plain versions
    bs, P = 16, engine.max_pages
    step_prompts = [prompts[1][:200], prompts[0], prompts[2][:77]]
    logits = {}
    for mode in ("kernels", "plain"):
        pool = init_pool(cfg, 64, bs, torch.bfloat16, dev)
        b = build_ragged_batch(StateManager(64, bs, max_blocks_per_seq=P), [0, 1, 2],
                               step_prompts, P, row_bucket=8, chunk_bucket=16)
        arrs = [torch.from_numpy(a).to(dev) for a in (b.tokens, b.positions, b.new_lens, b.block_tables)]
        before = (rms_norm.launches, paged_attention.launches)
        if mode == "kernels":
            out, _ = ragged_forward(engine.params, cfg, pool, *arrs, bs)
        else:
            with mock.patch.object(transformer_mod, "rms_norm", rms_norm_reference), \
                    mock.patch.object(paged_mod, "paged_attention", paged_attention_reference):
                out, _ = ragged_forward(engine.params, cfg, pool, *arrs, bs)
            if (rms_norm.launches, paged_attention.launches) != before:
                log("[serve] FAILED: the plain run launched a kernel")
                return 1
        logits[mode] = out[:3].float()
        del pool
    diff = logits["kernels"] - logits["plain"]
    rel = float(diff.norm() / logits["plain"].norm())
    agree = float((logits["kernels"].argmax(-1) == logits["plain"].argmax(-1)).float().mean())
    log(f"[serve] prefill-step logits, kernels vs plain: rel L2 {rel:.3e} (bound {LOGITS_REL_L2}), "
        f"max_abs {float(diff.abs().max()):.3e}, argmax agreement {agree:.2f}")
    results["serve"]["logits_rel_l2"] = rel
    if not (math.isfinite(rel) and rel <= LOGITS_REL_L2):
        log("[serve] FAILED: prefill logits disagree with the plain versions")
        return 1

    # ---- where a decode chain's time goes (after the counted run)
    wall_ms, busy_ms, plain_wall_ms, rows = profile_decode_chain(engine, prompts, 8)
    if busy_ms <= 0:
        log("[profile] FAILED: the profiler saw no device time in the decode chain")
        return 1
    log(f"[profile] decode chain (8 rows x 8 steps) under the profiler: wall {wall_ms:.2f} ms, "
        f"device kernels {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f} %; the same chain unprofiled: wall "
        f"{plain_wall_ms:.2f} ms (profiler overhead {wall_ms - plain_wall_ms:+.2f} ms)")
    for dev_ms, count, name in rows[:12]:
        log(f"[profile]   {dev_ms:9.3f} ms  {count:6d}x  {name[:90]}")
    results["profile_decode_chain"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                       "unprofiled_wall_ms": plain_wall_ms,
                                       "top": [list(r) for r in rows[:20]]}
    del engine, params, logits
    torch.cuda.empty_cache()

    # ---- 4. per-kernel timing at the slice's shapes
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
        t = {"ms": time_fn(lambda: rms_norm(x, s, 1e-5)),
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

    for label, (batch, lens) in (("decode", checks["decode C=1, lens 1-1000"]),
                                 ("prefill", checks["prefill C=512, ragged, pad row"])):
        nbytes, flops = paged_bytes_and_flops(batch, lens)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        # library yardstick: SDPA over K/V pre-gathered dense (gather excluded)
        q = batch["q"]
        N, C, H, hd = q.shape
        G = H // batch["pool_k_l"].shape[1]
        T = max(lens)
        slot = (batch["block_tables"].long()[:, :, None] * 16
                + torch.arange(16, device=dev)).reshape(N, -1)[:, :T]
        kd = batch["pool_k_l"][slot].permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
        vd = batch["pool_v_l"][slot].permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
        qd = q.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(T, device=dev)[None, None, :] <= batch["q_positions"].long()[:, :, None])[:, None]
        t = {"ms": time_fn(lambda: paged_attention(**batch), iters=50, flush=flush),
             "plain_ms": time_fn(lambda: paged_attention_reference(**batch), iters=20, flush=flush),
             "library_ms": time_fn(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
                                   iters=50, flush=flush),
             "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        timing[f"paged_attention[{label}]"] = t
        log(f"[time] paged_attention {label} {tuple(q.shape)} bf16: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, SDPA(dense) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        del kd, vd, qd, mask
    d = timing["paged_attention[decode]"]
    kernels.append(dict(name="paged_attention", route="cuda",
                        source="deepspeed_tpu_torch/csrc/paged_attention.cu",
                        replaces="deepspeed_tpu/ops/pallas/paged_attention.py:59",
                        launches=launches["paged_attention"], max_abs_err=max_err["paged_attention"],
                        shape="decode q [8, 1, 32, 128], lens 1-1000, bf16",
                        **{k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))
    results["timing"] = timing
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

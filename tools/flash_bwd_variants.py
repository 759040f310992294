"""Time form W of the flash-attention backward against variants of its source.

Each variant is ``deepspeed_tpu_torch/csrc/flash_attention_bwd.cu`` with a few
lines replaced (``VARIANTS`` below: the alternatives its design notes name),
built with the same ``nvcc`` flags as ``ops/op_builder.py`` and called through
the same C entry, ``ds_flash_bwd``, on the same inputs as the committed kernel.
At the Llama-3.2-1B training shape, Bloom-560M's ALiBi shape and hd 128 every
build is timed by CUDA events in palindromes (committed, variants, variants
reversed, committed), and each variant's dq, dk and dv are held to the
committed kernel's by the flash checks' row rule (2e-2; a variant that drops
a synchronisation may race and disagree), dk and dv also compared bit for
bit (a variant that sums them in another order differs in the last bits).

Run it on a machine with a CUDA card from the root of a checkout::

    python3 tools/flash_bwd_variants.py [--variants own_reduce_hd64,no_turns] [--rounds 2]

The last line of the output is one JSON object: the card, and for each shape
and build its readings (ms), whether it agreed and whether dk and dv were
bit-equal.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from deepspeed_tpu_torch.models.transformer import alibi_slopes  # noqa: E402
from deepspeed_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.utils.checks import flash_inputs, row_rel_l2  # noqa: E402

SOURCE = op_builder.CSRC_DIR / "flash_attention_bwd.cu"
BUILD = op_builder.BUILD_DIR.parent / "flash_bwd_variants"
_T2_WAIT = """    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(pf);
    hopper::fence_operand(dsf);
    hopper::wgmma_fence();
    issue_dq<HD>(dqa, ds_addr, k_addr);
"""
# name -> [(text of the committed source, its replacement)]
VARIANTS = {
    # each warpgroup adds its own whole dQ partial at hd 64 too
    "own_reduce_hd64": [("constexpr bool kPairSum = HD == 64;", "constexpr bool kPairSum = false;")],
    # the two partials summed by halves at hd 128 too
    "pair_sum_hd128": [("constexpr bool kPairSum = HD == 64;", "constexpr bool kPairSum = true;")],
    # product 5 issued behind products 3-4 in flight, in one group
    "p5_in_flight": [(_T2_WAIT, "    issue_dq<HD>(dqa, ds_addr, k_addr);\n"),
                     ("    hopper::wgmma_wait<0>();\n    hopper::fence_operand(dka);",
                      "    hopper::wgmma_wait<0>();\n    hopper::fence_operand(pf);\n"
                      "    hopper::fence_operand(dsf);\n    hopper::fence_operand(dka);")],
    # no turns at the tensor cores (the buffers' reuse then races: timing only)
    "no_turns": [("  const auto take_turn = [&]() { hopper::bar_sync(1 + wg, 256); };",
                  "  const auto take_turn = [&]() {};"),
                 ("    if (!(wg == 1 && last)) hopper::bar_arrive(2 - wg, 256);", "    (void)last;"),
                 ("  if (wg == 1) hopper::bar_arrive(1, 256);  // warpgroup 0 takes the first turn",
                  "")],
    # the mask folded into the exp2 loop as a select on every tile
    "mask_fused": [(
        """      for (int c = 0; c < 4; ++c) sc[n][c] = ex2(sc[n][c] - ((c & 1) ? l2.y : l2.x));
    }
    if (keep != nullptr || q0 < k_lo + 63 || q0 + kBQ > S) {  // a pass of its own: most tiles skip it
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = q0 + 8 * n + 2 * t + (c & 1);
          if (!(kept[c >> 1] && key[c >> 1] <= q && q < S)) sc[n][c] = 0.f;
        }
    }""",
        """      for (int c = 0; c < 4; ++c) {
        const int q = q0 + 8 * n + 2 * t + (c & 1);
        const float x = ex2(sc[n][c] - ((c & 1) ? l2.y : l2.x));
        sc[n][c] = !masked || (kept[c >> 1] && key[c >> 1] <= q && q < S) ? x : 0.f;
      }
    }"""), (
        "#pragma unroll\n    for (int n = 0; n < kBQ / 8; ++n) {\n      const float2 l2",
        "    const bool masked = keep != nullptr || q0 < k_lo + 63 || q0 + kBQ > S;\n"
        "#pragma unroll\n    for (int n = 0; n < kBQ / 8; ++n) {\n      const float2 l2")],
    # the query heads outermost, the tiles from the end of S within a head
    "heads_outer": [("    h = kvh * G + step % G;\n    q0 = (last_qt - step / G) * kBQ;",
                     "    const int per = last_qt - k0 / kBQ + 1;\n    h = kvh * G + step / per;\n"
                     "    q0 = (last_qt - step % per) * kBQ;")],
}
SHAPES = (("llama3-1b", dict(B=4, S=2048, H=32, kvH=8, hd=64), False),
          ("bloom-560m alibi", dict(B=4, S=2048, H=16, kvH=16, hd=64), True),
          ("hd 128", dict(B=1, S=2048, H=32, kvH=8, hd=128), False))


def build(names):
    """{name: the C entry ds_flash_bwd}: the committed library and each
    variant, the variants' nvcc runs started together."""
    BUILD.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"variant {name}: the source no longer holds {old[:60]!r}")
            src = src.replace(old, new)
        path = BUILD / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-I", str(op_builder.CSRC_DIR), "-o",
             str(BUILD / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {"committed": op_builder.load("flash_attention_bwd").ds_flash_bwd}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{out}")
        fn = ctypes.CDLL(str(BUILD / f"{name}.so")).ds_flash_bwd
        fn.argtypes = op_builder.KERNELS["flash_attention_bwd"]["ds_flash_bwd"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def time_ms(fn, iters=20):
    """Median device ms a call over 5 groups of ``iters`` (CUDA events), the
    card held in a spin while the host enqueues each group."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2, help="palindromes a shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    entries = build([n for n in args.variants.split(",") if n])
    dev = torch.device("cuda")
    report = {"card": card, "shapes": {}}
    for label, shape, alibi in SHAPES:
        q, k, v, do, _ = flash_inputs(dev, **shape)
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        qs = fa.prescale_q(q)
        sl = fa.alibi_log2(alibi_slopes(shape["H"], dev)) if alibi else None
        out, lse = fa.flash_fwd(qs, k, v, None, sl)
        delta = fa.flash_delta(do, out)
        B, S, H, hd = qs.shape
        rows = -(-S // fa._BWD_PAD_ROWS) * fa._BWD_PAD_ROWS
        got = {}

        def call(entry, outs):
            dq, dk, dv, acc = outs
            err = entry(qs.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                        None if sl is None else sl.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), B, S, H, k.shape[2], hd, ctypes.c_float(hd ** -0.5),
                        ctypes.c_float(fa._LN2), 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"ds_flash_bwd failed: cudaError {err}")

        for name, entry in entries.items():
            outs = (torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v),
                    torch.empty((B, H, rows, hd), dtype=torch.float32, device=dev))
            call(entry, outs)
            torch.cuda.synchronize()
            got[name] = outs
        ref = got["committed"]
        # within the flash checks' row rule of the committed outputs; dk and dv
        # bit-equal too unless the variant sums them in another order
        agrees = {name: all(row_rel_l2(a, r) <= 2e-2 for a, r in zip(o[:3], ref[:3]))
                  for name, o in got.items()}
        bit_equal = {name: bool(torch.equal(o[1], ref[1]) and torch.equal(o[2], ref[2]))
                     for name, o in got.items()}
        order = list(entries)
        readings = {name: [] for name in order}
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                readings[name].append(time_ms(lambda: call(entries[name], got[name])))
        flops = 5 * 2 * B * H * S * (S + 1) // 2 * hd
        print(f"{label} {shape}: " + ", ".join(
            f"{name} {sum(ts) / len(ts):.4f} ms ({flops / (sum(ts) / len(ts)) / 1e9:.1f} TFLOP/s"
            f"{'' if agrees[name] else ', DISAGREES'}{'' if bit_equal[name] else ', dk dv not bit-equal'})"
            for name, ts in readings.items()), flush=True)
        report["shapes"][label] = {name: {"ms": readings[name], "agrees": agrees[name],
                                          "dk_dv_bit_equal": bit_equal[name]} for name in order}
        del got, ref, q, k, v, do, qs, out, lse, delta
        torch.cuda.empty_cache()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

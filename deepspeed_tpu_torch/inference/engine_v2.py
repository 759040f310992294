"""Continuous-batching inference engine (counterpart of
``deepspeed_tpu/inference/engine_v2.py``).

Sequences are identified by uid, tokens are pushed with ``put(uids, tokens)``,
KV state lives in a paged pool addressed through per-sequence block tables,
and admission control (``can_schedule``/``query``) lets a serving loop pack
prefill chunks and decodes into one step. ``generate`` is the serving loop:
admission and preemption at chain boundaries, one fused prefill+sample step
per admission wave, then one K-step decode chain over every active sequence
(``paged.ragged_decode_chain``), shrinking the chain and then preempting the
youngest sequence under KV-pool pressure, exactly as the JAX engine does.

An MoE model (``num_experts > 0``, the Mixtral form) serves through
``inference/model.py:_moe``: prefill and decode steps of at least 2E
tokens, pads included, go through the hand-written grouped GEMM.

Quantised serving: ``kv_cache_dtype`` 'int8' | 'fp8' stores the pool as
1-byte codes plus one fp32 scale per (layer, slot, kv head) head vector
(``inference/paged.py``), and ``quant.enabled`` quantises the weights before
they are placed (``inference/woq.py``): int8/int4/fp8 codes and fp32 scales
live on the device, and every weight read dequantises. WOQ of an MoE
model's experts is not ported and raises.

The engine runs on the card (``device="cuda"``, the default) unless the
caller passes ``device="cpu"``; on the CPU every kernel-backed op takes its
plain PyTorch version. Settings beyond the dense single-device slice (a
float ``kv_cache_dtype`` other than ``dtype``, prefix cache, speculative
decoding, tensor or expert parallelism, disaggregated roles, SLO tracking,
the flight recorder, a refusing HBM check) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch.config.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.inference.config import QuantConfig
from deepspeed_tpu_torch.inference.paged import (
    KV_QUANT_DTYPES,
    init_pool,
    ragged_decode_chain,
    ragged_forward,
)
from deepspeed_tpu_torch.inference.ragged import (
    BatchStaging,
    RaggedBatch,
    StateManager,
    build_ragged_batch,
)
from deepspeed_tpu_torch.inference.sampling import sample_logits
from deepspeed_tpu_torch.inference.woq import WOQTensor, quantize_params, woq_format
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.hbm import kv_blocks_for_bytes, kv_slot_bytes
from deepspeed_tpu_torch.utils.logging import log_dist

_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "float32": torch.float32,
}
# float dtype names the JAX engine accepts beside the ported ones
_FLOAT_NAMES = ("fp16", "float16", "half")
# the JAX engine's ``serving_slo`` fields at their defaults
_SERVING_SLO_DEFAULTS = {"ttft_ms": None, "tpot_ms": None, "window_s": 30.0,
                         "admission": "none", "admission_ttft_factor": 1.0}


@dataclasses.dataclass
class RaggedInferenceConfig(DeepSpeedConfigModel):
    """v2 engine config: the JAX package's field names and defaults for the
    settings this port carries."""

    dtype: str = "bf16"
    tp_size: int = 1
    ep_size: int = 1
    kv_block_size: int = 16
    num_kv_blocks: int = 512
    kv_cache_dtype: Optional[str] = None
    kv_pool_bytes: Optional[int] = None
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    max_seqs: int = 64
    max_seq_len: Optional[int] = None
    row_bucket: int = 8
    chunk_bucket: int = 16
    decode_chain: int = 8
    prefix_cache: bool = False
    prefix_cache_fraction: float = 0.5
    prefix_cache_hash_bytes: bool = True
    role: str = "mixed"
    migration_depth: int = 2
    spec_decode: int = 0
    spec_ngram: int = 2
    # the JAX engine's pre-flight HBM-fit check ("warn" | "refuse" | "off"):
    # the port makes none (an allocation that does not fit raises PyTorch's
    # own out-of-memory error), so "refuse" is not ported
    hbm_check: str = "warn"
    # the JAX engine's ``serving_slo`` block, as a dict of its fields: its
    # targets feed per-request latency tracking and router admission, neither
    # of which is ported, so only JAX's defaults are accepted
    serving_slo: dict = dataclasses.field(default_factory=dict)
    flight_recorder: bool = False

    def __post_init__(self):
        if isinstance(self.quant, dict):
            self.quant = QuantConfig.from_dict(self.quant)
        if self.hbm_check not in ("warn", "off"):
            raise NotImplementedError(
                f"RaggedInferenceConfig.hbm_check={self.hbm_check!r} is not ported to PyTorch "
                "(the port makes no pre-flight HBM check: 'warn' | 'off')")
        out_of_slice = {
            "tp_size": (self.tp_size, 1),
            "ep_size": (self.ep_size, 1),
            "prefix_cache": (self.prefix_cache, False),
            "prefix_cache_fraction": (self.prefix_cache_fraction, 0.5),
            "prefix_cache_hash_bytes": (self.prefix_cache_hash_bytes, True),
            "role": (self.role, "mixed"),
            "migration_depth": (self.migration_depth, 2),
            "spec_decode": (self.spec_decode, 0),
            "spec_ngram": (self.spec_ngram, 2),
            "serving_slo": ({**_SERVING_SLO_DEFAULTS, **self.serving_slo},
                            _SERVING_SLO_DEFAULTS),
            "flight_recorder": (self.flight_recorder, False),
        }
        for name, (got, want) in out_of_slice.items():
            if got != want:
                raise NotImplementedError(
                    f"RaggedInferenceConfig.{name}={got!r} is not ported to PyTorch "
                    f"(only {name}={want!r})")
        if self.dtype.lower() not in _DTYPES:
            raise NotImplementedError(f"dtype={self.dtype!r}: bf16 | fp32 only")
        if self.kv_quant is None:
            kv = (self.kv_cache_dtype or self.dtype).lower()
            if kv not in _DTYPES or _DTYPES[kv] != self.torch_dtype:
                raise NotImplementedError(
                    f"kv_cache_dtype={self.kv_cache_dtype!r}: a float pool is stored in the "
                    "compute dtype; a float pool of another dtype is not ported")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype.lower()]

    @property
    def kv_quant(self) -> Optional[str]:
        """None | 'int8' | 'fp8': the quantised storage of the KV pool."""
        name = (self.kv_cache_dtype or "").lower()
        if name in KV_QUANT_DTYPES:
            return name
        if name and name not in _DTYPES and name not in _FLOAT_NAMES:
            raise ValueError(
                f"kv_cache_dtype must be a float dtype name or 'int8'|'fp8', "
                f"got {self.kv_cache_dtype!r}")
        return None

    @property
    def kv_dtype_name(self) -> str:
        """The pool's storage name ('int8' | 'fp8' | a float name)."""
        return (self.kv_cache_dtype or self.dtype).lower()


def _check_servable(cfg: TransformerConfig, quant: QuantConfig) -> None:
    """The serving forward carries the sequential-block decoder in the Llama
    form (RMSNorm, RoPE, SiLU-GLU, GQA, untied head), with a dense or an MoE
    FFN (the Mixtral form), and the Bloom form (LayerNorm, ALiBi, GELU,
    q/k/v/dense/MLP biases, tied head, embedding LayerNorm), each setting
    read on its own (relu and exact GELU too). ``TransformerConfig`` refuses
    parallel blocks, an LM-head bias, partial or interleaved rotary and
    PR-MoE at construction; learned positions, which training accepts, and
    weight-only quantisation of an MoE model's experts are refused here."""
    if cfg.position == "learned":
        raise NotImplementedError(
            "TransformerConfig.position='learned': the PyTorch port does not serve it")
    if cfg.num_experts and quant.enabled:
        raise NotImplementedError(
            "quant.enabled with num_experts > 0: weight-only quantisation of the MoE experts "
            "is not ported to PyTorch")


class InferenceEngineV2:
    """uid-keyed continuous batching over a paged KV pool."""

    def __init__(
        self,
        model_config: TransformerConfig,
        params: Dict[str, Any],
        config: Union[RaggedInferenceConfig, Dict, None] = None,
        device: Any = "cuda",
    ):
        if config is None:
            config = {}
        if isinstance(config, dict):
            config = RaggedInferenceConfig.from_dict(config)
        _check_servable(model_config, config.quant)
        self.device = resolve_device(device)
        self.model_config = model_config
        self.config = config
        dtype = config.torch_dtype
        if model_config.dtype != dtype:
            raise NotImplementedError(
                f"model dtype {model_config.dtype} != engine dtype {dtype}: the port "
                "computes in the pool's dtype")

        max_len = config.max_seq_len or model_config.max_seq_len
        self.max_seq_len = max_len
        self.max_pages = -(-max_len // config.kv_block_size)
        cfg = model_config
        kv_quant = config.kv_quant
        itemsize = torch.tensor([], dtype=dtype).element_size()
        # the real (quantised or dense) bytes of a token slot size the pool
        self.kv_bytes_per_token = kv_slot_bytes(cfg.num_layers, cfg.kv_heads,
                                                cfg.dims_per_head, itemsize, kv_quant)
        if config.kv_pool_bytes is not None:
            num_blocks = kv_blocks_for_bytes(config.kv_pool_bytes, cfg.num_layers,
                                             config.kv_block_size, cfg.kv_heads,
                                             cfg.dims_per_head, itemsize, kv_quant)
        else:
            num_blocks = config.num_kv_blocks
        self.num_kv_blocks = num_blocks
        self.state = StateManager(num_blocks, config.kv_block_size, config.max_seqs,
                                  max_blocks_per_seq=self.max_pages)
        self._staging = BatchStaging(self.max_pages)

        if config.quant.enabled:
            # WOQ before placement, as the JAX engine does at tp 1: the codes
            # and scales are placed as they are, never cast
            params = quantize_params(params, woq_format(config.quant),
                                     min_size=config.quant.min_leaf_size,
                                     classes=config.quant.tensor_classes)

        def place(tree):
            return {k: place(v) if isinstance(v, dict)
                    else v.placed(self.device) if isinstance(v, WOQTensor)
                    else v.to(self.device, dtype)
                    for k, v in tree.items()}

        self.params = place(params)
        self.pool = init_pool(cfg, num_blocks, config.kv_block_size, dtype, self.device,
                              kv_quant=kv_quant)
        n_params = cfg.num_params()
        log_dist(
            f"InferenceEngineV2: {n_params/1e6:.1f}M params, "
            f"{num_blocks}x{config.kv_block_size} KV slots "
            f"[{config.kv_dtype_name}, {self.kv_bytes_per_token} B/token], "
            f"device={self.device}")
        self._chain_buf: Dict[int, Dict[str, np.ndarray]] = {}
        # Serving-loop accounting (plain int adds).
        self.dispatch_count = 0   # device steps dispatched (prefill steps + chains)
        self.host_sync_count = 0  # host blocking fetches
        self.tokens_decoded = 0   # decode tokens produced by generate()
        self.chain_steps = 0      # decode-chain dispatches
        self.model_forwards = 0   # layer-stack passes (a K-step chain is K)

    # ---------------------------------------------------------------- admission
    def query(self, uid: int) -> Tuple[int, int]:
        """(seen_tokens, free_kv_slots) for scheduler accounting."""
        seq = self.state.get(uid)
        seen = seq.seen_tokens if seq is not None else 0
        return seen, self.state.free_blocks * self.config.kv_block_size

    def can_schedule(self, uids: Sequence[int], token_counts: Sequence[int]) -> bool:
        return self.state.can_schedule(uids, token_counts)

    def flush(self, uid: int) -> None:
        self.state.flush(uid)

    def chain_window(self, budgets: Sequence[int], k: int) -> List[int]:
        """KV tokens one K-step chain may consume per row."""
        return [min(k, b) for b in budgets]

    # ---------------------------------------------------------------- put
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _step(self, batch: RaggedBatch) -> torch.Tensor:
        logits, self.pool = ragged_forward(
            self.params, self.model_config, self.pool,
            self._to_device(batch.tokens), self._to_device(batch.positions),
            self._to_device(batch.new_lens), self._to_device(batch.block_tables),
            self.config.kv_block_size)
        self.dispatch_count += 1
        self.model_forwards += 1
        return logits

    def _build_batch(self, uids, token_lists) -> RaggedBatch:
        return build_ragged_batch(self.state, uids, token_lists, self.max_pages,
                                  self.config.row_bucket, self.config.chunk_bucket,
                                  staging=self._staging)

    def put(self, uids: Sequence[int], token_lists: Sequence[np.ndarray]) -> np.ndarray:
        """Push new tokens for each uid; returns last-token logits
        ``[len(uids), V]`` as fp32 numpy. Mixed prefill/decode is fine: pass a
        whole prompt for new sequences and single tokens for decodes."""
        if not self.can_schedule(uids, [len(t) for t in token_lists]):
            raise RuntimeError("insufficient KV blocks/slots; call can_schedule first")
        batch = self._build_batch(uids, token_lists)
        logits = self._step(batch)
        for uid, toks in zip(uids, token_lists):
            self.state.get(uid).seen_tokens += len(toks)
        out = logits[: len(uids)].float().cpu().numpy()
        self.host_sync_count += 1
        return out

    def _put_sample(self, uids, token_lists, generator: torch.Generator,
                    sample_kw: Dict[str, Any]) -> np.ndarray:
        """Fused put+sample: push tokens, return the sampled next-token ids
        ``[len(uids)]``. One step, one host sync, no logits transfer."""
        batch = self._build_batch(uids, token_lists)
        logits = self._step(batch)
        toks = sample_logits(logits, generator, **sample_kw)
        for uid, t in zip(uids, token_lists):
            self.state.get(uid).seen_tokens += len(t)
        out = toks[: len(uids)].cpu().numpy()
        self.host_sync_count += 1
        return out

    # ---------------------------------------------------------------- chain
    def _chain_arrays(self, rows: int) -> Dict[str, np.ndarray]:
        buf = self._chain_buf.get(rows)
        if buf is None:
            buf = {
                "tokens": np.zeros((rows,), np.int32),
                "pos": np.zeros((rows,), np.int32),
                "tables": np.zeros((rows, self.max_pages), np.int32),
                "active": np.zeros((rows,), bool),
                "budgets": np.zeros((rows,), np.int32),
            }
            self._chain_buf[rows] = buf
        else:
            buf["tables"][:] = 0
            buf["active"][:] = False
            buf["budgets"][:] = 0
        return buf

    def decode_chain(
        self,
        uids: Sequence[int],
        last_tokens: Sequence[int],
        budgets: Sequence[int],
        k: int,
        generator: Optional[torch.Generator] = None,
        eos_id: Optional[int] = None,
        sample_kw: Optional[Dict[str, Any]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Run one K-step chained decode over ``uids``.

        Caller must have verified ``can_schedule(uids, chain_window(budgets, k))``.
        Returns ``(tokens [n, k], emitted [n])`` where ``tokens[i, :emitted[i]]``
        are the new tokens of ``uids[i]`` (an EOS token, when hit, is included
        and the row stops). seen_tokens advances by ``emitted[i]``, exactly
        the KV slots written.
        """
        n = len(uids)
        rows = -(-n // self.config.row_bucket) * self.config.row_bucket
        # pre-extend every row's block table for its share of the K-token
        # window (capped by the row's remaining budget), so the chain never
        # needs the allocator mid-chain
        buf = self._chain_arrays(rows)
        for i, uid in enumerate(uids):
            seq = self.state.extend(uid, min(k, int(budgets[i])))
            buf["tables"][i, : seq.n_blocks] = seq.blocks
            buf["pos"][i] = seq.seen_tokens
        buf["tokens"][:n] = last_tokens
        buf["active"][:n] = True
        buf["budgets"][:n] = np.minimum(budgets, k)
        out, emitted, _, self.pool = ragged_decode_chain(
            self.params, self.model_config, self.pool,
            self._to_device(buf["tokens"]), self._to_device(buf["pos"]),
            self._to_device(buf["tables"]), self.config.kv_block_size,
            self._to_device(buf["active"]), self._to_device(buf["budgets"]),
            generator, k, eos_id, **(sample_kw or {}))
        self.dispatch_count += 1
        self.model_forwards += k
        out = out[:n].cpu().numpy()
        emitted = emitted[:n].cpu().numpy()
        self.host_sync_count += 1
        for uid, e in zip(uids, emitted):
            self.state.get(uid).seen_tokens += int(e)
        return out, emitted

    # ---------------------------------------------------------------- serving loop
    def generate(
        self,
        prompts: Sequence[np.ndarray],
        max_new_tokens: int = 32,
        eos_token_id: Optional[int] = None,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
    ) -> List[np.ndarray]:
        """Continuous-batching loop over ``prompts``; returns each prompt's new
        tokens (``max_new_tokens`` of them, or fewer ending in EOS).

        Each round admits pending prompts (FIFO, while they fit beside one
        token of headroom per decoding sequence) as one fused prefill+sample
        step, then decodes every active sequence with one K-step chain. When
        the pool cannot fit the next chain window, the chain first shrinks,
        then the youngest active sequence is preempted: flushed and
        re-queued at the front with its full context.
        """
        prompts = [np.asarray(p, np.int32) for p in prompts]
        pool_tokens = self.num_kv_blocks * self.config.kv_block_size
        for i, p in enumerate(prompts):
            if len(p) + max_new_tokens > self.max_seq_len:
                raise ValueError(
                    f"prompt {i} ({len(p)} tokens) + max_new_tokens={max_new_tokens} "
                    f"exceeds engine max_seq_len={self.max_seq_len}")
            if len(p) + max_new_tokens > pool_tokens:
                raise ValueError(
                    f"prompt {i} ({len(p)} tokens) + max_new_tokens={max_new_tokens} "
                    f"cannot ever fit the KV pool ({pool_tokens} slots); no amount of "
                    f"preemption can complete it")
        sample_kw = dict(do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        queue: deque = deque(range(len(prompts)))  # idx, FIFO
        gen: Dict[int, List[int]] = {i: [] for i in range(len(prompts))}
        active: Dict[int, int] = {}  # uid -> idx
        order: Dict[int, None] = {}  # admission order (insertion-ordered set)
        outputs: Dict[int, np.ndarray] = {}
        next_uid = 0

        def context(idx: int) -> np.ndarray:
            return np.concatenate([prompts[idx], np.asarray(gen[idx], np.int32)])

        def accept(u: int, t: int) -> None:
            """Record token t for uid u; retire the row if done."""
            idx = active[u]
            gen[idx].append(int(t))
            if len(gen[idx]) >= max_new_tokens or (
                    eos_token_id is not None and int(t) == eos_token_id):
                outputs[idx] = np.asarray(gen[idx], np.int32)
                active.pop(u)
                order.pop(u)
                self.flush(u)

        while queue or active:
            # ---- admit pending prompts (fused prefill + first-token sample)
            adm_uids: List[int] = []
            adm_tokens: List[np.ndarray] = []
            decoding = list(active.keys())  # reserve 1-token decode headroom
            while queue and len(active) < self.config.max_seqs:
                cand = context(queue[0])
                if not self.can_schedule(
                        decoding + adm_uids + [next_uid],
                        [1] * len(decoding) + [len(t) for t in adm_tokens] + [len(cand)]):
                    break
                active[next_uid] = queue.popleft()
                order[next_uid] = None
                adm_uids.append(next_uid)
                adm_tokens.append(cand)
                next_uid += 1
            if adm_uids:
                toks = self._put_sample(adm_uids, adm_tokens, generator, sample_kw)
                for u, t in zip(adm_uids, toks):
                    accept(u, t)
            if not active:
                if queue and not adm_uids:
                    raise RuntimeError(
                        f"KV pool too small for a single sequence "
                        f"({self.num_kv_blocks} blocks x {self.config.kv_block_size})")
                continue

            # ---- one chained decode over the active set; K stays pinned at
            # decode_chain (per-row budgets mask the max_new_tokens tail), only
            # KV-pool pressure shrinks it, then preempts the youngest sequence
            uids = list(active.keys())
            budgets = [max_new_tokens - len(gen[active[u]]) for u in uids]
            k = self.config.decode_chain
            while True:
                while k > 1 and not self.can_schedule(uids, self.chain_window(budgets, k)):
                    k -= 1
                if self.can_schedule(uids, self.chain_window(budgets, k)):
                    break
                victim = next(reversed(order))
                del order[victim]
                i = uids.index(victim)
                uids.pop(i)
                budgets.pop(i)
                queue.appendleft(active.pop(victim))
                self.flush(victim)
                if not uids:
                    raise RuntimeError(
                        f"KV pool too small for a single sequence "
                        f"({self.num_kv_blocks} blocks x {self.config.kv_block_size})")
                k = self.config.decode_chain
            last = [gen[active[u]][-1] for u in uids]
            out, emitted = self.decode_chain(uids, last, budgets, k, generator,
                                             eos_id=eos_token_id, sample_kw=sample_kw)
            self.tokens_decoded += int(emitted.sum())
            self.chain_steps += 1
            for i, u in enumerate(uids):
                for t in out[i, : emitted[i]]:
                    if u in active:
                        accept(u, t)
        return [outputs[i] for i in range(len(prompts))]

"""Roofline terms of the dry run's traced programs.

Counterpart of ``repro/launch/hlo_analysis.py``, which reads compiled XLA
programs (HLO).  The port has no HLO: ``launch/dryrun.py`` runs each
PyTorch step as one device's DTensor program on ``meta`` tensors and
counts its FLOPs, the bytes each operation reads and writes and the
collectives it issues; this module turns those counts into the roofline.

* :class:`Roofline` takes the card's rates as fields, the H100's by
  default (``H100_PEAK_FLOPS_BF16``, ``H100_HBM_BW``,
  ``H100_NVLINK_BW``: data-sheet constants), where the reference fixes
  TPU v5e's.
* :func:`record_collectives` records the collectives a program issues:
  DTensor's (the ``_c10d_functional`` ops and DTensor's all-to-all, each
  with its result's bytes) and the port's own
  (``distributed/collectives.py``, the shard-map MoE dispatch's), under
  the reference's kinds; :func:`collective_bytes` weighs them by the
  reference's ring factors (``_TRAFFIC_FACTOR``) into one device's wire
  bytes, as the reference sums them from the HLO text.
* :func:`analyze` builds one cell's report from a trace's counts, as
  the reference's reads a compiled executable.
* ``_avg_kv``, ``inner_corrections``, ``analytic_model_flops`` and
  ``active_params`` are the reference's closed forms, verbatim;
  :func:`kernel_call_corrections` applies ``inner_corrections``'
  attention term to the attention kernels' calls that a trace recorded
  (their meta branch counts nothing else).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# --- NVIDIA H100 SXM per-card constants (data sheet, at 700 W) ---
H100_PEAK_FLOPS_BF16 = 989e12   # FLOP/s, dense bf16 on the tensor cores
H100_HBM_BW = 3.35e12           # B/s
# NVLink 4: the data sheet's 900 GB/s counts both directions; a ring
# collective sends each of its bytes one way
H100_NVLINK_BW = 450e9          # B/s, one direction

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# ring traffic factor x result bytes (per-device bytes on the wire), the
# reference's
_TRAFFIC_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,          # output bytes ~ gathered size
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
# torch's collective ops -> the reference's kinds
_OP_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor", "c10d")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_bytes(record) -> CollectiveStats:
    """One device's collective traffic from a record of ``(kind, result
    bytes)`` entries (:func:`record_collectives`): the count of each
    kind and its bytes weighted by the ring factor, as the reference
    sums its HLO text's collectives."""
    counts: dict = {}
    by_kind: dict = {}
    for kind, nbytes in record:
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = (by_kind.get(kind, 0.0)
                         + nbytes * _TRAFFIC_FACTOR[kind])
    return CollectiveStats(counts=counts, bytes_by_kind=by_kind)


def is_collective(func) -> bool:
    """True for a torch collective op (those :func:`record_collectives`
    counts, and their waits)."""
    return func.namespace in _COLLECTIVE_NAMESPACES


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(t) for t in out)
    return 0


def collective_entry(func, out):
    """``(kind, result bytes)`` of a torch collective op and its output,
    or None for any other op."""
    if not is_collective(func):
        return None
    kind = _OP_KINDS.get(func._schema.name.split("::")[-1])
    return None if kind is None else (kind, _nbytes(out))


class _Collectives(TorchDispatchMode):
    """Each collective op on plain (local) tensors -> one record entry;
    DTensor ops are left to DTensor, which issues them."""

    def __init__(self, record: list):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        entry = collective_entry(func, out)
        if entry is not None:
            self.record.append(entry)
        return out


@contextlib.contextmanager
def record_collectives():
    """Yield a list that fills with one ``(kind, result bytes)`` entry per
    collective issued inside the block: each torch collective op (what
    DTensor's redistributions issue) and each collective of
    ``distributed/collectives.py``."""
    from repro_torch.distributed import collectives as col

    record: list = []
    with col.record() as notes, _Collectives(record):
        yield record
        record.extend(notes)


@dataclasses.dataclass
class Roofline:
    """All quantities are PER-DEVICE: the dry run traces one device's
    DTensor program (rank 0's).  ``link_bw`` rates
    ``coll_bytes_per_dev``; without either, the collective term is
    left out."""

    flops: float                  # per-device traced flops (+ corrections)
    bytes_accessed: float         # per-device bytes read and written
    coll_bytes_per_dev: Optional[float]
    n_devices: int
    model_flops: Optional[float] = None   # 6*N*D analytic (GLOBAL)
    peak_flops: float = H100_PEAK_FLOPS_BF16
    hbm_bw: float = H100_HBM_BW
    link_bw: Optional[float] = H100_NVLINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_bytes_per_dev is None or not self.link_bw:
            return None
        return self.coll_bytes_per_dev / self.link_bw

    def _terms(self) -> dict:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self._terms().values())

    @property
    def mfu_bound(self) -> Optional[float]:
        """MODEL_FLOPS / (devices * peak * max-term) — roofline fraction."""
        if not self.model_flops:
            return None
        t = self.step_time_lower_bound
        return self.model_flops / (self.n_devices * self.peak_flops * t)

    @property
    def useful_flop_ratio(self) -> Optional[float]:
        if not self.model_flops:
            return None
        return self.model_flops / max(self.flops * self.n_devices, 1.0)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.mfu_bound,
        }


def analyze(counts: dict, n_devices: int, model_flops: Optional[float] = None,
            corrections: Optional[dict] = None) -> dict:
    """One cell's report from one device's counts (``flops``, ``bytes``,
    ``collectives``: a record of :func:`record_collectives` or its
    :class:`CollectiveStats`, and optionally ``argument_bytes``,
    ``peak_live_bytes`` and ``output_bytes``), as the reference's
    ``analyze`` reads a compiled executable; ``corrections`` are that
    device's ``{flops, bytes}`` the trace cannot see (the attention
    kernels')."""
    corr = corrections or {"flops": 0.0, "bytes": 0.0}
    coll = counts["collectives"]
    if not isinstance(coll, CollectiveStats):
        coll = collective_bytes(coll)
    roof = Roofline(flops=counts["flops"] + corr["flops"],
                    bytes_accessed=counts["bytes"] + corr["bytes"],
                    coll_bytes_per_dev=coll.total_bytes,
                    n_devices=n_devices, model_flops=model_flops)
    out = {"roofline": roof.as_dict(),
           "traced_flops": counts["flops"],
           "correction_flops": corr["flops"],
           "collectives": {"counts": coll.counts,
                           "bytes_by_kind": coll.bytes_by_kind}}
    if "peak_live_bytes" in counts:
        arg, peak = counts["argument_bytes"], counts["peak_live_bytes"]
        out["memory"] = {"argument_bytes_per_dev": arg,
                         "output_bytes_per_dev": counts.get("output_bytes"),
                         "temp_bytes_per_dev": peak - arg,
                         "peak_bytes_per_dev": peak}
    return out


def _avg_kv(S: int, window) -> float:
    """Average kv positions visible per causal query (optional window)."""
    if window is None or window >= S:
        return (S + 1) / 2.0
    w = window
    return (w * (w + 1) / 2.0 + (S - w) * w) / S


def _attn_term(cfg, mult: float, bytes_el: int, B: int, n_layers, Hq, Hkv,
               d_qk, d_v, S_q, kv_avg) -> tuple[float, float]:
    """(flops, bytes) of ``n_layers`` attentions: the scores and the
    weighted sum over ``kv_avg`` keys a query; KV streamed once per q
    block, q and o once."""
    flops = mult * n_layers * 2.0 * B * Hq * S_q * kv_avg * (d_qk + d_v)
    nq = max(S_q // max(cfg.q_block, 1), 1)
    kv_bytes = B * Hkv * kv_avg * (d_qk + d_v) * bytes_el
    qo_bytes = 2 * B * Hq * S_q * d_qk * bytes_el
    return flops, mult * n_layers * (nq * kv_bytes + qo_bytes)


def inner_corrections(cfg, kind: str, B: int, S: int) -> dict:
    """Analytic flops/bytes of the reference's inner loops, which XLA's
    cost model counts once: the attention q/kv block loops, the rwkv
    chunk loop and the mamba time scan.  Train multiplier 4 = fwd +
    remat-refwd + 2x bwd (cfg.remat=True); serve = 1.  (The port's
    traces count every loop iteration; only the attention kernels'
    calls need a term, :func:`kernel_call_corrections`.)"""
    mult = 4.0 if (kind == "train" and cfg.remat) else (2.0 if kind == "train" else 1.0)
    bytes_el = 2 if cfg.dtype == "bfloat16" else 4
    flops = 0.0
    nbytes = 0.0
    L = cfg.n_layers

    def attn_terms(n_layers, Hq, Hkv, d_qk, d_v, S_q, kv_avg):
        nonlocal flops, nbytes
        f, b = _attn_term(cfg, mult, bytes_el, B, n_layers, Hq, Hkv, d_qk,
                          d_v, S_q, kv_avg)
        flops += f
        nbytes += b

    if cfg.block_kind == "rwkv":
        H = cfg.d_model // cfg.rwkv_head_dim
        N = cfg.rwkv_head_dim
        if kind == "decode":
            flops += 6.0 * B * H * N * N * L
            nbytes += L * B * H * N * N * 4 * 2  # state read+write
        else:
            C = cfg.rwkv_chunk
            flops += mult * L * B * H * S * (4.0 * C * N + 4.0 * N * N)
            nbytes += mult * L * B * H * (S // C) * N * N * 4 * 2
        return {"flops": flops, "bytes": nbytes}

    Hq, Hkv, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d_qk, d_v = Hd, Hd
    if cfg.attn_kind == "mla":
        Hkv = Hq
        d_qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        d_v = cfg.v_head_dim

    if kind == "decode":
        ctx = S
        if cfg.global_attn_layers:
            n_glob = len(cfg.global_attn_layers)
            attn_terms(n_glob, Hq, Hkv, d_qk, d_v, 1, ctx)
            attn_terms(L - n_glob, Hq, Hkv, d_qk, d_v, 1,
                       min(ctx, cfg.sliding_window))
        else:
            kv = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
            attn_terms(L, Hq, Hkv, d_qk, d_v, 1, kv)
    else:
        if cfg.family == "audio":
            attn_terms(cfg.n_enc_layers, Hq, Hkv, Hd, Hd, cfg.enc_seq,
                       cfg.enc_seq)               # bidirectional encoder
            attn_terms(L, Hq, Hkv, Hd, Hd, S, _avg_kv(S, None))  # dec self
            attn_terms(L, Hq, Hkv, Hd, Hd, S, cfg.enc_seq)       # cross
        elif cfg.global_attn_layers:
            n_glob = len(cfg.global_attn_layers)
            attn_terms(n_glob, Hq, Hkv, d_qk, d_v, S, _avg_kv(S, None))
            attn_terms(L - n_glob, Hq, Hkv, d_qk, d_v, S,
                       _avg_kv(S, cfg.sliding_window))
        else:
            attn_terms(L, Hq, Hkv, d_qk, d_v, S,
                       _avg_kv(S, cfg.sliding_window))

    if cfg.block_kind == "hybrid":
        Di, Ns = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        steps = 1 if kind == "decode" else S
        flops += mult * L * B * steps * 6.0 * Di * Ns
        nbytes += mult * L * B * steps * Di * Ns * 4 * 2
    return {"flops": flops, "bytes": nbytes}


def kernel_call_corrections(cfg, calls) -> dict:
    """``inner_corrections``' attention term (serve multiplier 1) for each
    call of ``ops.record_meta_calls``: a flash call attends ``Sq``
    queries to ``_avg_kv(Sq, window)`` keys when causal (a prefix's
    extra keys uncounted, as in the reference), to all ``Skv``
    otherwise; a decode call one query to ``min(Skv, window)`` keys (the
    whole cache, as the reference counts a decode).
    Returns ``{"flops", "bytes", "terms": {wrapper name: calls}}``
    (global totals)."""
    flops = nbytes = 0.0
    terms: dict = {}
    for name, a in calls:
        B, Hq, S_q, d_qk = a["q"]
        Hkv, S_kv, d_v = a["k"][1], a["k"][2], a["v"][3]
        window = a["window"]
        if name == "decode_attention":
            # q is (B, Hkv, group, D): Hkv * group heads at one position
            Hq, S_q = Hq * S_q, 1
            kv = min(S_kv, window) if window else S_kv
        elif a["causal"]:
            kv = _avg_kv(S_q, window)
        else:
            kv = S_kv
        bytes_el = 2 if a["dtype"].itemsize == 2 else 4
        f, b = _attn_term(cfg, 1.0, bytes_el, B, 1, Hq, Hkv, d_qk, d_v,
                          S_q, kv)
        flops += f
        nbytes += b
        terms[name] = terms.get(name, 0) + 1
    return {"flops": flops, "bytes": nbytes, "terms": terms}


def analytic_model_flops(cfg, n_tokens: int, kind: str) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) with the train/serve multiplier."""
    n_active = active_params(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * n_tokens


def active_params(cfg) -> float:
    """Per-token active parameter count (routed experts count top_k only)."""
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    if cfg.block_kind == "rwkv":
        mix = 4 * D * D + 2 * D * 64
        mlp = 2 * D * F + D * D
        return L * (mix + mlp) + emb
    if cfg.attn_kind == "mla":
        r = cfg.kv_lora_rank
        attn = (D * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                + D * (r + cfg.qk_rope_dim)
                + r * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * D)
    else:
        attn = (D * cfg.n_heads * cfg.head_dim * 2
                + D * cfg.n_kv_heads * cfg.head_dim * 2)
    if cfg.block_kind == "hybrid":
        di = cfg.ssm_expand * D
        attn += 2 * D * di + di * D + di * (2 * cfg.ssm_state + di // 16)
    if cfg.n_experts:
        Fe = cfg.moe_d_ff
        active_mlp = 3 * D * Fe * (cfg.moe_top_k + cfg.n_shared_experts)
        n_dense = cfg.first_dense_layers
        mlp_total = (L - n_dense) * active_mlp + n_dense * 3 * D * F
        return L * attn + mlp_total + emb
    mlp_mult = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    enc = 0.0
    if cfg.n_enc_layers:
        enc = cfg.n_enc_layers * (attn + mlp_mult * D * F)
        attn = attn * 2  # decoder self + cross
    return L * (attn + mlp_mult * D * F) + emb + enc

"""Analytical latency model of the AMPER accelerator (Sec. 4.2, Table 2).

Counterpart of ``repro/core/hwmodel.py``, a copy of its host arithmetic
(the port imports nothing of ``repro``); the tests hold the two equal
over a grid of :class:`HwConfig`.  ``chip_smoke.py``'s ``fig9`` phase
puts these modeled latencies beside the port's PER measured on a GPU.

We have no TCAM silicon, so the paper's circuit-level component latencies
(Table 2, 45 nm CMOS) parameterise an analytical end-to-end model that
regenerates Fig. 9's curves and the 55x-270x speedup headline.  The model
follows the dataflow of Fig. 6(a):

  per group i:   URNG draw -> query generation -> parallel TCAM search
                 -> candidate writes into the CSP buffer
  per batch:     URNG draws + CSP buffer reads

TCAM arrays are 64x64 (one priority per row); all arrays are searched in
parallel, so search latency is independent of replay size.  The serial
terms are the per-group query pipeline and, dominating at large CSP sizes,
the candidate-set-buffer write throughput (the paper's Fig. 9(c) linearity).
"""
from __future__ import annotations

from dataclasses import dataclass

# Table 2 component latencies (ns).
TCAM_SEARCH_EXACT_NS = 0.58
TCAM_SEARCH_BEST_NS = 1.0
TCAM_WRITE_NS = 2.0
CSB_READ_NS = 0.78
CSB_WRITE_NS = 0.78
URNG_NS = 1.71
QG_KNN_NS = 3.57
QG_FRNN_NS = 2.02

TCAM_ROWS = 64


@dataclass(frozen=True)
class HwConfig:
    er_size: int          # replay entries (one TCAM row each)
    m: int = 20           # groups
    csp_ratio: float = 0.15
    batch: int = 64

    @property
    def n_arrays(self) -> int:
        return -(-self.er_size // TCAM_ROWS)

    @property
    def csp_size(self) -> int:
        return int(self.er_size * self.csp_ratio)


def latency_fr_ns(cfg: HwConfig) -> float:
    """AMPER-fr end-to-end sampling latency (ns).

    One exact-match search per group finds ALL candidates of that group in
    parallel; every matched candidate is written to the CSP buffer.
    """
    per_group = URNG_NS + QG_FRNN_NS + TCAM_SEARCH_EXACT_NS
    csp_writes = cfg.csp_size * CSB_WRITE_NS
    batch_reads = cfg.batch * (URNG_NS + CSB_READ_NS)
    return cfg.m * per_group + csp_writes + batch_reads


def latency_k_ns(cfg: HwConfig) -> float:
    """AMPER-k end-to-end sampling latency (ns).

    Best-match sensing returns ONE nearest neighbour per search, so each
    group needs N_i sequential searches; sum_i N_i == CSP size.  Each hit
    is written to the CSP buffer as it is found.
    """
    per_group_fixed = URNG_NS + QG_KNN_NS
    searches = cfg.csp_size * TCAM_SEARCH_BEST_NS
    csp_writes = cfg.csp_size * CSB_WRITE_NS
    batch_reads = cfg.batch * (URNG_NS + CSB_READ_NS)
    return cfg.m * per_group_fixed + searches + csp_writes + batch_reads


def latency_update_ns(cfg: HwConfig) -> float:
    """Priority update: one TCAM row write per sampled transition."""
    return cfg.batch * TCAM_WRITE_NS


def speedup_vs_gpu(cfg: HwConfig, gpu_per_batch_us: float,
                   variant: str = "fr") -> float:
    """Speedup over a measured GPU PER per-batch sampling latency (us)."""
    ns = latency_fr_ns(cfg) if variant == "fr" else latency_k_ns(cfg)
    return gpu_per_batch_us * 1e3 / ns

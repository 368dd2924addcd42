"""A learner's closed loop over the sharded AMPER-fr replay memory.

The program's entry is ``repro_torch.core.sharded.ShardedAmperSampler``
(``sample``, ``update``) over one mesh axis of ``shards`` slots, all on
this card, as ``repro_torch.launch.dryrun.amper_cell`` lays the
reference's production table out.  One request, issued as soon as the
host has issued the one before it:

1. draws ``batch`` rows (``sample``, on a key split from the seed on
   the card);
2. writes new priorities, uniform in [0, V_max) from the seed, to the
   drawn rows (``update``);
3. sets the next ``inserts`` rows of the ring to the running maximum
   priority (``update``), PER's new transitions.

The table, its priorities uniform in [0, V_max), is made on the card
from the seed.  After the window the plain reference
(``perfbench.reference.amper``) replays every request from the same
table and inputs: each drawn row and the final table must agree.
"""
from __future__ import annotations

import torch

from perfbench.harness.window import Phases, Stamp
from perfbench.reference import amper as ref
from perfbench.reference import threefry as tf


class Driver:
    annotations = ("bench.sample", "bench.update", "bench.insert",
                   "sharded_sample")

    def __init__(self, config: dict, cell: dict, seed: int,
                 device: torch.device, seconds: float):
        self.cfg, self.cell, self.seed, self.dev = config, cell, seed, device
        self.n = 1 << config["capacity_log2"]
        self.shards = config["shards"]
        self.batch, self.inserts = cell["batch"], cell["inserts"]
        self.max_requests = (cell["warm_requests"]
                             + int(cell["max_requests_per_s"] * seconds) + 1)
        self.precision = "float32"
        self.failed = 0

    def _rcfg(self, frac_bits: int | None = None) -> dict:
        c = self.cfg
        return {"m": c["m"], "lam_fr": c["lam_fr"], "v_max": c["v_max"],
                "frac_bits": frac_bits or c["frac_bits"],
                "csp_ratio": c["csp_ratio"]}

    def _table(self, frac_bits: int):
        """The seed's table, shard by shard: codes, live rows and the
        largest priority.  The generator continues into the requests'
        priorities."""
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        n_local, v_max = self.n // self.shards, self.cfg["v_max"]
        pq, valid, top = [], [], []
        for _ in range(self.shards):
            p = torch.rand(n_local, generator=g, device=self.dev) * v_max
            pq.append(ref.quantize(p, v_max, frac_bits))
            valid.append(p > 0)
            top.append(p.max())
        return g, pq, valid, torch.stack(top).max()

    def setup(self) -> None:
        from repro_torch import prng
        from repro_torch.core.amper import AmperConfig
        from repro_torch.core.sharded import (ShardedAmperSampler,
                                              ShardedAmperState)
        from repro_torch.distributed.sharding import Mesh

        c = self.cfg
        self.setup_log = log = Phases(self.dev)
        acfg = AmperConfig(capacity=self.n, m=c["m"], lam_fr=c["lam_fr"],
                           v_max=c["v_max"],
                           csp_capacity=int(self.n * c["csp_ratio"]),
                           frac_bits=c["frac_bits"], fr_mode=c["fr_mode"])
        self.sampler = ShardedAmperSampler(
            acfg, Mesh([self.dev] * self.shards, ("data",)),
            axis_names=("data",))
        self.gen, pq, valid, self.maxp = self._table(c["frac_bits"])
        self.state = ShardedAmperState(pq=tuple(pq), valid=tuple(valid))
        log.mark("table")
        self.keys = prng.split(prng.key(self.seed).to(self.dev),
                               self.max_requests)
        self.ring_rows = torch.arange(self.inserts, device=self.dev)
        self.pos = 0
        self.log = []  # (rows drawn, priorities written, start, drawn, end)
        for i in range(self.cell["warm_requests"]):
            self.step()
            log.mark(f"warm request {i}")
        self.first = len(self.log)

    def step(self) -> bool:
        r = len(self.log)
        if r >= self.max_requests:
            return False
        vals = (torch.rand(self.batch, generator=self.gen, device=self.dev)
                * self.cfg["v_max"])
        start = Stamp(self.dev).record()
        with torch.profiler.record_function("bench.sample"):
            idx = self.sampler.sample(self.state, self.keys[r], self.batch)
        drawn = Stamp(self.dev).record()
        with torch.profiler.record_function("bench.update"):
            self.sampler.update(self.state, idx, vals)
        self.maxp = torch.maximum(self.maxp, vals.max())
        with torch.profiler.record_function("bench.insert"):
            rows = (self.ring_rows + self.pos) % self.n
            self.sampler.update(self.state, rows,
                                self.maxp.expand(self.inserts))
        self.pos = (self.pos + self.inserts) % self.n
        self.log.append((idx, vals, start, drawn, Stamp(self.dev).record()))
        return True

    def finish(self) -> dict:
        done = self.log[self.first:]
        return {"attempted": len(done),
                "units": {"rows": len(done) * self.batch},
                "latencies_ms": [s.ms_to(e) for _, _, s, _, e in done],
                "phases_ms": {"draw": [s.ms_to(d) for _, _, s, d, _ in done],
                              "write": [d.ms_to(e)
                                        for _, _, _, d, e in done]}}

    def release(self) -> None:
        """Keep what the timed path produced (the rows drawn and the final
        table); drop the program's sampler."""
        self.final = (self.state.pq, self.state.valid)
        self.sampler = self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, variant: str | None = None) -> dict:
        """The reference's replay of every request against the program's
        (``variant="control"``: the reference at the nearest integer
        width below the configuration's, int16 codes with 15 fraction
        bits, in the program's place)."""
        frac = self.cfg["frac_bits"]
        rcfg = self._rcfg()
        want = self._replay(frac, rcfg)
        if variant == "control":
            drawn, pq, valid = self._replay(15, self._rcfg(15))
            got = (drawn, pq << (frac - 15), valid)  # codes at frac bits
        elif variant is None:
            got = ([i for i, *_ in self.log],
                   torch.cat(self.final[0]), torch.cat(self.final[1]))
        else:
            raise ValueError(f"unknown variant {variant!r}")
        bad = [int((a.to(torch.int64) != b).sum())
               for a, b in zip(got[0], want[0])]
        self.failed = sum(1 for b in bad[self.first:] if b)
        table = int(((got[1] != want[1]) | (got[2] != want[2])).sum())
        return {"draw_mismatch": sum(bad), "table_mismatch": table}

    def _replay(self, frac_bits: int, rcfg: dict):
        _, pq, valid, maxp = self._table(frac_bits)
        pq, valid = torch.cat(pq), torch.cat(valid)
        keys = tf.split(tf.key(self.seed), len(self.log))
        drawn, pos = [], 0
        rows = torch.arange(self.inserts, device=self.dev)
        for k, (_, vals, *_) in zip(keys, self.log):
            idx = ref.sharded_draw(pq, valid, k, self.batch, rcfg,
                                   self.shards)
            drawn.append(idx)
            ref.write_priorities(pq, valid, idx, vals, rcfg)
            maxp = torch.maximum(maxp, vals.max())
            ref.write_priorities(pq, valid, (rows + pos) % self.n,
                                 maxp.expand(self.inserts), rcfg)
            pos = (pos + self.inserts) % self.n
        return drawn, pq, valid

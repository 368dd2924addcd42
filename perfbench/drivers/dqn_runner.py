"""The DQN trainer's own loop: ``make_dqn(cfg)`` then ``Runner.advance``.

Set-up builds the agent once from the configuration, hands it weights,
an env state and a full replay ring made on the card from the seed (the
ring through ``ReplayBuffer.add_batch``, its priorities uniform in
[0, V_max) through the sampler's priority write), builds the runner
(step keys and schedules for every iteration the window can reach) and
advances it past ``learn_start``: the eager steps, the warm-up and the
capture of the steady step.  The same runner then runs the first three
steady iterations through ``advance``, which the check holds against the
plain reference, ``warm_iters`` more (the loop's first seconds run
slower), and goes on into the window, ``chunk`` iterations a call, with
no synchronisation until the window's end.
"""
from __future__ import annotations

import dataclasses
import statistics

import torch

from perfbench.harness.window import Phases
from perfbench.reference import dqn as ref
from perfbench.reference import threefry as tf

CHECK_STEPS = 3
OBS_SCALE = (2.4, 2.0, 0.21, 3.0)  # CartPole's state bounds, roughly


def _clone(tree, device="cpu"):
    """A copy of a tree of tensors, kept in host memory by default so that
    it adds nothing to the card's peak."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _clone(v, device) for k, v in tree.items()}
    return [_clone(v, device) for v in tree]


def _leaves(params) -> list[torch.Tensor]:
    return [layer[k] for layer in params for k in ("b", "w")]


def norm_gap(got: list, want: list) -> float:
    """The worst leaf's gap between two sides' norms, against the larger
    of the reference leaf's norm and the median leaf's; leaves whose
    reference norm is under a thousandth of the median leaf's are left
    out (moved by round-off alone)."""
    ref_n = [float(w.norm()) for w in want]
    med = statistics.median(ref_n)
    gaps = [abs(float(g.norm()) - r) / max(r, med)
            for g, r in zip(got, ref_n) if r >= 1e-3 * med]
    return max(gaps)


class Driver:
    annotations = ("bench.advance", "replay_sample", "csp_rebuild")

    def __init__(self, config: dict, cell: dict, seed: int,
                 device: torch.device, seconds: float):
        self.cfg, self.cell, self.seed, self.dev = config, cell, seed, device
        self.chunk = cell["chunk"]
        self.window_iters = int(cell["max_iters_per_s"] * seconds)
        self.failed = 0
        self.precision = ("tf32" if device.type == "cuda"
                          and torch.backends.cuda.matmul.allow_tf32
                          else "float32")

    def inputs(self) -> dict:
        """What the harness hands both sides, made on the card from the
        seed in a few large calls: He-initialised weights, the envs'
        first states, a full ring of transitions and its priorities."""
        c, dev = self.cfg, self.dev
        g = torch.Generator(device=dev).manual_seed(self.seed)
        sizes = [4, c["hidden"], c["hidden"], 2]
        shapes = list(zip(sizes[:-1], sizes[1:]))
        flat = torch.randn(sum(a * b for a, b in shapes), generator=g,
                           device=dev)
        params, at = [], 0
        for a, b in shapes:
            w = flat[at:at + a * b].view(a, b) * (2.0 / a) ** 0.5
            params.append({"w": w, "b": torch.zeros(b, device=dev)})
            at += a * b
        cap, e = c["replay_size"], c["num_envs"]
        scale = torch.tensor(OBS_SCALE, device=dev)
        obs = (torch.rand(2, cap, 4, generator=g, device=dev) * 2 - 1) * scale
        done = (torch.rand(cap, generator=g, device=dev)
                < self.cell["done_rate"]).to(torch.float32)
        ring = {"obs": obs[0],
                "action": torch.randint(0, 2, (cap,), generator=g,
                                        device=dev, dtype=torch.int32),
                "reward": torch.ones(cap, device=dev),
                "next_obs": obs[1], "done": done, "terminated": done.clone()}
        return {"params": params,
                "env_x": (torch.rand(e, 4, generator=g, device=dev) - 0.5)
                * 0.1,
                "ring": ring, "fill": cap,
                "priorities": torch.rand(cap, generator=g, device=dev)
                * c["v_max"]}

    def _steady(self, t: int) -> bool:
        c = self.cfg
        return (t >= c["learn_start"] and t % c["train_every"] == 0
                and t % c["target_sync"] != 0)

    def setup(self) -> None:
        from repro_torch import prng
        from repro_torch.rl.dqn import DQNConfig, make_dqn
        from repro_torch.rl.envs import EnvState

        c, dev = self.cfg, self.dev
        self.setup_log = log = Phases(dev)
        fields = {f.name for f in dataclasses.fields(DQNConfig)}
        dqn = make_dqn(DQNConfig(**{k: v for k, v in c.items()
                                    if k in fields}), device=dev)
        scfg = dqn.replay.sampler.cfg
        if (scfg.frac_bits, dqn.replay.eps) != (c["frac_bits"], c["per_eps"]):
            raise ValueError("the program's priority codes or PER epsilon "
                             "differ from the configuration's")
        key = prng.key(self.seed)
        inp = self.inputs()
        st = dqn.init(key)
        x = inp["env_x"]
        log.mark("agent and inputs")
        st = st._replace(
            params=inp["params"], target_params=_clone(inp["params"], dev),
            env_state=EnvState(x=x.clone(), t=torch.zeros(
                x.shape[0], dtype=torch.int32, device=dev)), obs=x.clone())
        rb, buf, step = dqn.replay, st.buffer, self.cell["fill_chunk"]
        for a in range(0, inp["fill"], step):
            buf = rb.add_batch(buf, {k: v[a:a + step]
                                     for k, v in inp["ring"].items()})
        p, ss = inp["priorities"], buf.sampler_state
        for a in range(0, p.shape[0], step):
            ss = rb.sampler.update(ss, torch.arange(
                a, min(a + step, p.shape[0]), device=dev), p[a:a + step])
        st = st._replace(buffer=buf._replace(
            sampler_state=ss,
            max_priority=torch.maximum(buf.max_priority, p.max())))
        del inp
        log.mark("ring filled")
        # the first steady step is the warm-up and capture; the next one
        # is the first replay, from which the check watches three
        t = c["learn_start"]
        while not self._steady(t):
            t += 1
        self.watch = t + 1
        while not self._steady(self.watch):
            self.watch += 1
        if not all(self._steady(self.watch + i) for i in range(CHECK_STEPS)):
            raise ValueError("the checked iterations must all be steady")
        warm = self.cell["warm_iters"]
        self.n_steps = (self.watch + CHECK_STEPS + warm + self.window_iters
                        + self.chunk)
        r = dqn.runner(st, key, self.n_steps, capture=True)
        log.mark("runner (keys, schedules)")
        r.advance(self.watch)
        log.mark("past learn_start, captured")
        self.before = (_clone(r.state.params), _clone(r.state.opt_m))
        r.advance(self.watch + 1)
        self.m_after = _clone(r.state.opt_m)
        r.advance(self.watch + CHECK_STEPS)
        s = r.state
        self.after = {
            "params": _clone(s.params), "ring": _clone(s.buffer.storage),
            "pq": _clone(s.buffer.sampler_state.pq),
            "valid": _clone(s.buffer.sampler_state.valid),
            "loss": _clone(r.loss_tab[self.watch:self.watch + CHECK_STEPS])}
        log.mark("checked steps")
        # the steady loop runs slower for its first seconds (host side):
        # those iterations belong to set-up, not to the window
        self.t = self.watch + CHECK_STEPS + warm
        r.advance(self.t)
        log.mark("warm-up")
        self.runner, self.first = r, self.t

    def step(self) -> bool:
        if self.t >= self.n_steps:
            return False
        stop = min(self.t + self.chunk, self.n_steps)
        with torch.profiler.record_function("bench.advance"):
            self.runner.advance(stop)
        self.t = stop
        return True

    def finish(self) -> dict:
        iters = self.t - self.first
        loss = self.runner.loss_tab[self.first:self.t]
        self.failed = int((~torch.isfinite(loss)).sum())
        return {"attempted": iters,
                "units": {"iterations": iters,
                          "env_steps": iters * self.cfg["num_envs"]},
                "latencies_ms": [], "phases_ms": {}}

    def release(self) -> None:
        self.runner = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, variant: str | None = None) -> dict:
        """The three watched iterations against the reference's run from
        the same inputs (``variant``: ``"control"``, the reference in
        TF32, or a planted fault, ``"half"``, ``"altered"`` or
        ``"env_altered"``, in the program's place)."""
        steps = self.watch + CHECK_STEPS
        run = lambda **kw: ref.run(self.inputs(), self.cfg,  # noqa: E731
                                   tf.key(self.seed), steps, self.watch, **kw)
        want = run()
        if variant is None:
            got = _clone({"loss": list(self.after["loss"]),
                          "params_before": self.before[0],
                          "m_before": self.before[1], "m_after": self.m_after,
                          "params_after": self.after["params"],
                          "ring": self.after["ring"], "pq": self.after["pq"],
                          "valid": self.after["valid"]}, self.dev)
        elif variant == "control":
            got = run(precision="tf32")
        else:
            got = run(fault=variant)

        def grad(side):
            return [(a - 0.9 * b) / (1 - 0.9) for a, b in zip(
                _leaves(side["m_after"]), _leaves(side["m_before"]))]

        def change(side):
            return [a - b for a, b in zip(_leaves(side["params_after"]),
                                          _leaves(side["params_before"]))]

        loss_gap = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                       for a, b in zip(got["loss"], want["loss"]))
        ring = sum(int((got["ring"][k] != want["ring"][k]).sum())
                   for k in want["ring"])
        prio = int(((got["pq"] != want["pq"])
                    | (got["valid"] != want["valid"])).sum())
        return {"loss_gap": loss_gap,
                "grad_norm_gap": norm_gap(grad(got), grad(want)),
                "update_norm_gap": norm_gap(change(got), change(want)),
                "ring_mismatch": ring, "priority_mismatch": prio}

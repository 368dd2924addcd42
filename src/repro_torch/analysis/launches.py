"""The launch budget: CUDA kernel launches on the port's hot path.

Counterpart of ``repro/analysis/jaxpr_lint.py``'s DISPATCH-BUDGET rule
(``check_dispatch_budget``): the reference traces the fused AMPER-fr
draw and counts its dispatches against a committed budget; here the
draw and the trainer's steady agent step are each captured in a CUDA
graph, and the graph's kernel nodes are counted (``graph_nodes``).  A
graph holds exactly the operations its capture put on the stream, so
the count is a property of the code, not of a measurement.  The step's
graph is the one the trainer replays (``DQN.runner``).  Over the budget
is a regression on the paper's hot path (more launches, or an op that
fell out of the graph); under it an improvement the committed number
must absorb; both are ``DISPATCH-BUDGET`` findings, as in the
reference.  The counts depend on the code, not on the table's size, so
the check runs at a small size.

torch.profiler then reads ``PROFILE_REPEATS`` replays of each graph and
counts the kernel events it saw (``profiled_kernels``): the proof that a
replay runs on the card what the graph holds.  The profiler can drop
events, so its reading is reported beside the budget and not held
against it.

The budgets below were read on an NVIDIA H100 80GB HBM3 (700 W) by
``chip_smoke.py``'s ``launch_budget`` phase.  Without CUDA the check
cannot run: it returns its reason as a skip, never a pass.
``BENCH_sampling.json``'s jaxpr counts are another quantity and are not
compared with these.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.analysis.findings import Finding

BUDGET_CARD = "NVIDIA H100 80GB HBM3"
# kernel nodes of each graph, read on BUDGET_CARD
BUDGETS = {
    "amper-fr-fused draw": 57,
    "captured agent step": 378,
}
N_ROWS = 8192       # the check's replay size (the counts do not depend on it)
BATCH = 64
PROFILE_REPEATS = 5  # profiled replays of each graph

# CUgraphNodeType (cuda.h) -> the name a count goes under
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_nodes(graph) -> dict:
    """The nodes of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``
    by type, read from the driver (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``): ``{"kernel", "memcpy", "memset", "other"}``
    (``other``: empty, event and allocation nodes, no work on the card)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]

    def ok(rc: int, call: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{call} failed: CUresult {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts = dict.fromkeys(("kernel", "memcpy", "memset", "other"), 0)
    kind = ctypes.c_int()
    for node in nodes:
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
           "cuGraphNodeGetType")
        counts[_NODE_TYPES.get(kind.value, "other")] += 1
    return counts


def profiled_kernels(fn, repeats: int = PROFILE_REPEATS
                     ) -> tuple[list, Counter]:
    """The kernel events torch.profiler saw in each of ``repeats``
    synchronized ``fn()`` calls, and the kernels' names (with counts) of
    the window that saw the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts, most = [], Counter()
    for _ in range(repeats):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the CPU-side ranges of record_function also land on the device
        # timeline, and copies and fills are not kernels
        ranges = {e.name for e in prof.events()
                  if e.device_type == DeviceType.CPU}
        names = Counter(e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and e.name not in ranges
                        and not e.name.startswith(("Memcpy", "Memset")))
        counts.append(sum(names.values()))
        if counts[-1] >= sum(most.values()):
            most = names
    return counts, most


def captured_draw():
    """One fused AMPER-fr draw with its key on the card, warmed up on a
    side stream and captured in a graph (``keep_graph=True``).  Returns
    the graph and what its replays read (keep it alive while replaying)."""
    import torch

    from repro_torch import prng
    from repro_torch.core.amper import AmperConfig, AmperSampler

    cfg = AmperConfig(capacity=N_ROWS, m=20, lam_fr=2.0, v_max=1.0,
                      csp_capacity=max(int(N_ROWS * 0.15), BATCH),
                      fr_mode="fused")
    amp = AmperSampler(cfg, "fr", device="cuda")
    prio = prng.uniform(prng.key(0).cuda(), (N_ROWS,)) + 0.01
    state = amp.update(amp.init(), torch.arange(N_ROWS, device="cuda"), prio)
    key = prng.key(1).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds the kernels, makes the scratch
        amp.sample(state, key, BATCH)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        amp.sample(state, key, BATCH)
    graph.instantiate()
    return graph, (amp, state, key)


def captured_step():
    """The trainer's runner (CartPole, AMPER-fr fused) past its capture of
    the steady agent step, and one replay; returns the runner."""
    from repro_torch import prng
    from repro_torch.rl.dqn import DQNConfig, make_dqn

    cfg = DQNConfig(env="cartpole", sampler="amper-fr",
                    amper_fr_mode="fused", num_envs=16, replay_size=N_ROWS,
                    batch=BATCH, hidden=128, learn_start=8, target_sync=100)
    dqn = make_dqn(cfg, device="cuda")
    key = prng.key(0)
    # room in the step tables for the profiled replays, which advance the
    # card's step counter
    n = cfg.learn_start + 2 + PROFILE_REPEATS
    runner = dqn.runner(dqn.init(key), key, n)
    runner.advance(cfg.learn_start + 2)  # warm-up, capture, one replay
    if not runner.info["captured"]:
        raise RuntimeError("the agent step was not captured")
    return runner


def check_launch_budget() -> tuple[list[Finding], dict, str | None]:
    """``(findings, counts, skipped)``: a ``DISPATCH-BUDGET`` finding for
    each graph whose kernel nodes are over or under its budget, the
    counts (``{name: {"nodes": graph_nodes, "profiled_kernels": [each
    profiled replay's kernel events], "profiled_names": the fullest
    window's kernel names}}``), and the reason the check could not run
    (``None`` when it ran)."""
    import torch

    if not torch.cuda.is_available():
        return [], {}, ("CUDA is not available: the launch budget counts "
                        "kernel launches on the card")
    card = torch.cuda.get_device_name(0)
    draw, inputs = captured_draw()
    runner = captured_step()  # holds the static buffers the replays read
    counts = {}
    for name, g in (("amper-fr-fused draw", draw),
                    ("captured agent step", runner.graph)):
        seen, names = profiled_kernels(g.replay)
        counts[name] = {"nodes": graph_nodes(g), "profiled_kernels": seen,
                        "profiled_names": dict(names)}
    del inputs, runner
    findings = []
    for name, c in counts.items():
        got, want = c["nodes"]["kernel"], BUDGETS[name]
        where = f"<graph:{name.replace(' ', '-')}>"
        if got > want:
            findings.append(Finding(
                rule="DISPATCH-BUDGET", path=where, line=0,
                message=f"{name} launches {got} kernels, over "
                        f"the committed budget of {want} (read on "
                        f"{BUDGET_CARD}; this card: {card})"))
        elif got < want:
            findings.append(Finding(
                rule="DISPATCH-BUDGET", path=where, line=0,
                message=f"{name} now launches {got} kernels, "
                        f"BELOW the committed {want} (read on "
                        f"{BUDGET_CARD}; this card: {card}) — commit the "
                        f"new count in repro_torch/analysis/launches.py"))
    return findings, counts, None

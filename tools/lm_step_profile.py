#!/usr/bin/env python3
"""Where the LM trainer's step goes, on one GPU.

Builds ``launch.train``'s pieces at full width (stablelm-1.6b, batch 8 x
128 tokens, AMPER-fr over 2,048 sequences) and times, synchronized,
five calls each after two warm ones: the train step, its forward and
backward alone, the forward without grad, the per-sequence loss, and
AdamW alone on fixed gradients.  ``--scan`` picks how the layer loop
takes each layer's params: ``index`` (the port's ``scan_layers``: a
slice a layer, whose backward writes a zero gradient of the whole
stack) or ``unbind`` (each stack unbound once); ``index,unbind,...``
runs them in turns.  Then one step of each is traced by torch.profiler
(device ms by kernel, host ms by op).  Run from the repository root:

    python3 tools/lm_step_profile.py --scan index,unbind,index,unbind
"""
import argparse
import os
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.launch import train as lt  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.qhead import tree_leaves  # noqa: E402
from repro_torch.train.optimizer import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train.train_step import _unflatten_like  # noqa: E402


def unbind_scan(body, carry, xs):
    """``common.scan_layers`` with every stacked tensor unbound once."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves(t)]
        return [tree]

    parts = {id(t): t.unbind(0) for t in leaves(xs)}

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(pick(t, i) for t in tree)
        return parts[id(tree)][i]

    ys = []
    for i in range(common._first_leaf(xs).shape[0]):
        carry, y = body(carry, pick(xs, i))
        ys.append(y)
    return carry, ys


SCANS = {"index": common.scan_layers, "unbind": unbind_scan}


def timed(fn, n: int = 5, warm: int = 2) -> list:
    out = []
    for i in range(n + warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warm:
            out.append(round((time.perf_counter() - t0) * 1e3, 2))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scan", default="index")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_step_profile: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    targs = lt.parse_args(["--batch", "8", "--seq-len", "128", "--n-seqs",
                           "2048", "--steps", "30", "--device", "cuda"])
    _, model, step_fn, data, st, dst = lt.build(targs, dev)
    _, batch = data.sample(dst, prng.fold_in(prng.key(0), 0))
    opt = AdamW(cosine_schedule(3e-4, 20, 30))
    grads = [torch.randn_like(p) * 1e-3 for p in tree_leaves(st.params)]
    box = [st]

    def step():
        with lt.deterministic(dev):
            box[0], _ = step_fn(box[0], batch)

    def fwd_bwd():
        with lt.deterministic(dev), torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(box[0].params)]
            loss, _ = model.loss(_unflatten_like(box[0].params, leaves),
                                 batch)
            torch.autograd.grad(loss, leaves)

    def fwd_nograd():
        with lt.deterministic(dev), torch.no_grad():
            model.loss(box[0].params, batch)

    def seq_loss():
        with lt.deterministic(dev):
            lt.per_sequence_loss(model, box[0].params, batch)

    def adamw():
        opt.update(_unflatten_like(box[0].params, grads), box[0].opt_state,
                   box[0].params)

    print(torch.cuda.get_device_name(0), flush=True)
    scans = args.scan.split(",")
    for name in scans:
        common.scan_layers = transformer.scan_layers = SCANS[name]
        print(name, {"step": timed(step), "fwd_bwd": timed(fwd_bwd),
                     "fwd_nograd": timed(fwd_nograd),
                     "seq_loss": timed(seq_loss)}, flush=True)
    print("adamw", timed(adamw), flush=True)
    for name in dict.fromkeys(scans):
        common.scan_layers = transformer.scan_layers = SCANS[name]
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        print(name, "one step (device time: the tables' Self CUDA total)")
        print(ka.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60))
        print(ka.table(sort_by="self_cpu_time_total", row_limit=12,
                       max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

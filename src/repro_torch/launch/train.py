"""Training launcher: AMPER-prioritized LM training with fault tolerance.

Counterpart of ``repro/launch/train.py``, with the same flags plus
``--device`` (``cuda`` by default; without a card it raises, pass
``--device cpu``).  Runs any decoder-only ``--arch`` (full or
``--reduced``; whisper-tiny, an encoder-decoder, is refused: the
reference's per-sequence loss has no audio path)
with the prioritized sequence-replay data pipeline (``--sampler uniform
| per | amper-fr | amper-k``), periodic atomic checkpoints in the
reference's format, auto-resume from the latest checkpoint, and a
SIGTERM preemption hook: kill the process mid-run and relaunching
continues bit for bit (step-seeded sampling).

Each step: ``data.sample`` with the key ``fold_in(key(seed), step)``,
the train step (autograd through the differentiable attention), the
per-sequence loss (no grad, so on the card each layer's attention is one
launch of the flash kernel), ``data.update``.  Params are drawn from a
``torch.Generator`` seeded with ``--seed`` (the reference's init laws,
torch's numbers).  On the card the step runs with
``torch.use_deterministic_algorithms(True)`` (the embedding's and the
gather's backward accumulate without atomics) and cuBLAS with a fixed
workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before the first
CUDA call when ``main`` makes it), so a resumed run's checkpoints equal
an uninterrupted one's.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch
import torch.utils.deterministic

from repro_torch import prng, resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models.model_api import Model
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import train_step as ts_mod
from repro_torch.train.optimizer import AdamW, cosine_schedule

CUBLAS_WORKSPACE = ":4096:8"


def per_sequence_loss(model, params, batch):
    """Per-sequence mean NLL, the replay priorities (the LM 'TD errors'),
    through ``transformer.forward`` without grad."""
    from repro_torch.models import transformer

    with torch.no_grad():
        logits = transformer.forward(model.cfg, params, batch["tokens"])
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["targets"].to(
            torch.int64)[..., None])[..., 0]
        m = batch["loss_mask"]
        return (nll * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


@contextlib.contextmanager
def deterministic(device: torch.device):
    """On CUDA, deterministic algorithms for the enclosed ops (restored
    after), without their NaN fill of fresh allocations: that fill
    detects reads of uninitialized memory, which no op here makes, and
    would write every temporary twice.  Elsewhere nothing."""
    if device.type != "cuda":
        yield
        return
    det = torch.utils.deterministic
    before = (torch.are_deterministic_algorithms_enabled(),
              det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        det.fill_uninitialized_memory = before[1]


def build(args, device):
    """The run's pieces: (cfg, model, step_fn, data, state, data_state)."""
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the launcher trains decoder-only LMs on token "
            "sequences (its per-sequence loss is transformer.forward, as "
            "the reference's); an encoder-decoder trains through "
            "Model.loss and train/train_step.py with a batch that holds "
            "frames")
    model = Model.from_config(cfg)
    opt = AdamW(cosine_schedule(args.lr, 20, args.steps))
    step_fn = ts_mod.make_train_step(model, opt,
                                     microbatches=args.microbatches)
    tokens = data_mod.corpus_tokens(args.n_seqs, args.seq_len + 1,
                                    cfg.vocab_size, seed=args.seed)
    data = data_mod.PrioritizedSeqData(tokens, args.batch,
                                       sampler=args.sampler, device=device)
    state = ts_mod.init_train_state(
        model, opt, torch.Generator(device=device).manual_seed(args.seed),
        device)
    return cfg, model, step_fn, data, state, data.init()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n-seqs", type=int, default=2048)
    ap.add_argument("--sampler", default="amper-fr",
                    choices=["uniform", "per", "amper-fr", "amper-k"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, on_step=None):
    """Run the launcher.  ``on_step``, when given, gets one dict a step:
    ``step``, the host seconds of each stage (``sample``, ``train_step``,
    ``per_seq_loss``, ``update``; the card synchronized after each), the
    seconds since ``main`` began (``elapsed``), and the step's ``idx``,
    ``metrics`` and ``seq_loss`` tensors."""
    t_main = time.perf_counter()
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    cfg, model, step_fn, data, state, data_state = build(args, device)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir, keep=3,
                                         save_interval=args.ckpt_every)
        mgr.install_preemption_hook()
        latest = mgr.restore_latest((state, data_state))
        if latest[0] is not None:
            start_step, (state, data_state) = latest
            print(f"resumed from step {start_step}")

    record = {}
    clock = [time.perf_counter()]

    def lap(name):
        if on_step is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            record[name] = now - clock[0]
            clock[0] = now

    metrics = None
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        clock[0] = time.perf_counter()
        key = prng.fold_in(prng.key(args.seed), step)
        idx, batch = data.sample(data_state, key)
        lap("sample")
        with deterministic(device):
            state, metrics = step_fn(state, batch)
            lap("train_step")
            seq_loss = per_sequence_loss(model, state.params, batch)
            lap("per_seq_loss")
        data_state = data.update(data_state, idx, seq_loss)
        lap("update")
        if on_step is not None:
            on_step(dict(record, step=step, idx=idx, metrics=metrics,
                         seq_loss=seq_loss,
                         elapsed=time.perf_counter() - t_main))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.perf_counter() - t0):.1f}s)", flush=True)
        if mgr and mgr.should_save(step + 1):
            mgr.save(step + 1, (state, data_state))
            if mgr.preempted:
                print(f"preempted: checkpointed at step {step + 1}, exiting")
                return 0
    if mgr:
        mgr.save(args.steps, (state, data_state))
    final = "n/a" if metrics is None else f"{float(metrics['loss']):.4f}"
    print(f"done: {args.steps} steps, final loss {final}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

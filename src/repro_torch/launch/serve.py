"""Serving launcher: batched prefill + greedy decode with KV caches.

Counterpart of ``repro/launch/serve.py``, for every arch of the zoo.
Prompts are ``prng.randint`` draws, and whisper's frame embeddings and
paligemma's patch embeddings ``prng.normal`` draws, from the reference
CLI's keys, so they equal its inputs for the same ``--seed``; params
are drawn from a ``torch.Generator`` seeded with
``--seed`` (the reference's init laws, torch's numbers).  One untimed
``generate`` first builds the kernels and warms the libraries (its tokens
are the printed sample); then a prefill is timed, and the ``gen - 1``
greedy decode steps from its cache are timed on their own, each reading
after a synchronize.  Prints the prefill time, the decode time per token
and the aggregate tokens/s.  (The reference CLI divides its whole first
``generate``, prefill and compilation included, by ``gen``.)

Example (CPU, reduced; any arch id, e.g. rwkv6-7b, hymba-1.5b,
whisper-tiny, paligemma-3b):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --reduced --device cpu --batch 2 --prompt-len 8 --gen 4
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models.model_api import Model
from repro_torch.serving import Engine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cli_inputs(cfg, seed: int, batch: int, prompt_len: int,
               device="cpu") -> dict:
    """The CLI's inputs, from ``split(key(seed + 1), 3)`` as the reference
    CLI draws them: prompts from the first key, whisper's frame
    embeddings [B, enc_seq, D] from the second and paligemma's patch
    embeddings [B, vis_prefix_len, D] from the third (float32
    normals)."""
    k_tok, k_aud, k_vis = prng.split(prng.key(seed + 1), 3)
    out = {"tokens": prng.randint(k_tok, (batch, prompt_len), 0,
                                  cfg.vocab_size, device=device)}
    if cfg.family == "audio":
        out["frames"] = prng.normal(k_aud, (batch, cfg.enc_seq, cfg.d_model),
                                    device=device)
    if cfg.vis_prefix_len:
        out["patch_embeds"] = prng.normal(
            k_vis, (batch, cfg.vis_prefix_len, cfg.d_model), device=device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = Model.from_config(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, device)

    B = args.batch
    batch = cli_inputs(cfg, args.seed, B, args.prompt_len, device)
    engine = Engine(model, params)
    max_len = engine.cache_len(args.prompt_len, args.gen)

    res = engine.generate(batch, args.gen)  # warm-up
    _sync(device)

    t0 = time.perf_counter()
    logits, cache = engine.prefill(batch, max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: batch={B} prompt={args.prompt_len} "
          f"{t_prefill * 1e3:.1f} ms")

    steps = args.gen - 1
    if steps > 0:
        tok = Engine._choose(logits, 0.0, None, 0)
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = engine.decode(tok, cache)
            tok = Engine._choose(logits[:, -1], 0.0, None, 0)
        _sync(device)
        dt = (time.perf_counter() - t0) / steps
        print(f"decode: {steps} steps, {dt * 1e3:.2f} ms/token "
              f"({B / dt:.1f} tok/s aggregate)")
    print("sample:", res.tokens[0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end driver on the PyTorch port: LM training with AMPER-prioritized
sequence replay.

The port's twin of ``examples/lm_train.py``, with its flags and
``--device`` (the card by default): a thin wrapper over the port's
launcher (``repro_torch.launch.train``) that trains a reduced config for
a few hundred steps with checkpointing; kill it mid-run and rerun to
watch it resume exactly.  The checkpoints go under the system's
temporary directory unless ``--ckpt-dir`` says otherwise.

Run:  PYTHONPATH=src python examples/torch_lm_train.py --steps 200
      PYTHONPATH=src python examples/torch_lm_train.py --device cpu --steps 20
Full-size configs: add --full.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--sampler", default="amper-fr")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_train"))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the replay run")
    args = ap.parse_args(argv)

    train_argv = ["--arch", args.arch, "--steps", str(args.steps),
                  "--sampler", args.sampler, "--ckpt-dir", args.ckpt_dir,
                  "--batch", "8", "--seq-len", "128", "--ckpt-every", "50",
                  "--device", args.device]
    if not args.full:
        train_argv.append("--reduced")
    return train_main(train_argv)


if __name__ == "__main__":
    sys.exit(main())

"""Serving example on the PyTorch port: batched prefill + decode for any
zoo architecture.

The port's twin of ``examples/serve_decode.py``, with its flags and
``--device`` (the card by default): the real KV-cache serving path of
``repro_torch.launch.serve`` (dense / windowed / MLA-latent / recurrent
state caches are chosen by the arch), on the reduced config.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py --arch hymba-1.5b
      PYTHONPATH=src python examples/torch_serve_decode.py --arch rwkv6-7b --device cpu
"""
import argparse
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="where the model and its caches live")
    args = ap.parse_args(argv)
    return serve_main(["--arch", args.arch, "--reduced",
                       "--batch", str(args.batch), "--prompt-len", "32",
                       "--gen", str(args.gen), "--device", args.device])


if __name__ == "__main__":
    sys.exit(main())

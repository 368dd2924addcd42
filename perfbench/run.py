"""The benchmark's command: ``python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout
(see ``perfbench/harness/main.py``)."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every cache the program or its libraries keep lives at a fixed path in
# this checkout, so that only a checkout's first run builds.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))

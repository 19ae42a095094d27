"""Run one cell of the benchmark once, from the root of a checkout:

    python3 vio_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as JSON. The program's
kernel build (``msckf_tpu_torch/build/``) and any other compile cache stay
inside the checkout, so only a checkout's first run builds.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_CACHE = ROOT / ".vio_bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from vio_bench.harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli())

"""Run one cell of the benchmark once, on the card this process starts on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and the correctness checks, each number beside its limit, as the last
lines of standard error. Every build and kernel cache goes under
``build/`` in this checkout."""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / 'build'
os.environ['TRITON_CACHE_DIR'] = str(BUILD / 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = str(BUILD / 'torch_extensions')
os.environ['TORCHINDUCTOR_CACHE_DIR'] = str(BUILD / 'inductor')
os.environ['USE_FLAX'] = '0'
sys.path.insert(0, str(ROOT))

from benchmark.harness import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main.run(sys.argv[1:], START))

"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See portbench/README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one host thread for PyTorch's and the BLAS's CPU pools: the run's host
# work is the launching thread's, and idle pool threads only contend for
# the cores the machine shares
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# every cache of the run lives at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)

from portbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T0))

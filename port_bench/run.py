"""Entry point of the benchmark: see port_bench/harness.py.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, where nle_tpu_torch and its kernel build directory
# (nle_tpu_torch/_build/, a fixed path inside the checkout) lie.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))

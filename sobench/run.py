"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 sobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as one JSON object, the last line of standard output;
exits non-zero with no result when the cell's CUDA devices are missing,
when the program cannot be loaded, or when a module of JAX or of the JAX
package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sobench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))

"""The port's benchmark: run one cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``vulkanhybridrenderer_tpu_torch``) on a machine with the
CUDA cards the cell asks for; ``lib/harness.py`` says what a run does.
"""
import os
import sys
import time


def _process_start() -> float:
    """When this process started, on the wall clock (the kernel's record of
    it where /proc has one, else now)."""
    now = time.time()
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - (uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


STARTED = _process_start()

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root  # the checkout, not this folder
    from portbench.lib import harness

    sys.exit(harness.main(sys.argv[1:], STARTED))

"""Run one cell of the port's benchmark on the card this process finds.

    python3 hwabench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (``hwabench/README.md``); the last lines of standard error are
the numbers compared, each beside its limit.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every build and kernel cache at a fixed path inside the checkout (the
# port's own CUDA builds go to src/repro_torch/_build/ already)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, "hwabench", ".cache", sub)
os.environ["USE_FLAX"] = "0"
# the script's own folder is not a package root: its modules are
# reached as ``hwabench.<name>``
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]

if __name__ == "__main__":
    from hwabench.harness import main
    sys.exit(main(sys.argv[1:], T_START, ROOT))

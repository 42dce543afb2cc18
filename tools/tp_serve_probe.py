"""chip_smoke.py's phases 1, 2 and 22 alone: the environment line, the
kernels' build and tensor-parallel serving (the seed-0 LLaVA-1.5-7B at tp 2
over gloo, two processes on one card, against the same models served by
one process), for the tree at ROOT (default: this checkout). It raises
where phase 22 fails and prints its wall seconds last. About 4 minutes on
one H100:

    python3 tools/tp_serve_probe.py [ROOT]
"""
import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

t0 = time.perf_counter()
smi = cs.phase_environment()
cs.timed("2 build", cs.phase_build)
try:
    cs.timed("22 tp serving", cs.phase_tp_serving, cs._fake_tokenizer(), smi)
finally:
    print(f"probe wall {time.perf_counter() - t0:.1f} s", flush=True)

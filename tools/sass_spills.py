"""Where the kernels of a csrc/ source spill registers: every local-memory
store (STL) and load (LDL) in the SASS, by kernel and by the source line
it came from.

Compiles the source as rlaifv_tpu_torch/ops/_build.py does (its NVCC_FLAGS,
sm_90a) plus -lineinfo into a cubin under build/sass/, prints ptxas's
register and spill report, then disassembles it with nvdisasm's line
information and prints, for each kernel with local-memory traffic, its
STL and LDL counts and each source line that issues them, with the line's
text. Needs the CUDA toolkit (nvcc, nvdisasm):

    python3 tools/sass_spills.py [SOURCE ...]   # default: int4_matmul.cu
"""
import re
import subprocess
import sys
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from rlaifv_tpu_torch.ops import _build  # noqa: E402

LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
FUNC = re.compile(r"\.text\.([A-Za-z0-9_$.]+)")
LOCAL = re.compile(r"\b(STL|LDL)(\.\w+)*\b")


def spills(source: Path) -> None:
    out = ROOT / "build" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / f"{source.stem}.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    ptxas = subprocess.run([_build._nvcc(), *flags, "-lineinfo", "-cubin", "-I",
                            str(_build.CSRC), "-o", str(cubin), str(source)],
                           capture_output=True, text=True, check=True)
    print(f"== {source.name}: ptxas")
    for line in (ptxas.stdout + ptxas.stderr).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.split("info    :")[-1].strip())
    nvdisasm = Path(_build._nvcc()).with_name("nvdisasm")
    sass = subprocess.run([str(nvdisasm), "-g", "-c", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    counts = defaultdict(Counter)  # kernel -> (op, file, line) -> n
    func, where = None, None
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m and (line.lstrip().startswith("//") or line.rstrip().endswith(":")):
            func, where = m.group(1), None
            continue
        m = LINE.search(line)
        if m:
            where = (Path(m.group(1)).name, int(m.group(2)))
            continue
        m = LOCAL.search(line)
        if m and func is not None and not line.lstrip().startswith("//"):
            counts[func][(m.group(1), *(where or ("?", 0)))] += 1
    texts = {}
    for func, c in counts.items():
        ops = Counter()
        for (op, _, _), n in c.items():
            ops[op] += n
        name = subprocess.run(["c++filt", func], capture_output=True, text=True).stdout.strip()
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        print(f"== {name}: {ops['STL']} STL, {ops['LDL']} LDL")
        for (op, file, lno), n in sorted(c.items(), key=lambda kv: (kv[0][1], kv[0][2])):
            path = _build.CSRC / file
            if file not in texts:
                texts[file] = path.read_text().splitlines() if path.exists() else []
            text = texts[file][lno - 1].strip() if 0 < lno <= len(texts[file]) else ""
            print(f"  {op} x{n} {file}:{lno}  {text[:100]}")
    if not counts:
        print(f"== {source.name}: no local-memory instruction")


if __name__ == "__main__":
    for name in sys.argv[1:] or ["int4_matmul.cu"]:
        spills(_build.CSRC / name)

"""Registers, spills and stack frames of the port's CUDA kernels, as ptxas
reports them for sm_90a.

    python scripts/kernel_resources.py [i2sdf_tpu_torch/csrc/FILE.cu ...]

Compiles each source (default: every `i2sdf_tpu_torch/csrc/*.cu`) with the
build's flags (`i2sdf_tpu_torch/ops/kernels/build.py`) and `-Xptxas -v`
into a temporary object, all sources in parallel, and prints one JSON line
per kernel entry: the source, the demangled name, registers, spill stores
and loads (bytes) and stack frame (bytes). Needs `nvcc`, so it runs on the
machine with the card.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from i2sdf_tpu_torch.ops.kernels import build  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def report(text: str) -> list[dict]:
    """One dict per entry function in ptxas's -v output."""
    rows, cur = [], None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            cur = {"name": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := _FRAME.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
    for row, name in zip(rows, demangle([r["name"] for r in rows])):
        row["name"] = name
    return rows


def main(argv: list[str]) -> int:
    srcs = [Path(a) for a in argv] or sorted(build.CSRC.glob("*.cu"))
    nvcc = build.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in srcs]
        failed = False
        for src, proc in procs:
            out, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                print(out, file=sys.stderr)
                failed = True
                continue
            for row in report(out):
                print(json.dumps({"source": src.name, **row}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

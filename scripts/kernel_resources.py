"""Registers, spills and stack frames of the port's CUDA kernels, as ptxas
reports them for sm_90a, and which Hopper instructions their SASS holds.

    python scripts/kernel_resources.py [i2sdf_tpu_torch/csrc/FILE.cu ...]

Compiles each source (default: every `i2sdf_tpu_torch/csrc/*.cu`) with the
build's flags (`i2sdf_tpu_torch/ops/kernels/build.py`) and `-Xptxas -v`
into a temporary object, all sources in parallel, and prints one JSON line
per kernel entry: the source, the demangled name, registers, spill stores
and loads (bytes), stack frame (bytes), the SASS's count of `HGMMA`
(wgmma), of bulk copies (`UBLKCP`, `cp.async.bulk`; `bulk_ops` by
opcode, whose suffix names the direction) and of special-function-unit
instructions (`MUFU`, by opcode in `mufu_ops`: the exponentials' `EX2`,
reciprocals' `RCP`; static counts, a loop body once) and its highest
register (`max_reg`) from `cuobjdump -sass`, and ptxas's warnings (a
`setmaxnreg` it ignored, wgmma it serialized). Needs `nvcc`, so it runs
on the machine with the card. K2's, K5's, K6's, K7's and K10's rows are
the smoke's `sass` for them, as K4's, K8's and K9's are (K11's are K10's
and K12's K6's: `sdf_grad_fwd.cu` and `sdf_grad_bwd.cu` hold no kernel
of their own, only C entries into `sdf_outputs.cu`'s and `rev_bwd.cu`'s).
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
_SASS_FN = re.compile(r"Function : (\S+)")
_BULK = re.compile(r"\b(UBLKCP\S*)")
_MUFU = re.compile(r"\b(MUFU\.\w+)")
_SASS_REG = re.compile(r"\bR(\d+)\b")
_WARN = re.compile(r"ptxas (?:info|warning)\s*: (.*(?:setmaxnreg|wgmma|"
                   r"serializ|C7508|C7510|C7515).*)")


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
            cur = {"name": m.group(1), "mangled": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := _FRAME.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
    for row, name in zip(rows, demangle([r["name"] for r in rows])):
        row["name"] = name
    return rows


def sass_counts(obj: Path) -> dict:
    """{mangled kernel name: [HGMMA count, UBLKCP count, highest register
    R<n>, {bulk-copy opcode with its direction suffix: count}, {MUFU
    opcode: count}]} of an object."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if m := _SASS_FN.search(line):
            name = m.group(1)
            counts[name] = [0, 0, -1, {}, {}]
        elif name is not None:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "UBLKCP" in line
            for op in _BULK.findall(line):
                counts[name][3][op] = counts[name][3].get(op, 0) + 1
            for op in _MUFU.findall(line):
                counts[name][4][op] = counts[name][4].get(op, 0) + 1
            for r in _SASS_REG.findall(line):
                counts[name][2] = max(counts[name][2], int(r))
    return counts


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
            sass = sass_counts(Path(tmp) / f"{src.stem}.o")
            warnings = _WARN.findall(out)
            for row in report(out):
                hg, bulk, top, ops, mufu = sass.get(
                    row.pop("mangled"), (None, None, None, None, None))
                print(json.dumps({"source": src.name, **row, "hgmma": hg,
                                  "bulk_copies": bulk, "bulk_ops": ops,
                                  "mufu_ops": mufu, "max_reg": top,
                                  "warnings": warnings}),
                      flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

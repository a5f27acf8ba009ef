"""Plant faults in copies of the tree and show that the smoke's K1, K3 and
K4 checks catch each one.

    python scripts/plant_faults.py [FAULT ...]

For each fault (default: all of `FAULTS`), copies the package and
`chip_smoke.py` into a temporary directory, changes one or two lines of
the copy, builds the copy's kernels there and runs, each in its own
process, the checks the fault must fail: `chip_smoke.check_k1`,
`chip_smoke.check_k3` (the flagship config's K3, `k3`, and the light
config's K3-light, `k3_light`; both also on a net of odd depth) and
`chip_smoke.check_k4` (the training config's K4, `k4`). A check that
raises has caught the fault. Prints one JSON line per fault, and exits
nonzero if a check named in the fault's `must_fail` passed. Needs a CUDA
device and `nvcc`; the repository itself is not touched.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (file, old text, new text, the checks that must fail)
FAULTS = {
    # the host's stage images swizzled with the next row's pattern
    "stage_swizzled_one_off": (
        "i2sdf_tpu_torch/ops/kernels/mma_pack.py",
        "return torch.arange(8, device=device)[None, :] ^ (r[:, None] % 8)",
        "return torch.arange(8, device=device)[None, :] ^ ((r[:, None] + 1)"
        " % 8)",
        ("k1", "k3", "k3_light", "k4")),
    # K3 writes the encoding's x tangent into t_y's rows and its y tangent
    # into t_x's, at layer 0 and at the skip (exchanging the two streams at
    # every layer's epilogue instead cancels out after an even number of
    # layers)
    "pe_tangent_axes_swapped": (
        ("i2sdf_tpu_torch/csrc/render_core.cu",
         "  unsigned char* tile = s < 2 ? t0 : t1;\n",
         "  const int d = s == 1 ? 2 : s == 2 ? 1 : s;\n"
         "  unsigned char* tile = d < 2 ? t0 : t1;\n"),
        ("i2sdf_tpu_torch/csrc/render_core.cu",
         "    put1(tile, stream_row(s, p), col0 + q,",
         "    put1(tile, stream_row(d, p), col0 + q,"),
        ("k3", "k3_light")),
    # neither kernel writes the encoding at the skip
    "skip_pe_dropped": (
        ("i2sdf_tpu_torch/csrc/sdf_mlp.cu",
         "    pe_rows(tile, pe, d0, next[kCol], next[kK], kInvSqrt2);\n", ""),
        ("i2sdf_tpu_torch/csrc/render_core.cu",
         "    pe_streams(t0, t1, enc, next[kCol], next[kK], kInvSqrt2);\n",
         ""),
        ("k1", "k3", "k3_light")),
    # K3 exchanges t_x and t_y at every hidden layer's epilogue (over an
    # even number of layers the exchange cancels: the checks' odd-depth
    # nets show it)
    "epilogue_tangents_exchanged": (
        ("i2sdf_tpu_torch/csrc/render_core.cu",
         "      put_pair(t0, r + 8, col, s0 * p0[2], s1 * p0[3]);\n"
         "      put_pair(t1, r, col, s0 * p1[0], s1 * p1[1]);\n",
         "      put_pair(t0, r + 8, col, s0 * p1[0], s1 * p1[1]);\n"
         "      put_pair(t1, r, col, s0 * p0[2], s1 * p0[3]);\n"),
        ("k3", "k3_light")),
    # K4's upward sweep reads back layer l - 1's stash q where it needs
    # layer l's (the ring table's item)
    "k4_stash_one_layer_off": (
        "i2sdf_tpu_torch/ops/kernels/render_core.py",
        "            load(REG_Q, l, tile(fwd[l, 1]))\n",
        "            load(REG_Q, max(l - 1, 0), tile(fwd[l, 1]))\n",
        ("k4",)),
}

CHECK = """
import sys, torch
import chip_smoke as cs
from i2sdf_tpu_torch.ops.kernels import build
build.build()
device = torch.device("cuda", 0)
which = sys.argv[1]
conf = (cs.light_conf(train=False) if which == "k3_light"
        else cs.train_conf() if which == "k4" else cs.eval_conf())
cfg, model = cs.seeded_model(conf, device)
if which == "k1":
    cs.check_k1(model, cfg, cs.k1_points(cfg, conf, device))
elif which == "k4":
    cs.check_k4(model, cfg, conf, device)
else:
    cs.check_k3(model, cfg, conf, device)
"""


def patches(fault):
    spec = FAULTS[fault]
    return [spec[:3]] if isinstance(spec[0], str) else list(spec[:-1])


def copy_tree(name: str, edits: list, tmp: Path) -> Path:
    """The package, `chip_smoke.py` (and links to `configs/`, `data/`)
    copied under tmp/name with each (file, old, new) edit made once."""
    tree = tmp / name
    shutil.copytree(ROOT / "i2sdf_tpu_torch", tree / "i2sdf_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
    for link in ("configs", "data"):
        (tree / link).symlink_to(ROOT / link)
    for rel, old, new in edits:
        path = tree / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {rel} does not hold the text to "
                               f"change exactly once")
        path.write_text(text.replace(old, new))
    return tree


def main(argv: list[str]) -> int:
    faults = argv or list(FAULTS)
    bad = False
    with tempfile.TemporaryDirectory() as tmp:
        for fault in faults:
            tree = copy_tree(fault, patches(fault), Path(tmp))
            caught = {}
            for check in FAULTS[fault][-1]:
                proc = subprocess.run(
                    [sys.executable, "-c", CHECK, check], cwd=tree,
                    capture_output=True, text=True, timeout=900)
                caught[check] = proc.returncode != 0
                last = (proc.stderr.strip().splitlines() or [""])[-1]
                if caught[check] and "AssertionError" not in last:
                    caught[check] = f"error: {last}"
            must = FAULTS[fault][-1]
            ok = all(caught[c] is True for c in must)
            bad = bad or not ok
            print(json.dumps({"fault": fault, "caught": caught,
                              "must_fail": list(must), "ok": ok}),
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

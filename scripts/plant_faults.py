"""Plant faults in copies of the tree and show that the smoke's K1-K12
checks catch each one.

    python scripts/plant_faults.py [--log DIR] [FAULT ...]

For each fault (default: all of `FAULTS`), copies the package and
`chip_smoke.py` into a temporary directory, changes one or two lines of
the copy, builds the copies' kernels, all at once (in this repository's
`build/`, which the copies share: only the sources a fault changes, or
whose headers it changes, compile again), and runs, each in its own
process, the checks the fault must fail: `chip_smoke.check_k1`,
`chip_smoke.check_k3` (the flagship config's K3, `k3`, and the light
config's K3-light, `k3_light`; both also on a net of odd depth) and
`chip_smoke.check_k4` (the training config's K4, `k4`), K3 and K4 with
the idr-mode radiance net at `chip_smoke.idr_conf` (`k3_idr`, `k4_idr`),
K3 and K4 with the light head beside it at `chip_smoke.light_idr_conf`
(`k3_light_idr`; `k4_light_idr` detached, `k4_light_idr_coupled` not),
`chip_smoke.check_bg` (the bg config's K8 and K9, `bg`), the K2 rows of
`chip_smoke.check_kernels` (`k2`: they come before its K3 check),
`chip_smoke.check_rev` (K5 and K6 at the training config, `rev`),
`chip_smoke.check_conv` (K7 at the perray config, `conv`),
`chip_smoke.check_sdf_outputs` (K10 at the flagship config, `k10`),
`chip_smoke.check_sdf_grad` (K11 and K12 at the training config, `k12`;
K11's faults must fail its K11 rows, K12's its K12 rows) and
`chip_smoke.check_mesh` (K1 on the mesh's grids at the training
config's grid boundary, `mesh`). A check that
raises has caught the fault. Prints one JSON line per fault (with the
seconds it took), and exits nonzero if a check named in the fault's
`must_fail` passed; with `--log DIR`, each check's output goes to
DIR/FAULT.CHECK.out (its rows: the gaps the fault opened). Needs a CUDA
device and `nvcc`; the repository's sources are not touched.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
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
        ("i2sdf_tpu_torch/csrc/tangent_form.cuh",
         "  unsigned char* tile = s < 2 ? t0 : t1;\n",
         "  const int d = s == 1 ? 2 : s == 2 ? 1 : s;\n"
         "  unsigned char* tile = d < 2 ? t0 : t1;\n"),
        ("i2sdf_tpu_torch/csrc/tangent_form.cuh",
         "    put1(tile, stream_row(s, p), col0 + q,",
         "    put1(tile, stream_row(d, p), col0 + q,"),
        ("k3", "k3_light", "k10")),
    # neither kernel writes the encoding at the skip
    "skip_pe_dropped": (
        ("i2sdf_tpu_torch/csrc/sdf_mlp.cu",
         "    pe_rows(tile, pe, d0, next[kCol], next[kK], kInvSqrt2);\n", ""),
        ("i2sdf_tpu_torch/csrc/tangent_form.cuh",
         "    pe_streams(t0, t1, enc, next[kCol], next[kK], kInvSqrt2);\n",
         ""),
        ("k1", "k3", "k3_light", "k10")),
    # K3 and K10 exchange t_x and t_y at every hidden layer's epilogue
    # (over an even number of layers the exchange cancels: the checks'
    # odd-depth nets show it)
    "epilogue_tangents_exchanged": (
        ("i2sdf_tpu_torch/csrc/tangent_form.cuh",
         "      put_pair(t0, r + 8, col, s0 * p0[2], s1 * p0[3]);\n"
         "      put_pair(t1, r, col, s0 * p1[0], s1 * p1[1]);\n",
         "      put_pair(t0, r + 8, col, s0 * p1[0], s1 * p1[1]);\n"
         "      put_pair(t1, r, col, s0 * p0[2], s1 * p0[3]);\n"),
        ("k3", "k3_light", "k10")),
    # K4's upward sweep reads back layer l - 1's stash q where it needs
    # layer l's (the ring table's item)
    "k4_stash_one_layer_off": (
        "i2sdf_tpu_torch/ops/kernels/render_core.py",
        "            load(REG_Q, l, tile(fwd[l, 1]))\n",
        "            load(REG_Q, max(l - 1, 0), tile(fwd[l, 1]))\n",
        ("k4",)),
    # K8's output layer packed with its columns in the nets' own order
    # [sigma | features], where the kernel's output epilogue takes
    # [features | sigma]: sigma comes out of the last feature's column
    "bg_features_sigma_swapped": (
        "i2sdf_tpu_torch/ops/kernels/bg_core.py",
        "    perm = render_core._sdf_perm(F)\n    wi[-1], bi[-1] =",
        "    perm = list(range(F + 1))\n    wi[-1], bi[-1] =",
        ("bg",)),
    # K6's downward sweep reads back layer l - 2's stash q where it needs
    # layer l - 1's (K4's ring table, which K6's plan shares)
    "k6_stash_one_layer_off": (
        "i2sdf_tpu_torch/ops/kernels/render_core.py",
        "            load(REG_Q, l - 1, tile(fwd[l - 1, 1]))\n"
        "            load(REG_DZX,",
        "            load(REG_Q, max(l - 2, 0), tile(fwd[l - 1, 1]))\n"
        "            load(REG_DZX,",
        ("rev",)),
    # K6 reads the features' cotangent from c_out's column col, not
    # col + 1 (column 0 is the sdf's)
    "k6_feature_cotangent_column": (
        "i2sdf_tpu_torch/csrc/rev_bwd.cu",
        "(size_t)(row0 + r) * a.out_cols + (col < F ? col + 1 : 0)];",
        "(size_t)(row0 + r) * a.out_cols + (col < F ? col : 0)];",
        ("rev",)),
    # K2's group scan adds warps 1 .. w where warp w's offset is warps
    # 0 .. w - 1 (a group offset taken from the wrong warp)
    "k2_group_offset_wrong_warp": (
        "i2sdf_tpu_torch/csrc/ray_common.cuh",
        "    oa += g.tot[0][v];\n    ob += g.tot[1][v];\n",
        "    oa += g.tot[0][v + 1];\n    ob += g.tot[1][v + 1];\n",
        ("k2",)),
    # K9's implicit backward reads back layer l - 2's stash s where it
    # needs layer l - 1's (the ring table's item)
    "k9_stash_one_layer_off": (
        "i2sdf_tpu_torch/ops/kernels/bg_core.py",
        "            load(REG_Q, l - 1, _chunks(imp[l - 1, 1]) * _CHUNK)\n",
        "            load(REG_Q, max(l - 2, 0), _chunks(imp[l - 1, 1]) * _CHUNK)"
        "\n",
        ("bg",)),
    # K5's reverse sweep drops the skip layer's share of d sdf / d PE
    # (layer 0's alone reaches the gradient; the init's zero encoding rows
    # hide it, the perturbed and odd-depth nets show it)
    "k5_skip_pe_dropped": (
        "i2sdf_tpu_torch/csrc/sdf_sweep.cuh",
        "    [[maybe_unused]] const int e0 = Lt[kCol];\n",
        "    [[maybe_unused]] const int e0 = l > 0 ? (1 << 20) : Lt[kCol];\n",
        ("rev",)),
    # K5 writes its output layer's columns in the kernel's order [features
    # | sdf], not the net's [sdf | features]
    "k5_output_kernel_order": (
        "i2sdf_tpu_torch/csrc/rev_fwd.cu",
        "  const int first = kSdf ? 0 : 1;  // [sdf | features]\n",
        "  const int first = kSdf ? a.F : 0;  // [features | sdf]\n",
        ("rev",)),
    # K10 writes each feature one column to the right in its rows of
    # [sdf | features]
    "k10_features_one_column_off": (
        "i2sdf_tpu_torch/csrc/sdf_outputs.cu",
        "    float* row = stage + p * oc + 1;\n",
        "    float* row = stage + p * oc + 2;\n",
        ("k10",)),
    # K10 takes the bounding sphere where it is above the net's sdf
    "k10_clamp_select_inverted": (
        "i2sdf_tpu_torch/csrc/sdf_outputs.cu",
        "      if (sphere < sdf) {\n",
        "      if (sphere > sdf) {\n",
        ("k10",)),
    # K10's epilogue exchanges the gradient's x and y components (its
    # odd-depth nets, too, must show it)
    "k10_grad_axes_exchanged": (
        "i2sdf_tpu_torch/csrc/sdf_outputs.cu",
        "    float g[3] = {a0[2], a1[0], a1[2]};\n",
        "    float g[3] = {a1[0], a0[2], a1[2]};\n",
        ("k10",)),
    # K11's entry launches K10's kernel with the bounding sphere of radius
    # 1, not 0: the op's outputs come out clamped
    "k11_entry_clamps_to_sphere": (
        "i2sdf_tpu_torch/csrc/sdf_grad_fwd.cu",
        "mx, F, 0.f, 1.f, out,",
        "mx, F, 1.f, 1.f, out,",
        ("k12",)),
    # K11's wrapper hands the kernel a feature width 8 short: the rows of
    # `out` leave the block at the wrong stride
    "k11_out_row_stride": (
        "i2sdf_tpu_torch/ops/kernels/sdf_grad.py",
        "            k.mx, k.F, out.data_ptr(), grad.data_ptr(),\n",
        "            k.mx, k.F - 8, out.data_ptr(), grad.data_ptr(),\n",
        ("k12",)),
    # K12's entry hands K6's kernels a zero cotangent for the features
    "k12_zero_feature_cotangent": (
        "i2sdf_tpu_torch/ops/kernels/sdf_grad.py",
        "                                     kr, x, c_out, c_g)\n",
        "                                     kr, x, torch.cat([c_out[:, :1], "
        "torch.zeros_like(c_out[:, 1:])], 1), c_g)\n",
        ("k12",)),
    # every chunk of a mesh grid but the first built one grid row off (its
    # points' j index one more, wrapping at the axis' end): K1 evaluates
    # the next row's points
    "mesh_chunk_row_offset": (
        "i2sdf_tpu_torch/eval/mesh.py",
        '    j = torch.div(idx % nyz, len(az), rounding_mode="floor")\n',
        '    j = (torch.div(idx % nyz, len(az), rounding_mode="floor")\n'
        '         + (1 if start else 0)) % len(ay)\n',
        ("mesh",)),
    # K3-idr writes the gradient into the radiance input's xyz columns and
    # the xyz into the gradient's (at the init grad ~ x / |x|: the check's
    # perturbed and odd nets, and the eval chunk's far points, show it)
    "k3_idr_pts_grad_swapped": (
        ("i2sdf_tpu_torch/csrc/render_core.cu",
         "    const int c = F + enc.dd + 3;\n",
         "    const int c = F + enc.dd;\n"),
        ("i2sdf_tpu_torch/csrc/render_core.cu",
         "    } else if (kIdr && q < enc.dd + 3) {\n"
         "      v = px[q - enc.dd];\n"
         "    } else if (kIdr && q < enc.dd + 6) {\n"
         "      continue;\n",
         "    } else if (kIdr && q < enc.dd + 3) {\n"
         "      continue;\n"
         "    } else if (kIdr && q < enc.dd + 6) {\n"
         "      v = px[q - enc.dd - 3];\n"),
        ("k3_idr",)),
    # K4-idr leaves the radiance input's gradient-column cotangent out of
    # c_grad: the second-order sweeps see the external cotangent alone
    "k4_idr_grad_cot_dropped": (
        "i2sdf_tpu_torch/csrc/render_core_bwd.cu",
        "      Smem::cot(c)[r * kCot + j] += s;\n",
        "      (void)s;\n",
        ("k4_idr",)),
    # K4-light-idr writes the idr columns [xyz | grad] into T before the
    # light head runs, not after it: the light head's pass over T and the
    # PE(dirs) fill after it leave those columns zero, so the radiance
    # net's forward and its layer 0's weight gradient read no xyz and no
    # gradient (the order that keeps the two apart, inverted)
    "k4_light_idr_cols_before_head": (
        ("i2sdf_tpu_torch/csrc/render_core_bwd.cu",
         "  light_head<kLight, kCoupled>(c, acc);\n\n"
         "  // ---- 2. radiance forward: its inputs stored, rgb to shared "
         "memory ------\n"
         "  fill_T(c, kFillPeDirs, F, a.rad.L[0][kK], 1.f);\n"
         "  if (a.gin != nullptr) {\n",
         "  if (a.gin != nullptr) {\n"),
        ("i2sdf_tpu_torch/csrc/render_core_bwd.cu",
         "      put1(c.T, r, c0 + j, v);\n    }\n  }\n  fence_async();\n"
         "  bar_sync(1, kConsumers);\n",
         "      put1(c.T, r, c0 + j, v);\n    }\n  }\n  fence_async();\n"
         "  bar_sync(1, kConsumers);\n"
         "  light_head<kLight, kCoupled>(c, acc);\n"
         "  fill_T(c, kFillPeDirs, F, a.rad.L[0][kK], 1.f);\n"
         "  fence_async();\n  bar_sync(1, kConsumers);\n"),
        ("k4_light_idr",)),
    # K4-light-idr with `detach_light` off drops idr's gradient-column
    # cotangent (the light's feature cotangent still joins c_feat)
    "k4_light_idr_grad_cot_dropped": (
        "i2sdf_tpu_torch/csrc/render_core_bwd.cu",
        "      Smem::cot(c)[r * kCot + j] += s;\n",
        "      (void)s;\n",
        ("k4_light_idr_coupled",)),
    # K7 takes its first warp's maximum of the bound, not the group's
    "k7_one_warp_max": (
        "i2sdf_tpu_torch/csrc/conv_check.cu",
        "  const float bound = error_bound(q, beta0, g, warp, lane);\n",
        "  const float bound = warp_max(sections_max(q, beta0, g, warp, "
        "lane));\n",
        ("conv",)),
}

CHECK = """
import sys, torch
import chip_smoke as cs
from i2sdf_tpu_torch.ops.kernels import build
build.build()
device = torch.device("cuda", 0)
which = sys.argv[1]
conf = (cs.light_conf(train=False) if which == "k3_light"
        else cs.idr_conf() if which in ("k3_idr", "k4_idr")
        else cs.light_idr_conf(train=False) if "light_idr" in which
        else cs.train_conf() if which in ("k4", "rev", "k12", "mesh")
        else cs.perray_conf(train=False) if which == "conv"
        else cs.bg_conf(train=False) if which == "bg" else cs.eval_conf())
cfg, model = cs.seeded_model(conf, device)
if which == "k1":
    cs.check_k1(model, cfg, cs.k1_points(cfg, conf, device))
elif which == "k2":
    cs.check_kernels(model, cfg, conf, device)
elif which == "rev":
    cs.check_rev(model, cfg, cs.eval_conf(), device)
elif which == "k10":
    cs.check_sdf_outputs(model, cfg, conf, device)
elif which == "k12":
    cs.check_sdf_grad(model, cfg, cs.eval_conf(), device)
elif which == "conv":
    cs.check_conv(model, cfg, conf, device)
elif which == "bg":
    cs.check_bg(model, cfg, conf, device)
elif which in ("k4", "k4_idr", "k4_light_idr"):
    cs.check_k4(model, cfg, conf, device)
elif which == "k4_light_idr_coupled":
    cs.check_k4(model, cfg, conf, device, detach_light=False)
elif which == "mesh":
    cs.check_mesh(model, cfg, conf, device)
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
    (ROOT / "build").mkdir(exist_ok=True)
    for link in ("configs", "data", "build"):
        (tree / link).symlink_to(ROOT / link)
    for rel, old, new in edits:
        path = tree / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {rel} does not hold the text to "
                               f"change exactly once")
        path.write_text(text.replace(old, new))
    return tree


BUILD = "from i2sdf_tpu_torch.ops.kernels import build; build.build()"


def main(argv: list[str]) -> int:
    log = None
    if argv[:1] == ["--log"]:
        log, argv = Path(argv[1]), argv[2:]
        log.mkdir(parents=True, exist_ok=True)
    faults = argv or list(FAULTS)
    bad = False
    with tempfile.TemporaryDirectory() as tmp:
        trees = {f: copy_tree(f, patches(f), Path(tmp)) for f in faults}
        t0 = time.monotonic()
        builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree,
                                   stdout=subprocess.DEVNULL,
                                   stderr=subprocess.DEVNULL)
                  for tree in trees.values()]
        for proc in builds:
            proc.wait(timeout=900)
        print(json.dumps({"built": len(builds),
                          "seconds": round(time.monotonic() - t0)}),
              flush=True)
        for fault, tree in trees.items():
            t0 = time.monotonic()
            caught = {}
            for check in FAULTS[fault][-1]:
                proc = subprocess.run(
                    [sys.executable, "-c", CHECK, check], cwd=tree,
                    capture_output=True, text=True, timeout=900)
                if log is not None:
                    (log / f"{fault}.{check}.out").write_text(
                        proc.stdout + proc.stderr[-3000:])
                caught[check] = proc.returncode != 0
                last = (proc.stderr.strip().splitlines() or [""])[-1]
                if caught[check] and "AssertionError" not in last:
                    caught[check] = f"error: {last}"
            must = FAULTS[fault][-1]
            ok = all(caught[c] is True for c in must)
            bad = bad or not ok
            print(json.dumps({"fault": fault, "caught": caught,
                              "must_fail": list(must), "ok": ok,
                              "seconds": round(time.monotonic() - t0)}),
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

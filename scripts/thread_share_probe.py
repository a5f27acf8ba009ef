"""How torch's CPU thread pools fare when several processes share the
cores, as pytest-xdist's workers do under the suite's `-n 6`.

    JAX_PLATFORMS=cpu python scripts/thread_share_probe.py \\
        [--procs 6] [--threads 8,1]

For each thread count T, starts PROCS processes at once; each builds the
tests' tiny-scene trainer (`test_torch_train_step.write_tiny_scene` as
`test_torch_train_io._tiny_trainer` sets it up, in a temporary folder),
sets torch to T threads and times the trainer's first 2 steps
(`fit(max_steps=2)`: the bubble pdf's init, two steps, a validation
render). Prints one JSON line per T: the processes' seconds, the
wall time of the round and the machine's core count. On the CPU only;
`tests/test_torch_helpers.share_cores_between_workers` is what the
suite does about it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(threads: int, folder: str) -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import torch

    from i2sdf_tpu_torch.config import load_cfg
    from i2sdf_tpu_torch.train.trainer import ReconstructionTrainer
    from test_torch_train_step import write_tiny_scene

    torch.set_num_threads(threads)
    conf = load_cfg(write_tiny_scene(folder))
    conf.loss.min_bubble_iter = 1
    conf.loss.max_bubble_iter = 3
    conf.train.plot_freq = 1000
    tr = ReconstructionTrainer(conf, os.path.join(folder, "exp"),
                               data_root=folder, device="cpu", seed=3)
    t0 = time.perf_counter()
    tr.fit(max_steps=2, log_every=10)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        child(int(argv[1]), argv[2])
        return 0
    procs, threads = 6, [8, 1]
    if "--procs" in argv:
        procs = int(argv[argv.index("--procs") + 1])
    if "--threads" in argv:
        threads = [int(t) for t in
                   argv[argv.index("--threads") + 1].split(",")]
    for t in threads:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            runs = [subprocess.Popen(
                [sys.executable, __file__, "--child", str(t),
                 os.path.join(tmp, str(i))],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
                for i in range(procs)]
            secs = []
            for run in runs:
                out, _ = run.communicate()
                lines = [ln for ln in out.splitlines() if ln.startswith("{")]
                secs.append(json.loads(lines[-1])["seconds"]
                            if run.returncode == 0 and lines else None)
            print(json.dumps({"threads": t, "procs": procs,
                              "seconds": secs,
                              "wall": time.perf_counter() - t0,
                              "cores": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

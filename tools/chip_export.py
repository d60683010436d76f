"""chip_smoke.py's export path alone on one GPU: the build, the `export` fit
job (the flagship's .pt2), the `export` phase (the .pt2 served from a fresh
process, npz, the 160 px ONNX, the op's dispatch cost), a 40-epoch fit of the
flagship and the `benchmark` phase on it. A short card call for a change to
those phases (about 3 min of command time on an H100):

    python3 tools/chip_export.py

The benchmark phase's mAP check needs the script's 150-epoch fit: after 40
epochs the flagship's mAP50-95 is still 0 and the phase fails, as it should.
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_export: no CUDA device", file=sys.stderr)
        return 1
    from edgeyolo_tpu_torch.ops import _build
    from edgeyolo_tpu_torch.ops import linear_attention as la

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t:.3f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_export_") as tmp:
        work = Path(tmp)
        t = time.perf_counter()
        cs.export_job(la, card, work / "export")
        print(f"export job {time.perf_counter() - t:.3f} s", flush=True)
        t = time.perf_counter()
        print(cs.export_phase(la, card, work / "export"))
        print(f"export phase {time.perf_counter() - t:.3f} s", flush=True)
        _, best = cs.fit(la, card, work / "edgeline-yolo", map_min=0.0, epochs=40)
        t = time.perf_counter()
        cs.benchmark_phase(la, card, best, work / "edgeline-yolo" / "fit" / "dataset.yaml",
                           work / "export")
        print(f"benchmark phase {time.perf_counter() - t:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

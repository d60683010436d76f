"""chip_smoke.py's registry phases alone on one GPU: the build, the kernel
cases of the registry graph's paths held against the plain version, then
`registry_reference`, `serve_registry`, `serve_fused` and `embed_check`.
A short card call for a change to those phases (about 70 s of command time
on an H100):

    python3 tools/chip_registry.py
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

REGISTRY_CASES = ((32, 400, 2, 64), (128, 1600, 2, 16), (32, 1600, 2, 16), (4, 1600, 2, 16),
                  (1, 400, 2, 64))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_registry: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, torch.__version__, torch.version.cuda, flush=True)
    from edgeyolo_tpu_torch.ops import _build
    from edgeyolo_tpu_torch.ops import linear_attention as la

    t0 = cs.phase("build")
    _build.build()
    cs.done("build", t0)
    t0 = cs.phase("kernels")
    cs.LA_CASES = [c for c in cs.LA_CASES if c[:4] in REGISTRY_CASES]
    cs.check_kernels(la)
    cs.done("kernels", t0)
    t0 = cs.phase("registry reference")
    cs.registry_reference(la)
    cs.done("registry reference", t0)
    t0 = cs.phase("registry serve")
    cs.serve_registry(la, card)
    cs.serve_fused(la, card)
    cs.done("registry serve", t0)
    t0 = cs.phase("registry embed")
    cs.embed_check(la, card)
    cs.done("registry embed", t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

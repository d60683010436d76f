"""The trainer checkpoint's host copies on the card: one .cpu() per tensor against
host_copies below (one transfer per dtype), alternating, 10 pairs; yolo11n, SGD.

    python3 tools/probe_checkpoint.py [TAG]    # on a CUDA machine; TAG labels the line
"""
import statistics, sys, time
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch
torch.set_num_threads(2)
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.train.trainer import DetectionTrainer


def host_copies(*sds: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
    """Each state dict's tensors copied to the host, each into a tensor of its
    own, in one device-to-host transfer per dtype rather than one (and one
    synchronisation) per tensor."""
    out = [dict.fromkeys(sd) for sd in sds]
    groups: dict[torch.dtype, list[tuple[int, str, torch.Tensor]]] = {}
    for i, sd in enumerate(sds):
        for k, v in sd.items():
            groups.setdefault(v.dtype, []).append((i, k, v.detach()))
    for items in groups.values():
        flat = torch.cat([v.reshape(-1) for _, _, v in items]).cpu()
        for (i, k, v), part in zip(items, flat.split([v.numel() for _, _, v in items])):
            out[i][k] = part.view(v.shape).clone()
    return out


m = DetectionModel("yolo11n.yaml", device="cuda", nc=3)
t = DetectionTrainer(m, {"batch": 16, "nbs": 16, "optimizer": "SGD"}, device="cuda",
                     save_dir=Path("/tmp/probe_ckpt3"))
t.setup(nb=1)
def per_tensor():
    return [{k: v.detach().cpu().clone() for k, v in sd.items()}
            for sd in (t.model.state_dict(), t.ema_state_dict())]
def batched():
    return host_copies(t.model.state_dict(), t.ema_state_dict())
a, b = per_tensor(), batched()
assert all(list(x) == list(y) and all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(a, b))
times = {"per_tensor": [], "batched": []}
for i in range(10):
    order = (("per_tensor", per_tensor), ("batched", batched))
    for name, fn in (order if i % 2 == 0 else order[::-1]):
        torch.cuda.synchronize(); t0 = time.perf_counter(); fn(); torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
tag = sys.argv[1] if len(sys.argv) > 1 else "alone"
print(f"{tag}: " + "; ".join(f"{k} median {statistics.median(v):.2f} ms (min {min(v):.2f}, max {max(v):.2f})"
                             for k, v in times.items()), flush=True)

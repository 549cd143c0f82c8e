"""What tracing the host costs `chip_smoke.profile_device`, on the card.

    python3 tools/torch_profiler_probe.py

A host-bound workload (30 blocks at (1, 4096, 12 x 128): a LayerNorm, a bf16
GEMM, 20 elementwise ops and one flash attention call each, then the
backward) runs unprofiled, then under torch.profiler tracing the card only
and tracing the host's ops too, in turns, 3 rounds. Prints the card's name
and power limit, then one JSON line per round: each mode's wall seconds
(host clock, ending in a sync), the seconds to parse its events, the
device-busy ms and the kernel launches by class (equal in both modes when
the trace is whole), and `chip_smoke.profile_device`'s idle share. Needs a
CUDA card.
"""

import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from finetrainers_tpu_torch.ops import _build, attention_dispatch  # noqa: E402

B, S, N, H, BLOCKS, ELEMENTWISE = 1, 4096, 12, 128, 30, 20


def main():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profiler_probe: no CUDA card visible")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.load_libraries(("flash_fwd_sm90", "flash_bwd_sm90", "flash_bwd"))
    torch.manual_seed(0)
    w = torch.randn(N * H, N * H, device="cuda", dtype=torch.bfloat16) * 0.02
    x0 = torch.randn(B, S, N * H, device="cuda", dtype=torch.bfloat16, requires_grad=True)

    def step():
        x = x0
        for _ in range(BLOCKS):
            h = torch.nn.functional.layer_norm(x, (N * H,))
            q = (h @ w).view(B, S, N, H)
            for _ in range(ELEMENTWISE):
                h = h * 1.0001 + 0.0001
            x = x + attention_dispatch(q, q, q).reshape(B, S, N * H) + h
        x.float().pow(2).mean().backward()
        torch.cuda.synchronize()

    def traced(activities):
        t = time.perf_counter()
        with profile(activities=activities) as prof:
            step()
        wall = time.perf_counter() - t
        t = time.perf_counter()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        counts = {}
        for e in events:
            cls = next((c for c, p in cs._KERNEL_CLASSES if p in e.name.lower()), "other")
            counts[cls] = counts.get(cls, 0) + 1
        return dict(wall_s=wall, parse_s=time.perf_counter() - t, busy_ms=busy, launches=counts)

    step()
    for r in range(3):
        t = time.perf_counter()
        step()
        plain = time.perf_counter() - t
        card = traced([ProfilerActivity.CUDA])
        both = traced([ProfilerActivity.CPU, ProfilerActivity.CUDA])
        print(json.dumps(dict(round=r, unprofiled_s=plain, cuda_only=card, cpu_and_cuda=both,
                              profile_device_idle_share=cs.profile_device(step)["idle_share"])), flush=True)


if __name__ == "__main__":
    main()

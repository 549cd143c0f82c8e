"""Whether `chip_smoke.device_ms`'s torch.profiler traces hold every launch, on the card.

    python3 tools/torch_device_ms_probe.py

Runs `chip_smoke.py`'s kernel checks first (`check_k1` to `check_k1_mask`,
their output discarded: in the whole script, traces came back short after
them), then traces three functions 20 times each, 5 calls a trace: K1's
causal branch at (1, 32, 4096, 4096, 128), K2 with its reduce pass at (1, 24,
256, 256, 128) and K3's segment branch at `chip_smoke.py`'s packed Wan case
(1, 12, 20352, 20352, 128): with no other kernel in the trace, with
`chip_smoke.DEVICE_MS_PAD` small kernels after the calls, and with as many
before them (as `device_ms` has them). Prints the card's name and power
limit, then one JSON line per (function, padding): the launches of each
named kernel that each trace held, their durations in ms, the number of
whole traces and `chip_smoke.device_ms`. Needs a CUDA card.
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402
from finetrainers_tpu_torch.ops.flash_attention import flash_bwd_dkdv, flash_bwd_dq, flash_forward_core  # noqa: E402

CALLS, TRACES = 5, 20


def launches(fn, names, pad):
    """The launches of each of `names` in one trace of CALLS calls of `fn`, with
    `pad` = (where, count) small kernels "before" or "after" them, and the
    durations (ms) of those launches by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    filler = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    where, count = pad
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(count if where == "before" else 0):
            filler.add_(1)
        for _ in range(CALLS):
            fn()
        for _ in range(count if where == "after" else 0):
            filler.add_(1)
        torch.cuda.synchronize()
    events = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]
    return ([sum(n in evt.name for evt in events) for n in names],
            [[round(evt.time_range.elapsed_us() / 1e3, 4) for evt in events if n in evt.name] for n in names])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_device_ms_probe: no CUDA card visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.load_libraries(_build.SOURCES)
    with contextlib.redirect_stdout(io.StringIO()):
        for check in (cs.check_k1, cs.check_k2k3, cs.check_k6, cs.check_k1_wan, cs.check_k5, cs.check_k7,
                      cs.check_k1_mask):
            check(card)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(1, 32, 4096, 128, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    q_s, k_r = cs.flash_qk_prep(q, k, None, None, 0, 128**-0.5)
    q2, k2, v2, do = (torch.randn(1, 24, 256, 128, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    q2_s, k2_r = cs.flash_qk_prep(q2, k2, None, None, 0, 128**-0.5)
    stats = torch.zeros(1, 24, 256, device="cuda")
    wan = cs.BRANCH_CASES[0]
    q3, k3, v3, do3, (_, plain_kw, _) = cs._branch_inputs(wan[0], *wan[2:], g)
    q3, k3, v3, do3 = (x.transpose(1, 2) for x in (q3, k3, v3, do3))
    ids, (cos, sin) = plain_kw["q_seg"], plain_kw["rope"]
    out3, lse3 = cs.flash_forward(q3, k3, v3, None, cos, sin, None, q_seg=ids, kv_seg=ids)
    q3_s, k3_r = cs.flash_qk_prep(q3, k3, cos, sin, 0, 128**-0.5)
    ops3 = (q3_s, k3_r, v3, do3, lse3.contiguous(), (do3.float() * out3.float()).sum(-1), None, cos, sin, 0)
    cases = (("k1_causal", lambda: flash_forward_core(q_s, k_r, v, None, True, None, None), ("flash_fwd_causal",)),
             ("k2_with_reduce", lambda: flash_bwd_dkdv(q2_s, k2_r, v2, do, stats, stats, None, None, None, 0),
              cs.k2_kernels(q2_s, k2_r)),
             ("k3_segment_wan_packed", lambda: flash_bwd_dq(*ops3, 128**-0.5, q_seg=ids, kv_seg=ids),
              cs.K3_KERNELS))
    for name, fn, names in cases:
        for pad in (("none", 0), ("after", cs.DEVICE_MS_PAD), ("before", cs.DEVICE_MS_PAD)):
            traces = [launches(fn, names, pad) for _ in range(TRACES)]
            print(json.dumps(dict(case=name, kernels=names, pad=pad, calls=CALLS,
                                  launches_held=[t[0] for t in traces], ms=[t[1] for t in traces],
                                  whole=sum(all(c == CALLS for c in t[0]) for t in traces), traces=TRACES,
                                  device_ms=cs.device_ms(fn, names), card=card)), flush=True)


if __name__ == "__main__":
    main()

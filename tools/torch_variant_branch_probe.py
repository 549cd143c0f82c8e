"""A quick probe of the flash kernels' branches on the card, for a first call
after a kernel edit: builds every library (`_build.load_libraries`) and writes
each source's ptxas record (registers, spill bytes, warnings), then runs K7c's
causal, segment and mask branches, K7a's and K7b's segment branches and K5's
three branches at small bf16 shapes ((2, 2, 333, 333) and (2, 2, 300, 450),
H 64 and 128, kv_lens, packed ids with -1 padding, `block_sparse_mask`)
through `flash_forward`/`flash_backward` under each switch against the plain
versions (errors, finiteness, rows with no live key, launch counts), then
K5's selects pair by pair (`chip_smoke.branch_pair_errors` over PAIR_CASES).

    python3 tools/torch_variant_branch_probe.py OUT.jsonl

One JSON line per record, to stdout and OUT.jsonl (~1.5 min with the build).
Needs a CUDA card.
"""

import importlib
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402

fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")
SWITCHES = (("FINETRAINERS_FLASH_TWOLEVEL", ("causal", "segment", "mask")),
            ("FINETRAINERS_FLASH_TWOPASS", ("segment",)), ("FINETRAINERS_FLASH_SKEW", ("segment",)),
            ("FINETRAINERS_FLASH_FUSED_BWD", ("causal", "segment", "mask")))


def packed_ids(b, s, run):
    ids = (torch.arange(s, device="cuda") // run).to(torch.int32)[None].repeat(b, 1)
    ids[:, s - 9:] = -1
    return ids


def probe(b, n, sq, skv, h, sw, branch, kw, g):
    q, k, v, do = (torch.randn(b, n, s, h, generator=g, device="cuda").to(torch.bfloat16) for s in (sq, skv, skv, sq))
    lens = torch.tensor([skv - 20, skv], dtype=torch.int32, device="cuda")
    rec = dict(phase="probe", h=h, sq=sq, skv=skv, switch=sw, branch=branch)
    cs._zero_counts()
    cs._zero_branch_counts()
    with cs.switch(sw):
        out, lse = fa.flash_forward(q, k, v, lens, **kw)
        grads = fa.flash_backward(q, k, v, out, lse, do, lens, **kw) if sw.endswith("FUSED_BWD") else None
    torch.cuda.synchronize()
    rec["counts"] = {k_: c for k_, c in {**cs._counts(), **cs._branch_counts()}.items() if c}
    ref, ref_lse = fa.flash_attention_reference(q, k, v, lens, **kw)
    live = fa.live_pairs(b, sq, skv, "cuda", lens, **kw)[:, 0].any(-1)[:, None].expand(b, n, sq)
    err = (out.float() - ref.float()).abs()
    rec.update(finite=bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
               out_err_over_max1=(err / ref.float().abs().clamp_min(1))[live].max().item(),
               out_rel_l2=cs.rel_l2(out[live].float(), ref[live].float()),
               lse_err=(lse - ref_lse).abs()[live].max().item(),
               empty_rows_zero=bool(not out[~live].any()) if (~live).any() else None)
    if grads is not None:
        refs = fa.flash_backward_reference(q, k, v, out, lse, do, lens, **kw)
        rec["bwd"] = {nm: cs.rel_errors(got, want) for nm, got, want in zip(("dq", "dk", "dv"), grads, refs)}
        rec["dq_empty_zero"] = bool(not grads[0][~live].any()) if (~live).any() else None
    return rec


def main():
    out = pathlib.Path(sys.argv[1])
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        def emit(**record):
            line = json.dumps(record)
            print(line, flush=True)
            f.write(line + "\n")

        t0 = time.perf_counter()
        _build.load_libraries(_build.SOURCES)
        for name in _build.SOURCES:
            summary = cs.ptxas_summary(_build.BUILD_LOG[name]["log"])
            emit(phase="build", source=name, seconds=_build.BUILD_LOG[name]["seconds"], **summary)
        g = torch.Generator(device="cuda").manual_seed(1)
        for h in (64, 128):
            for sq, skv in ((333, 333), (300, 450)):
                mask = cs.block_sparse_mask(2, sq, skv, g)
                inputs = {"causal": dict(causal=True), "mask": dict(mask=mask),
                          "segment": dict(q_seg=packed_ids(2, sq, 100), kv_seg=packed_ids(2, skv, 100 if sq == skv
                                                                                           else 150))}
                for sw, branches in SWITCHES:
                    for branch in branches:
                        emit(**probe(2, 2, sq, skv, h, sw, branch, inputs[branch], g))
        pairs = {f"{name}_h{h}": cs.branch_pair_errors(b, n, sq, skv, h, branch, lens, fused=True)
                 for name, b, n, sq, skv, branch, lens in cs.PAIR_CASES for h in (64, 128)}
        emit(phase="k5_pairs", results=pairs, exact=all(not any(w.values()) for w in pairs.values()),
             seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()

"""K1 of this tree against the mma.sync K1 it replaced, on one card in one process.

    python3 tools/torch_k1_ab.py --parent DIR

DIR is an unpacked `git archive` of a tree whose `finetrainers_tpu_torch/csrc`
holds the mma.sync forward: `flash_fwd.cu` with the entry point `flash_fwd`
(variant 0 = the mma.sync K1, which rotates q and k per CTA from fp32 tables).
Both trees' kernels are built from their sources with nvcc, all at once. At each shape of the port's main paths
it runs, in turns (parent, this, this, parent), the parent's forward (its K1
with the tables) and this tree's `flash_forward` (the pre-pass, then the wgmma
K1), and times this tree's K1 alone, the pre-pass alone, the parent's K1 on the
pre-pass's operands (no tables, q scale 1) and torch SDPA (the "native"
provider, without the fused rotation), all as CUDA-event
medians. It checks that the parent's K1 on the pre-pass's operands gives out
and LSE bit-equal to the parent's K1 with tables (the pre-pass computes the
operands that K1 built per CTA), and holds this tree's K1 against the
parent's. Prints the card's name and power limit, then one JSON line per
shape; exits non-zero if a check fails. Needs one CUDA card.
"""

import argparse
import ctypes
import importlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from finetrainers_tpu_torch.ops import _build, attention_dispatch  # noqa: E402

fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

# name: (B, N, Sq, Skv, H, tables, kv_lens) at the main paths' shapes
SHAPES = {
    "ltx_serve_self": (2, 32, 2688, 2688, 64, "ltx", None),
    "ltx_serve_cross": (2, 32, 2688, 128, 64, None, [1, 12]),
    "wan_train_self": (1, 12, 19968, 19968, 128, "wan", None),
    "wan_train_cross": (1, 12, 19968, 512, 128, None, [512]),
    "wan_serve_self": (2, 12, 19968, 19968, 128, "wan", None),
    "wan_serve_cross": (2, 12, 19968, 512, 128, None, [512, 9]),
}


def build_parent(parent: pathlib.Path):
    """Start nvcc on the parent's `flash_fwd.cu`; returns (process, library path)."""
    csrc, lib = parent / "finetrainers_tpu_torch" / "csrc", parent / "_ab_build" / "libflash_fwd.so"
    lib.parent.mkdir(exist_ok=True)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / "flash_fwd.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib


def load_parent(proc, lib):
    _, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the parent's flash_fwd.cu:\n{err}")
    fwd = ctypes.CDLL(str(lib)).flash_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 13 + [ctypes.c_float,
                                                                                          ctypes.c_void_p]
    return fwd


def parent_k1(fwd, q, k, v, lens, cos, sin, rope_sn, qscale):
    """The parent's K1 (variant 0 of its `flash_fwd`) -> (out, lse)."""
    b, n, sq, h = q.shape
    out = fa._btnh_like(q)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), fa._ptr(lens), fa._ptr(cos),
              fa._ptr(sin), b, n, sq, k.shape[2], h, fa._DTYPE_CODES[q.dtype], 0, *q.stride()[:3], *k.stride()[:3],
              *v.stride()[:3], *out.stride()[:3], rope_sn, qscale, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's flash_fwd returned CUDA error {err}")
    return out, lse


def inputs(shape, g):
    b, n, sq, skv, h, tables, lens = shape
    q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
               for s in (sq, skv, skv))
    cos = sin = None
    if tables == "ltx":
        cos, sin = chip_smoke.ltx_tables(n, h)
    elif tables == "wan":
        cos, sin = (t[None].contiguous() for t in chip_smoke.wan_tables())
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, kv_lens, cos, sin


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=pathlib.Path, required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_ab: no CUDA card visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    parent_build = build_parent(args.parent)
    _build.load_libraries(["flash_fwd_sm90", "flash_bwd"])
    parent_fwd = load_parent(*parent_build)

    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for name, shape in SHAPES.items():
        b, n, sq, skv, h, _, lens = shape
        q, k, v, kv_lens, cos, sin = inputs(shape, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        q_s, k_r = fa.flash_qk_prep(q, k, cos, sin, rope_sn, scale)

        def parent_forward():
            return parent_k1(parent_fwd, q, k, v, kv_lens, cos, sin, rope_sn, scale * fa._LOG2E)

        def parent_on_prepass():
            return parent_k1(parent_fwd, q_s, k_r, v, kv_lens, None, None, 0, 1.0)

        def forward():
            return fa.flash_forward(q, k, v, kv_lens, cos, sin)

        old, old_prep, new = parent_forward(), parent_on_prepass(), forward()
        torch.cuda.synchronize()
        step1_bit_equal = torch.equal(old[0], old_prep[0]) and torch.equal(old[1], old_prep[1])
        diff = (new[0].float() - old[0].float()).abs()
        vs_parent = dict(max_abs=diff.max().item(),
                         err_over_max1_ref=(diff / old[0].float().abs().clamp_min(1.0)).max().item(),
                         rel_l2=((new[0].float() - old[0].float()).norm() / old[0].float().norm()).item(),
                         lse_max_abs=(new[1] - old[1]).abs().max().item())
        del old, old_prep, new
        turns = [chip_smoke.cuda_ms(fn) for fn in (parent_forward, forward, forward, parent_forward)]
        kv_eff = sum(lens) if lens else b * skv
        bound_ms, bound_by = chip_smoke.k1_bound(b, n, sq, kv_eff, h)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        record = dict(
            ab=name, shape=[b, n, sq, skv, h], kv_lens=lens, card=card,
            parent_forward_ms=[turns[0], turns[3]], forward_ms=[turns[1], turns[2]],
            k1_ms=chip_smoke.cuda_ms(lambda: fa.flash_forward_core(q_s, k_r, v, kv_lens)),
            prepass_ms=chip_smoke.cuda_ms(lambda: fa.flash_qk_prep(q, k, cos, sin, rope_sn, scale)),
            parent_k1_on_prepass_ms=chip_smoke.cuda_ms(parent_on_prepass),
            sdpa_ms=chip_smoke.cuda_ms(lambda: attention_dispatch(qt, kt, vt, kv_lens=kv_lens, provider="native")),
            bound_ms=bound_ms, bound_by=bound_by, step1_bit_equal=step1_bit_equal, k1_vs_parent=vs_parent)
        record["k1_tflops"] = 4 * n * sq * kv_eff * h / record["k1_ms"] / 1e9
        print(json.dumps(record), flush=True)
        if not (step1_bit_equal and vs_parent["err_over_max1_ref"] <= chip_smoke.K1_TOL
                and vs_parent["lse_max_abs"] <= chip_smoke.LSE_TOL):
            failed.append(name)
        del q, k, v, q_s, k_r, qt, kt, vt
    if failed:
        raise SystemExit(f"torch_k1_ab: checks failed on {failed}")


if __name__ == "__main__":
    main()

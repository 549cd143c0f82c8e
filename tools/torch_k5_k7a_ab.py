"""K5 and K7a of this tree against the mma.sync K5 and K7a they replaced, on one card in one process.

    python3 tools/torch_k5_k7a_ab.py --parent DIR

DIR is an unpacked `git archive` of a tree whose `finetrainers_tpu_torch/csrc`
holds the mma.sync kernels: `flash_bwd.cu` with the entry point
`flash_bwd_fused` (K5) and `flash_fwd.cu` whose `flash_fwd` takes variant 2
(K7a), beside the wgmma K1 in `flash_fwd_sm90.cu` (commit b447af9 or earlier).
Both trees' kernels are built from their sources with nvcc, all at once. At the
shapes of the port's paths (Wan training self- and cross-attention, Wan
serving, LTX training and serving) it runs, on the same pre-pass operands, in
turns (parent, this, this, parent), the parent's K7a and this tree's, then the
same for K5 (each with its zeroed dq accumulator), as CUDA-event medians and
as the device time of each call from torch.profiler (which leaves out the
host's time to issue it). Beside them it times this tree's K1, K2 and K3,
both whole backwards (the pre-pass, then K5 and its dq emit, or K2 and K3) and
torch SDPA's forward and backward (one call each, without the fused rotation)
as yardsticks. It holds this tree's K7a out and LSE, and its dq (after the
emit), dk and dv, against the parent's within `chip_smoke.py`'s tolerances
(K5 adds dq in an order that varies from run to run), and checks that this
tree's K1 gives out and LSE bit-equal to the parent's K1. Prints the card's
name and power limit, then one JSON line per shape; exits non-zero if a check
fails. Needs one CUDA card.
"""

import argparse
import ctypes
import importlib
import json
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import torch_k1_ab  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402

fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

# name: (B, N, Sq, Skv, H, tables, kv_lens)
SHAPES = {
    "wan_train_self": (1, 12, 19968, 19968, 128, "wan", None),
    "wan_train_cross": (1, 12, 19968, 512, 128, None, [512]),
    "wan_serve_self": (2, 12, 19968, 19968, 128, "wan", None),
    "ltx_train_self": (1, 32, 2688, 2688, 64, "ltx", None),
    "ltx_serve_self": (2, 32, 2688, 2688, 64, "ltx", None),
}
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
PARENT_K5 = ("bwd_fused_kernel",)
K5 = ("bwd_fused_sm90_kernel", "dkdv_reduce_kernel")
PARENT_K7A = ("flash_fwd_twopass_kernel",)
K7A = ("flash_fwd_twopass_sm90_kernel",)


def build_parent(parent: pathlib.Path):
    """Start nvcc on the parent's `flash_bwd.cu`, `flash_fwd.cu` and `flash_fwd_sm90.cu`."""
    csrc, out = parent / "finetrainers_tpu_torch" / "csrc", parent / "_ab_build"
    out.mkdir(exist_ok=True)
    builds = {}
    for name in ("flash_bwd", "flash_fwd", "flash_fwd_sm90"):
        lib = out / f"lib{name}.so"
        cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / f"{name}.cu")]
        builds[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    return builds


def load_parent(builds):
    """The parent's K5, K7a (variant 2 of `flash_fwd`) and K1 entry points, once their builds end."""
    libs = {}
    for name, (proc, lib) in builds.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
    fns = {}
    for key, lib, symbol, argtypes in (
            ("k5", "flash_bwd", "flash_bwd_fused", [_PTR] * 12 + [_INT] * 6 + [ctypes.POINTER(_I64), _I64, _PTR]),
            ("fwd", "flash_fwd", "flash_fwd", [_PTR] * 6 + [_INT] * 7 + [_I64] * 12 + [ctypes.c_float, _PTR]),
            ("k1", "flash_fwd_sm90", "flash_fwd_sm90", [_PTR] * 6 + [_INT] * 6 + [ctypes.POINTER(_I64), _PTR])):
        fn = getattr(libs[lib], symbol)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[key] = fn
    return fns


def _check(err, what):
    if err:
        raise RuntimeError(f"the parent's {what} returned CUDA error {err}")


def parent_k7a(fns, q_s, k_r, v, lens):
    """The parent's K7a on the pre-pass's operands (q scale 1), through the same host steps as its wrapper."""
    b, n, sq, h = q_s.shape
    out = fa._btnh_like(q_s)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q_s.device)
    _check(fns["fwd"](q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), fa._ptr(lens),
                      b, n, sq, k_r.shape[2], h, fa._DTYPE_CODES[q_s.dtype], 2, *q_s.stride()[:3], *k_r.stride()[:3],
                      *v.stride()[:3], *out.stride()[:3], 1.0, fa._stream(q_s.device)), "K7a")
    return out, lse


def parent_k5(fns, q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn):
    """The parent's K5 -> (dq_acc, dk, dv), through the same host steps as its wrapper."""
    b, n, sq, h = q_s.shape
    dk, dv = fa._btnh_like(k_r), fa._btnh_like(v)
    dq_acc = torch.zeros((b, n, sq, h), dtype=torch.float32, device=q_s.device)
    _check(fns["k5"](q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     fa._ptr(lens), fa._ptr(cos), fa._ptr(sin), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(), b, n,
                     sq, k_r.shape[2], h, fa._DTYPE_CODES[q_s.dtype], fa._strides(q_s, k_r, v, do, dk, dv), rope_sn,
                     fa._stream(q_s.device)), "K5")
    return dq_acc, dk, dv


def parent_k1(fns, q_s, k_r, v, lens):
    b, n, sq, h = q_s.shape
    out = fa._btnh_like(q_s)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q_s.device)
    _check(fns["k1"](q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), fa._ptr(lens), b,
                     n, sq, k_r.shape[2], h, fa._DTYPE_CODES[q_s.dtype], fa._strides(q_s, k_r, v, out),
                     fa._stream(q_s.device)), "K1")
    return out, lse


def forward_errors(got, ref):
    """K7a's output and LSE against another's, as `chip_smoke.check_k7` holds them."""
    err = (got[0].float() - ref[0].float()).abs()
    return dict(err_over_max1_ref=(err / ref[0].float().abs().clamp_min(1.0)).max().item(),
                rel_l2=((got[0].float() - ref[0].float()).norm() / ref[0].float().norm()).item(),
                lse_max_abs_err=(got[1] - ref[1]).abs().max().item())


def forward_ok(e):
    return (e["err_over_max1_ref"] <= chip_smoke.K1_TOL and e["rel_l2"] <= chip_smoke.K1_REL_L2_TOL
            and e["lse_max_abs_err"] <= chip_smoke.LSE_TOL)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=pathlib.Path, required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k5_k7a_ab: no CUDA card visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    parent_builds = build_parent(args.parent)
    _build.load_libraries(["flash_fwd_sm90", "flash_bwd", "flash_bwd_sm90"])
    fns = load_parent(parent_builds)

    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for name, shape in SHAPES.items():
        b, n, sq, skv, h, _, lens = shape
        q, k, v, kv_lens, cos, sin = torch_k1_ab.inputs(shape, g)
        do = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        q_s, k_r = fa.flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        out, lse = fa.flash_forward_core(q_s, k_r, v, kv_lens)
        delta = (do.float() * out.float()).sum(-1)
        operands = (q_s, k_r, v, do, lse, delta, kv_lens, cos, sin, rope_sn)

        def old_k7a():
            return parent_k7a(fns, q_s, k_r, v, kv_lens)

        def new_k7a():
            return fa._sm90_forward("flash_fwd_twopass_sm90", q_s, k_r, v, kv_lens)

        def old_k5():
            return parent_k5(fns, *operands)

        def new_k5():
            return fa.flash_bwd_fused(*operands)

        def emit(dq_acc):
            return fa.flash_bwd_dq_emit(dq_acc, cos, sin, rope_sn, scale, q.dtype)

        def backward(fused):
            with chip_smoke.switch("FINETRAINERS_FLASH_FUSED_BWD" if fused else None):
                return fa.flash_backward(q, k, v, out, lse, do, kv_lens, cos, sin)

        k1_bit_equal = all(torch.equal(a, c) for a, c in zip(parent_k1(fns, q_s, k_r, v, kv_lens), (out, lse)))
        k7a_errors = forward_errors(new_k7a(), old_k7a())
        (old_dq, old_dk, old_dv), (dq, dk, dv) = old_k5(), new_k5()
        k5_errors = {gname: chip_smoke.rel_errors(new, old)
                     for gname, new, old in (("dq", emit(dq), emit(old_dq)), ("dk", dk, old_dk), ("dv", dv, old_dv))}
        torch.cuda.synchronize()
        del old_dq, old_dk, old_dv, dq, dk, dv
        k7a_turns = [chip_smoke.cuda_ms(fn) for fn in (old_k7a, new_k7a, new_k7a, old_k7a)]
        k5_turns = [chip_smoke.cuda_ms(fn) for fn in (old_k5, new_k5, new_k5, old_k5)]
        device = {key: chip_smoke.device_ms(fn, kernels) for key, fn, kernels in (
            ("parent_k7a", old_k7a, PARENT_K7A), ("k7a", new_k7a, K7A), ("parent_k5", old_k5, PARENT_K5),
            ("k5", new_k5, K5), ("k1", lambda: fa.flash_forward_core(q_s, k_r, v, kv_lens), ("flash_fwd_sm90_kernel",)),
            ("k2", lambda: fa.flash_bwd_dkdv(*operands), chip_smoke.K2_KERNELS),
            ("k3", lambda: fa.flash_bwd_dq(*operands, scale), chip_smoke.K3_KERNELS))}
        mask = None if kv_lens is None else (torch.arange(skv, device="cuda")[None, :]
                                             < kv_lens[:, None])[:, None, None, :]
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = chip_smoke.cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
        del sdpa_out, leaves
        kv_eff = sum(lens) if lens else b * skv
        k1_bound = chip_smoke.k1_bound(b, n, sq, kv_eff, h)
        k5_bound = chip_smoke.k5_bound(b, n, sq, skv, kv_eff, h, cos)
        k7a_ms, k5_ms = min(k7a_turns[1:3]), min(k5_turns[1:3])
        record = dict(
            ab=name, shape=[b, n, sq, skv, h], kv_lens=lens, card=card,
            parent_k7a_ms=[k7a_turns[0], k7a_turns[3]], k7a_ms=k7a_turns[1:3],
            parent_k5_ms=[k5_turns[0], k5_turns[3]], k5_ms=k5_turns[1:3], device_ms=device,
            k1_ms=chip_smoke.cuda_ms(lambda: fa.flash_forward_core(q_s, k_r, v, kv_lens)),
            k2_ms=chip_smoke.cuda_ms(lambda: fa.flash_bwd_dkdv(*operands)),
            k3_ms=chip_smoke.cuda_ms(lambda: fa.flash_bwd_dq(*operands, scale)),
            fused_backward_ms=chip_smoke.cuda_ms(lambda: backward(True)),
            k2k3_backward_ms=chip_smoke.cuda_ms(lambda: backward(False)),
            sdpa_forward_ms=chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
            sdpa_backward_ms=sdpa_bwd_ms, k7a_bound_ms=k1_bound[0], k7a_bound_by=k1_bound[1], k5_bound_ms=k5_bound[0],
            k5_bound_by=k5_bound[1], k7a_tflops_k1_products=4 * n * sq * kv_eff * h / k7a_ms / 1e9,
            k5_tflops=10 * n * sq * kv_eff * h / k5_ms / 1e9, k7a_vs_parent=k7a_errors,
            k5_rel_l2_vs_parent={k_: e[0] for k_, e in k5_errors.items()},
            k5_max_err_over_max_ref_vs_parent={k_: e[1] for k_, e in k5_errors.items()},
            k1_bit_equal_to_parent=k1_bit_equal)
        print(json.dumps(record), flush=True)
        k5_ok = all(e[0] <= chip_smoke.BWD_REL_L2_TOL and e[1] <= chip_smoke.BWD_MAX_RATIO_TOL
                    for e in k5_errors.values())
        if not (forward_ok(k7a_errors) and k5_ok and k1_bit_equal):
            failed.append(name)
        del q, k, v, do, q_s, k_r, out, lse, delta, operands
    if failed:
        raise SystemExit(f"torch_k5_k7a_ab: checks failed on {failed}")


if __name__ == "__main__":
    main()

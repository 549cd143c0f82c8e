"""K2 and K3 of this tree against the mma.sync K2 and K3 they replaced, on one card in one process.

    python3 tools/torch_bwd_ab.py --parent DIR

DIR is an unpacked `git archive` of a tree whose `finetrainers_tpu_torch/csrc`
holds the mma.sync backward: `flash_bwd.cu` with the entry points
`flash_bwd_dkdv` (K2) and `flash_bwd_dq` (K3), and the wgmma K1 in
`flash_fwd_sm90.cu`. Both trees' kernels are built from their sources with
nvcc, all at once. At each backward shape of the port's main paths (LTX and
Wan training, self- and cross-attention) it runs, on the same pre-pass
operands, in turns (parent, this, this, parent), the parent's K2 and this
tree's K2, then the same for K3, and times torch SDPA's backward (dq, dk, dv in
one call, without the fused rotation) as a yardstick, all as CUDA-event
medians, and the device time of each kernel call from torch.profiler (which
leaves out the host's time to issue it). It holds this tree's dq, dk and dv
against the parent's within the backward tolerances of `chip_smoke.py` (the
sums run in another order, so they are not bit-equal), and checks that this tree's K1 gives out and LSE bit-equal
to the parent's K1 (the shared Hopper header moved K1's helpers, not its
arithmetic). Prints the card's name and power limit, then one JSON line per
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
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import torch_k1_ab  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402

fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

# name: (B, N, Sq, Skv, H, tables, kv_lens) at the training paths' backward shapes
SHAPES = {
    "ltx_train_self": (1, 32, 2688, 2688, 64, "ltx", None),
    "ltx_train_cross": (1, 32, 2688, 128, 64, None, [37]),
    "wan_train_self": (1, 12, 19968, 19968, 128, "wan", None),
    "wan_train_cross": (1, 12, 19968, 512, 128, None, [512]),
}
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def build_parent(parent: pathlib.Path):
    """Start nvcc on the parent's `flash_bwd.cu` and `flash_fwd_sm90.cu`; returns {name: (process, library)}."""
    csrc, out = parent / "finetrainers_tpu_torch" / "csrc", parent / "_ab_build"
    out.mkdir(exist_ok=True)
    builds = {}
    for name in ("flash_bwd", "flash_fwd_sm90"):
        lib = out / f"lib{name}.so"
        cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / f"{name}.cu")]
        builds[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    return builds


def load_parent(builds):
    """The parent's K2, K3 and K1 entry points, once their builds end."""
    libs = {}
    for name, (proc, lib) in builds.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
    fns = {}
    for key, lib, symbol, argtypes in (
            ("k2", "flash_bwd", "flash_bwd_dkdv", [_PTR] * 11 + [_INT] * 6 + [ctypes.POINTER(_I64), _I64, _PTR]),
            ("k3", "flash_bwd", "flash_bwd_dq",
             [_PTR] * 10 + [_INT] * 6 + [ctypes.POINTER(_I64), _I64, ctypes.c_float, _PTR]),
            ("k1", "flash_fwd_sm90", "flash_fwd_sm90", [_PTR] * 6 + [_INT] * 6 + [ctypes.POINTER(_I64), _PTR])):
        fn = getattr(libs[lib], symbol)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[key] = fn
    return fns


def _check(err, what):
    if err:
        raise RuntimeError(f"the parent's {what} returned CUDA error {err}")


def parent_k2(fns, q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn):
    """The parent's K2, through the same host steps as the parent's wrapper."""
    b, n, sq, h = q_s.shape
    dk, dv = fa._btnh_like(k_r), fa._btnh_like(v)
    with torch.cuda.device(q_s.device):
        _check(fns["k2"](q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), fa._ptr(lens), fa._ptr(cos), fa._ptr(sin), dk.data_ptr(), dv.data_ptr(), b,
                         n, sq, k_r.shape[2], h, fa._DTYPE_CODES[q_s.dtype], fa._strides(q_s, k_r, v, do, dk, dv),
                         rope_sn, fa._stream(q_s.device)), "K2")
    return dk, dv


def parent_k3(fns, q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn, scale):
    """The parent's K3, through the same host steps as the parent's wrapper."""
    b, n, sq, h = q_s.shape
    dq = fa._btnh_like(q_s)
    with torch.cuda.device(q_s.device):
        _check(fns["k3"](q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), fa._ptr(lens), fa._ptr(cos), fa._ptr(sin), dq.data_ptr(), b, n, sq,
                         k_r.shape[2], h, fa._DTYPE_CODES[q_s.dtype], fa._strides(q_s, k_r, v, do, dq), rope_sn, scale,
                         fa._stream(q_s.device)), "K3")
    return dq


def parent_k1(fns, q_s, k_r, v, lens):
    b, n, sq, h = q_s.shape
    out = fa._btnh_like(q_s)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q_s.device)
    _check(fns["k1"](q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), fa._ptr(lens), b, n,
                     sq, k_r.shape[2], h, fa._DTYPE_CODES[q_s.dtype], fa._strides(q_s, k_r, v, out),
                     torch.cuda.current_stream().cuda_stream), "K1")
    return out, lse


def inputs(shape, g):
    """q, k, v, kv_lens and tables as `torch_k1_ab.inputs` makes them, and dO (a BNSH view of a BTNH buffer)."""
    q, k, v, kv_lens, cos, sin = torch_k1_ab.inputs(shape, g)
    b, n, sq, _, h, _, _ = shape
    do = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
    return q, k, v, do, kv_lens, cos, sin


def within_tolerance(errors):
    return all(e[0] <= chip_smoke.BWD_REL_L2_TOL and e[1] <= chip_smoke.BWD_MAX_RATIO_TOL for e in errors.values())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=pathlib.Path, required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_ab: no CUDA card visible")
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
        q, k, v, do, kv_lens, cos, sin = inputs(shape, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        out, lse = fa.flash_forward(q, k, v, kv_lens, cos, sin)
        delta = (do.float() * out.float()).sum(-1)
        q_s, k_r = fa.flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        operands = (q_s, k_r, v, do, lse, delta, kv_lens, cos, sin, rope_sn)

        def old_k2():
            return parent_k2(fns, *operands)

        def new_k2():
            return fa.flash_bwd_dkdv(*operands)

        def old_k3():
            return parent_k3(fns, *operands, scale)

        def new_k3():
            return fa.flash_bwd_dq(*operands, scale)

        (old_dk, old_dv), (dk, dv), old_dq, dq = old_k2(), new_k2(), old_k3(), new_k3()
        k1_bit_equal = all(torch.equal(a, c) for a, c in zip(parent_k1(fns, q_s, k_r, v, kv_lens),
                                                            fa.flash_forward_core(q_s, k_r, v, kv_lens)))
        torch.cuda.synchronize()
        errors = {gname: chip_smoke.rel_errors(new, old)
                  for gname, new, old in (("dq", dq, old_dq), ("dk", dk, old_dk), ("dv", dv, old_dv))}
        del old_dk, old_dv, dk, dv, old_dq, dq
        k2_turns = [chip_smoke.cuda_ms(fn) for fn in (old_k2, new_k2, new_k2, old_k2)]
        k3_turns = [chip_smoke.cuda_ms(fn) for fn in (old_k3, new_k3, new_k3, old_k3)]
        device = {key: chip_smoke.device_ms(fn, kernels) for key, fn, kernels in (
            ("parent_k2", old_k2, ("bwd_dkdv_kernel",)), ("k2", new_k2, chip_smoke.k2_kernels(q_s, k_r)),
            ("parent_k3", old_k3, ("bwd_dq_kernel",)), ("k3", new_k3, chip_smoke.K3_KERNELS))}
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        mask = None if kv_lens is None else (torch.arange(skv, device="cuda")[None, :]
                                             < kv_lens[:, None])[:, None, None, :]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = chip_smoke.cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
        del sdpa_out, leaves
        kv_eff = sum(lens) if lens else b * skv
        (k2_bound, k2_by), (k3_bound, k3_by) = chip_smoke.bwd_bounds(b, n, sq, skv, kv_eff, h, cos)
        k2_ms, k3_ms = min(k2_turns[1:3]), min(k3_turns[1:3])
        record = dict(
            ab=name, shape=[b, n, sq, skv, h], kv_lens=lens, card=card,
            splits=fa.dkdv_splits(b, n, sq, skv, fa._sm_count(0))[0],
            parent_k2_ms=[k2_turns[0], k2_turns[3]], k2_ms=k2_turns[1:3],
            parent_k3_ms=[k3_turns[0], k3_turns[3]], k3_ms=k3_turns[1:3], sdpa_backward_ms=sdpa_bwd_ms,
            device_ms=device,
            k2_bound_ms=k2_bound, k2_bound_by=k2_by, k3_bound_ms=k3_bound, k3_bound_by=k3_by,
            k2_tflops=8 * n * sq * kv_eff * h / k2_ms / 1e9, k3_tflops=6 * n * sq * kv_eff * h / k3_ms / 1e9,
            rel_l2_vs_parent={k_: e[0] for k_, e in errors.items()},
            max_err_over_max_ref_vs_parent={k_: e[1] for k_, e in errors.items()},
            k1_bit_equal_to_parent=k1_bit_equal)
        print(json.dumps(record), flush=True)
        if not (within_tolerance(errors) and k1_bit_equal):
            failed.append(name)
        del q, k, v, do, q_s, k_r, out, lse, delta, operands
    if failed:
        raise SystemExit(f"torch_bwd_ab: checks failed on {failed}")


if __name__ == "__main__":
    main()

"""K7c and K7b of this tree against the mma.sync K7c and K7b they replaced, on one card in one process.

    python3 tools/torch_k7bc_ab.py --parent DIR

DIR is an unpacked `git archive` of a tree whose `finetrainers_tpu_torch/csrc`
holds the mma.sync kernels: `flash_fwd.cu` whose entry point `flash_fwd` takes
variant 1 (K7c) and variant 3 (K7b), beside the wgmma K1 in `flash_fwd_sm90.cu`
(commit 3c44bbc or earlier, back to 22066e3). Both trees' kernels are built
from their sources with nvcc, all at once. At the shapes of the port's paths
(Wan training and serving self- and cross-attention, LTX's serving shape and a
ragged cross-attention case with an empty row) it runs in turns (parent, this,
this, parent) the parent's K7c and this tree's, on the same pre-pass operands
(self-attention with the path's RoPE tables), then the parent's K7b and this
tree's, on the raw q and k without tables (K7b takes none), as CUDA-event
medians and as the device time of each call from torch.profiler (which leaves
out the host's time to issue it). Beside them it times this tree's K1 on the
same operands (for K7b, on the pre-pass's operands without tables) and torch
SDPA's forward (one call, without the fused rotation) as a yardstick. It holds
this tree's K7c and K7b out and LSE against the parent's within
`chip_smoke.py`'s tolerances, and checks that the kernels this tree does not
redesign give results bit-equal to the parent's on the same inputs: K1 and K7a
(out, LSE), K2 and K3 (dq, dk, dv), K5 (dk, dv; its dq sums run in an order
that varies from run to run) and K6 with the sage pre-pass (out), each called
through its wrapper with the parent's C entry point put in place of this
tree's. Prints the card's name and power limit, then one JSON line per shape;
exits non-zero if a check fails. Needs one CUDA card.
"""

import argparse
import contextlib
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
from finetrainers_tpu_torch.ops import _build, attention_dispatch  # noqa: E402
from torch_k5_k7a_ab import forward_errors, forward_ok, parent_k1  # noqa: E402

fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

# name: (B, N, Sq, Skv, H, tables, kv_lens)
SHAPES = {
    "wan_train_self": (1, 12, 19968, 19968, 128, "wan", None),
    "wan_train_cross": (1, 12, 19968, 512, 128, None, [512]),
    "wan_serve_self": (2, 12, 19968, 19968, 128, "wan", None),
    "wan_serve_cross": (2, 12, 19968, 512, 128, None, [512, 9]),
    "ltx_serve_self": (2, 32, 2688, 2688, 64, "ltx", None),
    "ragged_empty_row": (2, 32, 1000, 77, 64, None, [77, 0]),
}
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
KERNELS = {"parent_k7c": ("flash_fwd_two_level_kernel",), "k7c": ("flash_fwd_two_level_sm90_kernel",),
           "parent_k7b": ("flash_fwd_skew_kernel",), "k7b": ("flash_fwd_skew_sm90_kernel",),
           "k1": ("flash_fwd_sm90_kernel",), "k1_no_tables": ("flash_fwd_sm90_kernel",)}
VARIANT_CODES = {"k7c": 1, "k7b": 3}  # the parent's `flash_fwd` variant codes
# The C entry points of the kernels this tree does not redesign, by source; their signatures are the parent's.
UNCHANGED = {"flash_fwd_sm90": ("flash_fwd_sm90", "flash_fwd_twopass_sm90"),
             "flash_bwd_sm90": ("flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90", "flash_bwd_fused_sm90"),
             "sage_fwd_sm90": ("sage_prep", "sage_fwd_sm90")}


def build_parent(parent: pathlib.Path):
    """Start nvcc on the parent's `flash_fwd.cu` and the sources of UNCHANGED."""
    csrc, out = parent / "finetrainers_tpu_torch" / "csrc", parent / "_ab_build"
    out.mkdir(exist_ok=True)
    builds = {}
    for name in ("flash_fwd", *UNCHANGED):
        lib = out / f"lib{name}.so"
        cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / f"{name}.cu")]
        builds[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    return builds


def load_parent(builds):
    """The parent's `flash_fwd` (K7c and K7b by variant code) and K1 entry points, and its loaded libraries
    ("libs", by source), once their builds end."""
    libs = {}
    for name, (proc, lib) in builds.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
    fns = {}
    for key, lib, symbol, argtypes in (
            ("fwd", "flash_fwd", "flash_fwd", [_PTR] * 6 + [_INT] * 7 + [_I64] * 12 + [ctypes.c_float, _PTR]),
            ("k1", "flash_fwd_sm90", "flash_fwd_sm90", [_PTR] * 6 + [_INT] * 6 + [ctypes.POINTER(_I64), _PTR])):
        fn = getattr(libs[lib], symbol)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[key] = fn
    fns["libs"] = libs
    return fns


@contextlib.contextmanager
def parent_entries(fns):
    """Within the block, the wrappers launch the parent's C entry points of UNCHANGED (typed as this
    tree's, which the wrappers have loaded by then) in place of this tree's."""
    saved = dict(fa._KERNELS)
    for source, names in UNCHANGED.items():
        for name in names:
            fn = getattr(fns["libs"][source], name)
            fn.restype, fn.argtypes = ctypes.c_int, saved[name].argtypes
            fa._KERNELS[name] = fn
    try:
        yield
    finally:
        fa._KERNELS.clear()
        fa._KERNELS.update(saved)


def unchanged_outputs(q, k, v, kv_lens, cos, sin, do):
    """The outputs of the kernels of UNCHANGED on one case, each through its wrapper: K1 and K7a after the
    pre-pass, K2 and K3, K5 (dk and dv), and the sage pre-pass and K6 (without tables)."""
    out, lse = fa.flash_forward(q, k, v, kv_lens, cos, sin)
    with chip_smoke.switch("FINETRAINERS_FLASH_TWOPASS"):
        k7a = fa.flash_forward(q, k, v, kv_lens, cos, sin)
    k2k3 = fa.flash_backward(q, k, v, out, lse, do, kv_lens, cos, sin)
    with chip_smoke.switch("FINETRAINERS_FLASH_FUSED_BWD"):
        k5 = fa.flash_backward(q, k, v, out, lse, do, kv_lens, cos, sin)[1:]
    k6 = attention_dispatch(*(x.transpose(1, 2) for x in (q, k, v)), kv_lens=kv_lens, provider="sage")
    return {"k1": (out, lse), "k7a": k7a, "k2_k3": k2k3, "k5_dk_dv": k5, "k6": (k6,)}


def parent_variant(fns, key, q, k, v, lens, q_scale):
    """The parent's K7c (on the pre-pass's operands, q scale 1) or K7b (on the raw q and k with its q scale),
    through the same host steps as its wrapper."""
    b, n, sq, h = q.shape
    out = fa._btnh_like(q)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    err = fns["fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), fa._ptr(lens), b, n,
                     sq, k.shape[2], h, fa._DTYPE_CODES[q.dtype], VARIANT_CODES[key], *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], q_scale, fa._stream(q.device))
    if err:
        raise RuntimeError(f"the parent's {key} returned CUDA error {err}")
    return out, lse


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=pathlib.Path, required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k7bc_ab: no CUDA card visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    parent_builds = build_parent(args.parent)
    _build.load_libraries(["flash_fwd_sm90", "flash_bwd", "flash_bwd_sm90", "sage_fwd_sm90"])
    fns = load_parent(parent_builds)

    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for name, shape in SHAPES.items():
        b, n, sq, skv, h, _, lens = shape
        q, k, v, kv_lens, cos, sin = torch_k1_ab.inputs(shape, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        q_s, k_r = fa.flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        q_s0 = q_s if cos is None else fa.flash_qk_prep(q, k, None, None, 0, scale)[0]  # K7b's operands for K1
        calls = {
            "parent_k7c": lambda: parent_variant(fns, "k7c", q_s, k_r, v, kv_lens, 1.0),
            "k7c": lambda: fa._sm90_forward("flash_fwd_two_level_sm90", q_s, k_r, v, kv_lens),
            "parent_k7b": lambda: parent_variant(fns, "k7b", q, k, v, kv_lens, scale * fa._LOG2E),
            "k7b": lambda: fa._sm90_forward("flash_fwd_skew_sm90", q, k, v, kv_lens, scale * fa._LOG2E),
            "k1": lambda: fa.flash_forward_core(q_s, k_r, v, kv_lens),
            "k1_no_tables": lambda: fa.flash_forward_core(q_s0, k, v, kv_lens),
        }
        k1_bit_equal = all(torch.equal(x, y) for x, y in zip(parent_k1(fns, q_s, k_r, v, kv_lens), calls["k1"]()))
        do = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
        mine = unchanged_outputs(q, k, v, kv_lens, cos, sin, do)
        with parent_entries(fns):
            theirs = unchanged_outputs(q, k, v, kv_lens, cos, sin, do)
        bit_equal = {key: all(torch.equal(x, y) for x, y in zip(mine[key], theirs[key])) for key in mine}
        del do, mine, theirs
        errors = {key: forward_errors(calls[key](), calls[f"parent_{key}"]()) for key in ("k7c", "k7b")}
        errors.update({f"{key}_vs_k1": forward_errors(calls[key](), calls[ref]())
                       for key, ref in (("k7c", "k1"), ("k7b", "k1_no_tables"))})
        torch.cuda.synchronize()
        turns = {key: [chip_smoke.cuda_ms(calls[fn]) for fn in (f"parent_{key}", key, key, f"parent_{key}")]
                 for key in ("k7c", "k7b")}
        device = {key: chip_smoke.device_ms(calls[key], kernels) for key, kernels in KERNELS.items()}
        mask = None if kv_lens is None else (torch.arange(skv, device="cuda")[None, :]
                                             < kv_lens[:, None])[:, None, None, :]
        kv_eff = sum(lens) if lens else b * skv
        bound_ms, bound_by = chip_smoke.k1_bound(b, n, sq, kv_eff, h)
        record = dict(
            ab=name, shape=[b, n, sq, skv, h], kv_lens=lens, tables=shape[5], card=card,
            parent_k7c_ms=[turns["k7c"][0], turns["k7c"][3]], k7c_ms=turns["k7c"][1:3],
            parent_k7b_ms=[turns["k7b"][0], turns["k7b"][3]], k7b_ms=turns["k7b"][1:3], device_ms=device,
            k1_ms=chip_smoke.cuda_ms(calls["k1"]), k1_no_tables_ms=chip_smoke.cuda_ms(calls["k1_no_tables"]),
            sdpa_forward_ms=chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
            bound_ms=bound_ms, bound_by=bound_by, errors=errors, k1_bit_equal_to_parent=k1_bit_equal,
            unchanged_bit_equal_to_parent=bit_equal)
        record["k7c_device_over_k1"] = (device["k7c"] / device["k1"]) if device["k7c"] and device["k1"] else None
        record["k7b_device_over_k1"] = ((device["k7b"] / device["k1_no_tables"])
                                        if device["k7b"] and device["k1_no_tables"] else None)
        print(json.dumps(record), flush=True)
        if not (all(forward_ok(e) for e in errors.values()) and k1_bit_equal and all(bit_equal.values())):
            failed.append(name)
        del q, k, v, q_s, k_r, q_s0, calls
    if failed:
        raise SystemExit(f"torch_k7bc_ab: checks failed on {failed}")


if __name__ == "__main__":
    main()

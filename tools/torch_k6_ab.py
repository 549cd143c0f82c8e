"""K6 and its pre-pass against the mma.sync K6 and torch pre-pass they replaced, on one card in one process.

    python3 tools/torch_k6_ab.py --parent DIR

DIR is an unpacked `git archive` of a tree whose `finetrainers_tpu_torch/csrc`
holds the mma.sync K6: `sage_fwd.cu` with the entry point `sage_fwd`. Both
trees' kernels are built from their sources with nvcc, all at once. The
parent's host steps are reproduced here as its wrappers took them: the
dispatcher's fp32 torch rotation of q and k (with RoPE tables), the torch
quantization pre-pass (`quantize_per_token`, `smooth_k`) handing over BNSH
views of BTNH-ordered codes and scales, then its K6. At the shapes of the Wan
`sage` serving path (self-attention with Wan's tables, cross-attention over
512 text keys with kv_lens) and at the LTX shape and a ragged case, it runs in
turns (parent, this, this, parent) the parent's pre-pass and this tree's
`sage_prep`, then the parent's K6 and this tree's K6 on their own pre-pass's
codes, and times torch SDPA on the bf16 inputs (no quantization, no rotation)
as a yardstick, all as CUDA-event medians, with the kernels' device times from
torch.profiler (which leave out the host's time to issue them) and the device
memory one call of each path allocates at its peak. It holds this
tree's q codes and scales equal to the parent's, its k codes within one in at
most 0.1% of entries (the smoothed k's mean is summed in another order), and
its output within K6's tolerance of the parent's. Prints the card's name and
power limit, then one JSON line per shape; exits non-zero if a check fails.
Needs one CUDA card.
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
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402
from finetrainers_tpu_torch.ops import attention as attention_ops  # noqa: E402

fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")
sa = importlib.import_module("finetrainers_tpu_torch.ops.sage_attention")

# name: (B, N, Sq, Skv, H, Wan tables, kv_lens)
SHAPES = {
    "wan_serve_self": (2, 12, 19968, 19968, 128, True, None),
    "wan_serve_cross": (2, 12, 19968, 512, 128, False, [512, 9]),
    "ltx_shape": (2, 32, 2688, 2688, 64, False, None),
    "ragged_empty_row": (2, 4, 1000, 77, 128, False, [77, 0]),
}


def build_parent(parent: pathlib.Path):
    """Start nvcc on the parent's `sage_fwd.cu`; returns (process, library path)."""
    csrc, lib = parent / "finetrainers_tpu_torch" / "csrc", parent / "_ab_build" / "libsage_fwd.so"
    lib.parent.mkdir(exist_ok=True)
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / "sage_fwd.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib


def load_parent(proc, lib):
    _, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the parent's sage_fwd.cu:\n{err}")
    fn = ctypes.CDLL(str(lib)).sage_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                                                                ctypes.c_void_p]
    return fn


def parent_prepass(q, k, lens, tables):
    """The parent's torch passes: the dispatcher's rotation, then its pre-pass,
    codes and scales as BNSH views of BTNH-ordered buffers."""
    if tables is not None:
        q, k = (attention_ops._rotate_interleaved_4d(x, *tables) for x in (q, k))
    q_codes, q_scales = sa.quantize_per_token(q)
    k_codes, k_scales = sa.quantize_per_token(sa.smooth_k(k, lens))
    return q_codes.transpose(1, 2), k_codes.transpose(1, 2), q_scales.transpose(1, 2), k_scales.transpose(1, 2)


def parent_k6(fn, q_codes, k_codes, q_scales, k_scales, v, lens):
    """The parent's K6, through the same host steps as the parent's wrapper."""
    b, n, sq, h = q_codes.shape
    out = torch.empty((b, sq, n, h), dtype=v.dtype, device=v.device).transpose(1, 2)
    err = fn(q_codes.data_ptr(), k_codes.data_ptr(), q_scales.data_ptr(), k_scales.data_ptr(), v.data_ptr(),
             out.data_ptr(), lens.data_ptr(), b, n, sq, k_codes.shape[2], h, fa._DTYPE_CODES[v.dtype],
             fa._strides(q_codes, k_codes, q_scales, k_scales, v, out), h**-0.5 * fa._LOG2E,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's sage_fwd returned CUDA error {err}")
    return out


def peak_mb(fn):
    """The device memory one call of `fn` allocates beyond what was allocated
    before it, at its peak, in MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=pathlib.Path, required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k6_ab: no CUDA card visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    parent_build = build_parent(args.parent)
    _build.load_libraries(["sage_fwd_sm90"])
    parent_fn = load_parent(*parent_build)

    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for name, (b, n, sq, skv, h, rope, lens_list) in SHAPES.items():
        q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16) for s in (sq, skv, skv))
        k = k + torch.randn(1, 1, n, h, generator=g, device="cuda").to(torch.bfloat16)
        tables = chip_smoke.wan_tables() if rope else None
        cos, sin = fa.kernel_tables(q, k, *tables) if rope else (None, None)
        lens = torch.tensor(lens_list or [skv] * b, dtype=torch.int32, device="cuda")
        vt = v.transpose(1, 2)

        def old_prep():
            return parent_prepass(q, k, lens, tables)

        def new_prep():
            return sa.sage_prep(q, k, lens, cos, sin)

        old_codes, new_codes = old_prep(), new_prep()

        def old_k6():
            return parent_k6(parent_fn, *old_codes, vt, lens)

        def new_k6():
            return sa.sage_forward(*new_codes, vt, lens)

        old_out, new_out = old_k6(), new_k6()
        torch.cuda.synchronize()
        q_equal = all(torch.equal(x.contiguous(), y) for x, y in ((old_codes[0], new_codes[0]),
                                                                   (old_codes[2], new_codes[2])))
        diff = (old_codes[1].int() - new_codes[1].int()).abs()
        code_share = (diff > 0).float().mean().item()
        rel_l2, _, max_abs = chip_smoke.rel_errors(new_out, old_out)
        norm_err = ((new_out.float() - old_out.float()).abs() / old_out.float().abs().clamp_min(1.0)).max().item()
        del old_out, new_out
        prep_turns = [chip_smoke.cuda_ms(fn) for fn in (old_prep, new_prep, new_prep, old_prep)]
        k6_turns = [chip_smoke.cuda_ms(fn) for fn in (old_k6, new_k6, new_k6, old_k6)]
        device = {key: chip_smoke.device_ms(fn, kernels) for key, fn, kernels in (
            ("parent_k6", old_k6, ("sage_fwd_kernel",)), ("k6", new_k6, ("sage_fwd_sm90_kernel",)),
            ("sage_prep", new_prep, chip_smoke.SAGE_PREP_KERNELS))}
        peak = {"parent": peak_mb(lambda: parent_k6(parent_fn, *parent_prepass(q, k, lens, tables), vt, lens)),
                "this": peak_mb(lambda: sa.sage_forward(*sa.sage_prep(q, k, lens, cos, sin), vt, lens))}
        mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qt, kt = q.transpose(1, 2), k.transpose(1, 2)
        sdpa_ms = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=None if lens_list is None else mask))
        kv_eff = int(lens.sum())
        bound_ms, bound_by = chip_smoke.k6_bound(n, sq, kv_eff, h, b * sq)
        k6_ms = min(k6_turns[1:3])
        record = dict(
            ab=name, shape=[b, n, sq, skv, h], kv_lens=lens_list, rope=rope, card=card,
            parent_prepass_ms=[prep_turns[0], prep_turns[3]], sage_prep_ms=prep_turns[1:3],
            parent_k6_ms=[k6_turns[0], k6_turns[3]], k6_ms=k6_turns[1:3], sdpa_yardstick_ms=sdpa_ms,
            device_ms=device, attention_peak_mb=peak, k6_bound_ms=bound_ms, k6_bound_by=bound_by,
            sage_prep_bound_ms=chip_smoke.prepass_bound(q, k, cos)[0],
            k6_tops_equivalent=4 * n * sq * kv_eff * h / k6_ms / 1e9,
            q_codes_and_scales_equal_to_parent=q_equal, k_codes_differing_from_parent=code_share,
            max_k_code_diff=diff.max().item(), rel_l2_vs_parent=rel_l2, max_abs_err_vs_parent=max_abs,
            err_over_max1_vs_parent=norm_err)
        print(json.dumps(record), flush=True)
        if not (q_equal and diff.max() <= 1 and code_share <= 1e-3 and norm_err <= chip_smoke.K6_TOL
                and rel_l2 <= chip_smoke.K6_REL_L2_TOL):
            failed.append(name)
        del q, k, v, vt, old_codes, new_codes
    if failed:
        raise SystemExit(f"torch_k6_ab: checks failed on {failed}")


if __name__ == "__main__":
    main()

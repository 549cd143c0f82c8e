"""K7c and K7b against variants of themselves, each one edit of this tree's source, on one card in one process.

    python3 tools/torch_k7bc_variants.py

Each variant in K7C_VARIANTS and K7B_VARIANTS is `csrc/flash_fwd_sm90.cu` with
one text edit: a layout the kernel could take instead (K7c's P V in two
64-column halves at H=128, three consumer warpgroups at H=64; K7b's 128-key
score tiles, three consumers at H=64) or, marked as a probe, a piece of the
work dropped to show where the time goes (K7c's separate product and its fold:
its P V accumulated into acc as K1's is). Probes give wrong results and are
timed only. All are built with nvcc at once; the script prints each K7c and K7b
instantiation's ptxas registers and spill bytes and ptxas' notes on wgmma (a
serialization for want of registers shows there), then the CUDA-event median
of each variant's entry point (`flash_fwd_two_level_sm90` on the pre-pass's
operands, `flash_fwd_skew_sm90` on the raw q and k) at Wan's training self-
and cross-attention shapes, LTX's serving shape and a ragged cross-attention
case with an empty row, in turns (the variants in order, then reversed),
beside this tree's K1 on the same operands, with the card's name and power
limit. Needs one CUDA card.
"""

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
from finetrainers_tpu_torch.ops import _build  # noqa: E402

fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

# K7c's issue of tile t+1's QK^T and tile t's P V, and the same with the P V in two 64-column halves at
# H=128 (32 floats of pv a thread): the first half, then the QK^T, then the first half folded into acc
# while the scores are computed, then the second half, which runs during tile t+1's step.
_K7C_ISSUE = """  if constexpr (!LAST) mbar_wait(k_full, ((t + 1) / kStages) & 1);
  wgmma_fence();
  if constexpr (!LAST) {
    issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, k_tile);
    wgmma_commit();
  }
  mbar_wait(v_full, (t / kStages) & 1);
  issue_rs<T, HD, kBlockN, kHalfBytes>(pv, pa, v_tile, true);
  wgmma_commit();
"""
_K7C_HALVES = """  if constexpr (HD == 128) {
    mbar_wait(v_full, (t / kStages) & 1);
    wgmma_fence();
    issue_rs<T, 64, kBlockN, kHalfBytes>(pv, pa, v_tile, true);
    wgmma_commit();
    if constexpr (!LAST) {
      mbar_wait(k_full, ((t + 1) / kStages) & 1);
      issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, k_tile);
      wgmma_commit();
      wgmma_wait_one();
    } else {
      wgmma_wait_all();
    }
    fence_regs<32>(pv);
    two_level_fold<32>(o, pv, alpha, beta);
    wgmma_fence();
    issue_rs<T, 64, kBlockN, kHalfBytes>(pv, pa, v_tile + kHalfBytes, true);
    wgmma_commit();
  } else {
""" + _K7C_ISSUE + "  }\n"
_K7C_FOLD = ("  fence_regs<HD / 2>(pv);\n  fence_regs<kBlockN / 16>(pa);\n  __syncwarp();\n"
             "  if (lane == 0) mbar_arrive(v_empty);\n  two_level_fold<HD / 2>(o, pv, alpha, beta);\n")
_PV_ZERO = ("#pragma unroll\n    for (int i = 0; i < kOut; ++i) pv[i] = 0.f;  // overwritten by each product's first "
            "k-step\n")

# name: [(old, new), ...], applied to csrc/flash_fwd_sm90.cu
K7C_VARIANTS = {
    "this tree": [],
    "P V in two 64-column halves (H=128)": [
        (_K7C_ISSUE, _K7C_HALVES),
        (_K7C_FOLD, _K7C_FOLD.replace("fence_regs<HD / 2>(pv)", "fence_regs<HD == 128 ? 32 : HD / 2>(pv)").replace(
            "two_level_fold<HD / 2>(o, pv", "two_level_fold<HD == 128 ? 32 : HD / 2>(o + (HD == 128 ? 32 : 0), pv"))],
    "three consumers at 160 registers (H=64)": [("  if (V == kTwoLevel) return 2;",
                                                  "  if (V == kTwoLevel) return HD == 64 ? 3 : 2;")],
    "probe: P V into acc, no pv and no fold (K1's loop with the two-level step)": [
        ("  issue_rs<T, HD, kBlockN, kHalfBytes>(pv, pa, v_tile, true);\n",
         "  issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, v_tile);\n"),
        (_K7C_FOLD, _K7C_FOLD.replace("fence_regs<HD / 2>(pv)", "fence_regs<HD / 2>(o)").replace(
            "  two_level_fold<HD / 2>(o, pv, alpha, beta);\n", "")),
        (_PV_ZERO, "")],
}

# K7b's step and its consumer's loop with tile u-1's P V left in flight into step u: step u issues tile u's
# QK^T, then waits for tile u-1's scores and the P V, so the tensor cores never idle between them.
_SKEW_STEP_END = """  wgmma_wait_all();  // tile u's scores and tile u-1's P V have landed
  if constexpr (!LAST) fence_regs<kSub / 2>(cur);
  fence_regs<HD / 2>(o);
  fence_regs<kSub / 16>(pa);
  __syncwarp();
  if (lane == 0) {
    if (!LAST && ring.last_in_stage(u)) mbar_arrive(ring.k_empty(u));
    if (ring.last_in_stage(w)) mbar_arrive(ring.v_empty(w));
  }
}"""
_SKEW_STEP_START = """    wgmma_commit();
  }
  float alpha[2], rowsum[2];"""
_SKEW_STEP_START_IN_FLIGHT = """    wgmma_commit();
    wgmma_wait_one();  // tile u-1's scores and tile u-2's P V have landed
  } else {
    wgmma_wait_all();
  }
  fence_regs<kSub / 2>(prev);
  fence_regs<HD / 2>(o);
  fence_regs<kSub / 16>(pa);
  __syncwarp();
  if (lane == 0) {
    if (ring.last_in_stage(w)) mbar_arrive(ring.k_empty(w));
    if (w > 0 && ring.last_in_stage(w - 1)) mbar_arrive(ring.v_empty(w - 1));
  }
  float alpha[2], rowsum[2];"""
_SKEW_PROLOGUE = """    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kSub / 2>(sa);
    __syncwarp();
    if (lane == 0 && ring.last_in_stage(0)) mbar_arrive(ring.k_empty(0));
    int u = 1;"""
_SKEW_TAIL = """      skew_step<T, HD, true>(sb, sa, pa, o, m, l, ring, q_addr, u, kv_len, lane);
    }
  }"""
_SKEW_IN_FLIGHT = [
    (_SKEW_STEP_END, "}"), (_SKEW_STEP_START, _SKEW_STEP_START_IN_FLIGHT),
    (_SKEW_PROLOGUE, "    wgmma_commit();\n    int u = 1;"),
    (_SKEW_TAIL, _SKEW_TAIL[:-4] + """
    wgmma_wait_all();
    fence_regs<HD / 2>(o);
    fence_regs<kSub / 16>(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.v_empty(num_sub - 1));
  }""")]
_SKEW_WGS = "  if (V == kSkew) return 2;"
_SKEW_KEYS = "constexpr int kSkewKeys = 64;"

# name: [(old, new), ...], applied to csrc/flash_fwd_sm90.cu
K7B_VARIANTS = {
    "this tree": [],
    "128-key score tiles": [(_SKEW_KEYS, "constexpr int kSkewKeys = kBlockN;")],
    "three consumers at 160 registers (H=64)": [(_SKEW_WGS, "  if (V == kSkew) return HD == 64 ? 3 : 2;")],
    "P V left in flight into the next step": _SKEW_IN_FLIGHT,
}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = [_PTR] * 6 + [_INT] * 6 + [ctypes.POINTER(ctypes.c_int64)]

# name: (B, N, Sq, Skv, H, tables, kv_lens)
SHAPES = {
    "wan_train_self": dict(b=1, n=12, sq=19968, skv=19968, h=128, lens=None, rope="wan"),
    "wan_train_cross": dict(b=1, n=12, sq=19968, skv=512, h=128, lens=[512], rope=None),
    "ltx_serve_self": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
    "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[77, 0], rope=None),
}


def edited(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"torch_k7bc_variants: an edit no longer matches the source:\n{old}")
        source = source.replace(old, new)
    return source


def build(out: pathlib.Path, variants, tag: str):
    """Start one nvcc per variant; returns {name: (process, library)}."""
    src = (_build.CSRC_DIR / "flash_fwd_sm90.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        cu = out / f"{tag}{i}.cu"
        cu.write_text(edited(src, edits))
        lib = out / f"lib{tag}{i}.so"
        cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    return procs


def load(procs, entry: str, argtypes, kernel: str):
    """Each variant's entry point once built, and its `kernel` instantiations' registers and spill bytes."""
    fns = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{err[-3000:]}")
        ptxas = {k: [v.get("registers"), v.get("spill_stores"), v.get("spill_loads")]
                 for k, v in chip_smoke.ptxas_summary(err)["ptxas"].items() if k.startswith(kernel)}
        notes = sorted({line.split(": ", 1)[-1][:160] for line in err.splitlines() if "wgmma" in line.lower()})
        print(json.dumps({"variant": name, "registers_spill_stores_loads": ptxas, "wgmma_notes": notes}), flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[name] = fn
    return fns


def turns(fns, run):
    """CUDA-event medians of each variant, in order and then reversed."""
    times = {}
    for name in list(fns) + list(reversed(list(fns))):
        times.setdefault(name, []).append(chip_smoke.cuda_ms(lambda: run(fns[name]), iters=10))
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k7bc_variants: no CUDA card visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = ROOT / "finetrainers_tpu_torch" / "_build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    k7c_procs = build(out, K7C_VARIANTS, "k7c_")
    k7b_procs = build(out, K7B_VARIANTS, "k7b_")
    k7c = load(k7c_procs, "flash_fwd_two_level_sm90", _ARGS + [_PTR], "flash_fwd_two_level_sm90_kernel")
    k7b = load(k7b_procs, "flash_fwd_skew_sm90", _ARGS + [ctypes.c_float, _PTR], "flash_fwd_skew_sm90_kernel")

    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, c in SHAPES.items():
        q, k, v, _, kv_lens, cos, sin = chip_smoke._bwd_case_inputs(c, g)
        scale = c["h"]**-0.5
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else c["sq"] * c["h"]
        q_s, k_r = fa.flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        b, n, sq, h = q.shape
        o = fa._btnh_like(q)
        lse = torch.empty((b, n, sq), dtype=torch.float32, device="cuda")
        stream = fa._stream(q.device)

        def run_k7c(fn):
            err = fn(q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), fa._ptr(kv_lens), b,
                     n, sq, k_r.shape[2], h, 0, fa._strides(q_s, k_r, v, o), stream)
            assert err == 0, err

        def run_k7b(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), fa._ptr(kv_lens), b, n,
                     sq, k.shape[2], h, 0, fa._strides(q, k, v, o), scale * fa._LOG2E, stream)
            assert err == 0, err

        record = dict(shape=shape, dims=[b, n, sq, k.shape[2], h], kv_lens=c["lens"], card=card,
                      k7c_ms=turns(k7c, run_k7c), k7b_ms=turns(k7b, run_k7b),
                      k1_ms=chip_smoke.cuda_ms(lambda: fa.flash_forward_core(q_s, k_r, v, kv_lens), iters=10))
        print(json.dumps(record), flush=True)
        del q, k, v, q_s, k_r, o, lse


if __name__ == "__main__":
    main()

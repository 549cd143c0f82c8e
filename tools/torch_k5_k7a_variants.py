"""K5 and K7a against variants of themselves, each one edit of this tree's source, on one card in one process.

    python3 tools/torch_k5_k7a_variants.py

Each variant in K5_VARIANTS and K7A_VARIANTS is `csrc/flash_bwd_sm90.cu` or
`csrc/flash_fwd_sm90.cu` with one text edit: a design choice of the kernel
undone (the dq reduce issued in its own tile, every tile masked, the mask
branch in every step, pass A through two ring slots) or, marked as a probe, a
piece of the work dropped to show where the time goes (the dq product, the
reduces, the barrier, one of K7a's passes). Probes give wrong results and are
timed only. All are built with nvcc at once; the script prints each K5 and K7a
instantiation's ptxas spill bytes, then the CUDA-event median of each
variant's entry point (`flash_bwd_fused_sm90`, `flash_fwd_twopass_sm90`) at
Wan's training shape and at LTX's training (K5) or serving (K7a) shape, in
turns (the variants in order, then reversed), with the card's name and power
limit. Needs one CUDA card.
"""

import ctypes
import importlib
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402

fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

_DQ_PRODUCT = "    Wgmma<T>::ss64_mn(dq, dq_a + mnmajor_step(kk), dq_b + mnmajor_step(kk), kk);\n"
_STAGING = ("      st_shared(slice + (lane / 4 + 8 * r) * 128 + (j / 4) * 8192 + ((chunk ^ (lane / 4)) << 4) + "
            "8 * (lane & 1),\n                dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);\n")
_REDUCES = ("    tma_reduce_add(dq_map, slice, dq_col0, q0 + 16 * warp, n, b);\n"
            "    tma_reduce_add(dq_map, slice + 8192, dq_col0 + 32, q0 + 16 * warp, n, b);\n")
_DEFERRED = "  if (i > 0) reduce_dq_rows<HD>(dq_map, slice, cwg, q0 - kBq, p);  // the previous tile's dq rows\n"
_AFTER_LOOP = ("  if (num_tiles > 0)  // the last tile's dq rows\n"
               "    reduce_dq_rows<HD>(dq_map, base + L::kDqStage + cwg * L::kDqStageBytes + 16 * warp * 128, cwg,\n"
               "                       (t0 + num_tiles - 1) * kBq, p);\n")
_TILE_END = "                dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);\n    }\n  }\n}\n"
_UNMASKED_IF = "    if (HD == 64 && rows_all_valid && q0 + kBq <= p.seq_q) {\n"

# name: [(old, new), ...], applied to csrc/flash_bwd_sm90.cu
K5_VARIANTS = {
    "this tree": [],
    "dq reduce issued in its own tile": [(_DEFERRED, ""), (_AFTER_LOOP, ""),
                                         (_TILE_END, _TILE_END[:-2] + "  reduce_dq_rows<HD>(dq_map, slice, cwg, q0, p);\n}\n")],
    "every tile masked": [(_UNMASKED_IF, "    if (false) {\n")],
    "unmasked full tiles at H=128 too": [(_UNMASKED_IF, "    if (rows_all_valid && q0 + kBq <= p.seq_q) {\n")],
    "probe: no dq product, staging or reduce": [(_DQ_PRODUCT, "    ;\n"), (_STAGING, ""), (_REDUCES, "")],
    "probe: no staging or reduce": [(_STAGING, ""), (_REDUCES, "")],
    "probe: no reduce": [(_REDUCES, "")],
    "probe: no barrier at H=128": [("    named_barrier_sync(1, 256);\n", "")],
}

_MAX_MASK = "  if constexpr (LAST) {\n#pragma unroll\n    for (int i = 0; i < 64; ++i) {\n      if (t * kBlockN"
_EXP_MASK = "  if constexpr (LAST) {\n#pragma unroll\n    for (int i = 0; i < 64; ++i) {\n      if (k0 + 8"
_PASS_A_LOADS = "__device__ __forceinline__ int pass_a_loads(int slot, int num_tiles) { return (num_tiles - slot + kSlots - 1) / kSlots; }"
_PRODUCE_A = "  for (int t = 0; t < num_tiles; ++t) load(k_map, t % kSlots, t / kSlots, t);"
_PRODUCE_B = "  for (int t = 0; t < num_tiles; ++t) {\n    const int k_slot = t % kStages, v_slot = kStages + t % kStages;"

# name: [(old, new), ...], applied to csrc/flash_fwd_sm90.cu
K7A_VARIANTS = {
    "this tree": [],
    "mask branch in every step": [
        (_MAX_MASK, "  if (t * kBlockN + kBlockN > kv_len) {\n#pragma unroll\n    for (int i = 0; i < 64; ++i) {\n      if (t * kBlockN"),
        (_EXP_MASK, "  if (k0 + kBlockN > kv_len) {\n#pragma unroll\n    for (int i = 0; i < 64; ++i) {\n      if (k0 + 8")],
    "pass A through two ring slots": [
        (_PRODUCE_A, "  for (int t = 0; t < num_tiles; ++t) load(k_map, t % kStages, t / kStages, t);"),
        (_PASS_A_LOADS, "__device__ __forceinline__ int pass_a_loads(int slot, int num_tiles) { "
                        "return slot < kStages ? (num_tiles - slot + kStages - 1) / kStages : 0; }"),
        ("    const int slot = (t + 1) % kSlots;\n    mbar_wait(q_full + 8 * (1 + slot), ((t + 1) / kSlots) & 1);",
         "    const int slot = (t + 1) % kStages;\n    mbar_wait(q_full + 8 * (1 + slot), ((t + 1) / kStages) & 1);"),
        ("  twopass_release(q_full + 8 * (1 + kSlots + t % kSlots), lane);",
         "  twopass_release(q_full + 8 * (1 + kSlots + t % kStages), lane);")],
    "probe: pass A only": [(_PRODUCE_B, _PRODUCE_B.replace("t < num_tiles", "t < 0", 1)),
                           ("  if (num_tiles > 0) {  // pass B", "  if (num_tiles < 0) {  // pass B")],
    "probe: pass B only (m = 0)": [
        (_PRODUCE_A, _PRODUCE_A.replace("t < num_tiles", "t < 0", 1)),
        ("  if (num_tiles > 0) {  // pass A", "  m[0] = m[1] = 0.f;\n  if (num_tiles < 0) {  // pass A"),
        (_PASS_A_LOADS, "__device__ __forceinline__ int pass_a_loads(int slot, int num_tiles) { return 0; }")],
}

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def edited(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"torch_k5_k7a_variants: an edit no longer matches the source:\n{old}")
        source = source.replace(old, new)
    return source


def build(out: pathlib.Path, source: str, variants, tag: str):
    """Start one nvcc per variant; returns {name: (process, library)}."""
    src = (_build.CSRC_DIR / source).read_text()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        cu = out / f"{tag}{i}.cu"
        cu.write_text(edited(src, edits))
        lib = out / f"lib{tag}{i}.so"
        cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    return procs


def load(procs, entry: str, argtypes, kernel: str):
    """Each variant's entry point once built, and its `kernel` instantiations' spill bytes."""
    fns = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{err[-3000:]}")
        spills = {k: [v.get("spill_stores"), v.get("spill_loads")]
                  for k, v in chip_smoke.ptxas_summary(err)["ptxas"].items() if k.startswith(kernel)}
        print(json.dumps({"variant": name, "spill_bytes": spills}), flush=True)
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
        raise SystemExit("torch_k5_k7a_variants: no CUDA card visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = ROOT / "finetrainers_tpu_torch" / "_build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    k5_procs = build(out, "flash_bwd_sm90.cu", K5_VARIANTS, "k5_")
    k7a_procs = build(out, "flash_fwd_sm90.cu", K7A_VARIANTS, "k7a_")
    k5 = load(k5_procs, "flash_bwd_fused_sm90",
              [_PTR] * 13 + [_INT] * 6 + [ctypes.POINTER(_I64), _I64, _INT, _INT, _PTR], "bwd_fused_sm90_kernel")
    k7a = load(k7a_procs, "flash_fwd_twopass_sm90", [_PTR] * 6 + [_INT] * 6 + [ctypes.POINTER(_I64), _PTR],
               "flash_fwd_twopass_sm90_kernel")

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = {"wan_train": dict(b=1, n=12, sq=19968, skv=19968, h=128, lens=None, rope="wan"),
              "ltx_train": dict(b=1, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
              "ltx_serve": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx")}
    for shape, c in shapes.items():
        q, k, v, do, kv_lens, cos, sin = chip_smoke._bwd_case_inputs(c, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else c["sq"] * c["h"]
        q_s, k_r = fa.flash_qk_prep(q, k, cos, sin, rope_sn, c["h"]**-0.5)
        b, n, sq, h = q_s.shape
        record = dict(shape=shape, dims=[b, n, sq, k_r.shape[2], h], card=card)
        if shape != "ltx_serve":  # K5: the training shapes, with one zeroed dq accumulator per call
            out_, lse = fa.flash_forward_core(q_s, k_r, v, kv_lens)
            delta = (do.float() * out_.float()).sum(-1)
            dk, dv = fa._btnh_like(k_r), fa._btnh_like(v)
            dq_acc = torch.empty((b, n, sq, h), dtype=torch.float32, device="cuda")

            def run_k5(fn):
                dq_acc.zero_()
                err = fn(q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), None, fa._ptr(cos), fa._ptr(sin), dk.data_ptr(), dv.data_ptr(), None,
                         dq_acc.data_ptr(), b, n, sq, k_r.shape[2], h, 0, fa._strides(q_s, k_r, v, do, dk, dv),
                         rope_sn, 1, 1 << 20, fa._stream(q_s.device))
                assert err == 0, err

            record["k5_ms_with_dq_zeroing"] = turns(k5, run_k5)
        if shape != "ltx_train":  # K7a: Wan's training shape and LTX's serving shape

            def run_k7a(fn):
                o = fa._btnh_like(q_s)
                lse_ = torch.empty((b, n, sq), dtype=torch.float32, device="cuda")
                err = fn(q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), o.data_ptr(), lse_.data_ptr(), None, b, n, sq,
                         k_r.shape[2], h, 0, fa._strides(q_s, k_r, v, o), fa._stream(q_s.device))
                assert err == 0, err

            record["k7a_ms"] = turns(k7a, run_k7a)
            record["k1_ms"] = chip_smoke.cuda_ms(lambda: fa.flash_forward_core(q_s, k_r, v, kv_lens), iters=10)
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()

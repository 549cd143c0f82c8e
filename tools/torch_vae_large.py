"""The generic VAE at 81x480x832 on the card: which single ops work past 2^31
elements, and the encode and decode whole against split
(`finetrainers_tpu_torch/models/autoencoders.py`, `SPLIT_ELEMENTS`).

    python3 tools/torch_vae_large.py

Prints the card's name and power limit, then one JSON line per probe: each op
of the VAE's full-resolution stage at its real size (96-channel bf16 conv3d,
fp32 GroupNorm over 81 frames, the causal pad and cat, the decoder's nearest
upsampling, SiLU and the residual add), with its seconds and peak memory; then
the Wan config's VAE (random weights from a seed, bf16) decoding 21x60x104
latents and encoding an 81x480x832 video, each split and whole, with seconds,
the peak memory above the inputs and whether the two passes are bit-equal.
Needs a CUDA card.
"""

import json
import subprocess
import sys
import time
import traceback

import torch
import torch.nn.functional as F

sys.path.insert(0, ".")
from finetrainers_tpu_torch.models import autoencoders as ae  # noqa: E402
from finetrainers_tpu_torch.models.layers import init_parameters_  # noqa: E402

T, H, W = 81, 480, 832


def run(name, fn):
    """Time `fn` to a sync and print its record (or its error) with the peak memory it allocated."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        extra = fn() or {}
        torch.cuda.synchronize()
        rec = dict(ok=True, seconds=time.perf_counter() - t0,
                   peak_over_inputs_gb=(torch.cuda.max_memory_allocated() - base) / 1e9, **extra)
    except Exception as e:  # noqa: BLE001 - the probe reports what fails
        rec = dict(ok=False, error=f"{type(e).__name__}: {str(e)[:300]}", where=traceback.format_exc()[-300:])
    print(json.dumps({"probe": name, **rec}), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_vae_large: no CUDA card visible")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=dev, dtype=dtype, generator=g)

    def conv(cin, cout):
        x, w = rand(1, cin, T + 2, H + 2, W + 2), rand(cout, cin, 3, 3, 3) * 0.03
        y = F.conv3d(x, w)
        # Rows 200-207 against the same conv on their own input rows.
        strip = F.conv3d(x[:, :, :, 200:210], w)
        return dict(numel_in=x.numel(), numel_out=y.numel(), rows_equal_alone=bool(torch.equal(y[:, :, :, 200:208], strip)))

    def group_norm():
        x = rand(T, 96, H, W, dtype=torch.float32)
        y = F.group_norm(x, 32, torch.ones(96, device=dev), torch.zeros(96, device=dev), 1e-6)
        alone = F.group_norm(x[-1:], 32, torch.ones(96, device=dev), torch.zeros(96, device=dev), 1e-6)
        return dict(numel=x.numel(), last_frame_equal_alone=bool(torch.equal(y[-1:], alone)))

    def pad_cat():
        x = rand(1, 96, T, H, W)
        y = F.pad(torch.cat([x[:, :, :1].expand(-1, -1, 2, -1, -1), x], dim=2), (1, 1, 1, 1))
        return dict(numel=y.numel(), last_equal=bool(torch.equal(y[0, :, -1, -2, -2], x[0, :, -1, -1, -1])))

    def upsample():
        x = rand(1, 192, T, H // 2, W // 2)
        y = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return dict(numel=y.numel(), last_equal=bool(torch.equal(y[0, :, -1, -1, -1], x[0, :, -1, -1, -1])))

    def silu_add():
        x = rand(1, 96, T, H, W)
        y = x + F.silu(x)
        return dict(numel=y.numel(), last_equal=bool(torch.equal(y[0, :, -1, -1, -1],
                                                                 x[0, :, -1, -1, -1] + F.silu(x[0, :, -1, -1, -1]))))

    for name, fn in (("conv3d_96_to_96", lambda: conv(96, 96)), ("conv3d_96_to_3", lambda: conv(96, 3)),
                     ("conv3d_3_to_96", lambda: conv(3, 96)), ("group_norm_fp32", group_norm),
                     ("causal_pad_and_cat", pad_cat), ("nearest_upsample_192", upsample), ("silu_add", silu_add)):
        run(name, fn)

    vae = init_parameters_(ae.AutoencoderKL3D(ae.WAN_VAE_CONFIG, dtype=torch.bfloat16).to(dev),
                           torch.Generator(device=dev).manual_seed(0)).eval()
    z = rand(1, 16, 21, 60, 104, dtype=torch.float32)
    video = torch.rand((1, 3, T, H, W), device=dev, generator=g) * 2 - 1
    outs = {}
    split = ae.SPLIT_ELEMENTS
    for mode, limit in (("split", split), ("whole", 1 << 62)):
        for kind, fn, arg in (("decode", vae.decode, z), ("encode", vae.encode, video)):
            def call(fn=fn, arg=arg, key=(mode, kind)):
                ae.SPLIT_ELEMENTS = limit
                with torch.no_grad():
                    outs[key] = fn(arg)
                return dict(shape=list(outs[key].shape), finite=bool(torch.isfinite(outs[key]).all()))
            run(f"vae_{kind}_{mode}", call)
    ae.SPLIT_ELEMENTS = split
    for kind in ("decode", "encode"):
        if ("whole", kind) in outs and ("split", kind) in outs:
            print(json.dumps({"probe": f"vae_{kind}_split_against_whole",
                              "bit_equal": bool(torch.equal(outs[("split", kind)], outs[("whole", kind)]))}),
                  flush=True)


if __name__ == "__main__":
    main()

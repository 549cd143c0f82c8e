"""int8 and fp8 weight storage against the JAX package: the row and weight
quantizers, `int8_linear`'s forward and input gradient, and the storage of a
2-block CogView4's frozen weights (one CogView4 LoRA step under int8 storage
is in test_torch_cogview4_int8_step.py).

The quantizers' codes and scales are equal to JAX's (the weight's at the
transposed position: the port's (F, K) is JAX's (K, F)). `int8_linear`'s
products are exact int32 sums on both sides, so the fp32 forward and dx equal
JAX's to an fp32 rounding of the epilogue (atol 1e-6 relative to the output's
scale); in bf16 within one bf16 unit in the last place of the output
(XLA's CPU fuses the bf16 epilogue in fp32 and rounds once; torch rounds
after each multiply). The storage holds the same leaves as JAX's apply_int8_storage and
apply_layerwise_storage_dtype (the skip patterns on the same names), with
equal codes, scales and fp8 bytes, values past the fp8 range included.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import split_params
from finetrainers_tpu.models.cogview4.transformer import CogView4Transformer2DModel as JaxCogView4
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.ops.int8_linear import int8_linear as jax_int8_linear
from finetrainers_tpu.ops.int8_linear import quantize_rows as jax_quantize_rows
from finetrainers_tpu.ops.int8_linear import quantize_weight as jax_quantize_weight
from finetrainers_tpu.utils.fp8 import apply_layerwise_storage_dtype as jax_fp8_storage
from finetrainers_tpu.utils.int8 import apply_int8_storage as jax_int8_storage
from finetrainers_tpu_torch.models.cogview4 import CogView4Transformer2DModel, cogview4_key_map, load_flax_params
from finetrainers_tpu_torch.ops.int8_linear import int8_linear, quantize_rows, quantize_weight
from finetrainers_tpu_torch.utils.fp8 import apply_layerwise_storage_dtype, count_fp8_bytes, to_fp8
from finetrainers_tpu_torch.utils.int8 import apply_int8_storage, count_int8_bytes, materialize_zeros_like
from test_torch_cogview4_transformer import TINY, jax_params, unflatten

torch.set_num_threads(1)

RANK, ALPHA = 4, 8.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_and_weight_codes_equal_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7, 96).astype(np.float32) * rng.uniform(0.01, 10, (5, 7, 1)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: the eps floor
    w = (rng.randn(96, 40) * 0.05).astype(np.float32)  # JAX's (K, F)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    codes, scales = quantize_rows(tx)
    ref_codes, ref_scales = jax_quantize_rows(jx)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ref_scales))
    wq, sw = quantize_weight(tw.t())  # the port's (F, K)
    ref_wq, ref_sw = jax_quantize_weight(jw)
    np.testing.assert_array_equal(wq.t().numpy(), np.asarray(ref_wq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(ref_sw))


@pytest.mark.parametrize("dtype,rows", [("float32", 37), ("float32", 5), ("bfloat16", 37)])
def test_int8_linear_forward_and_dx_match_jax(dtype, rows):
    """y and dx = J^T dy through the custom VJPs, at 37 rows and at 5 (below the
    17 rows `torch._int_mm` takes on the card: padded), K = 96, F = 40."""
    rng = np.random.RandomState(1)
    x = rng.randn(rows, 96).astype(np.float32)
    dy = rng.randn(rows, 40).astype(np.float32)
    wq, sw = jax_quantize_weight(jnp.asarray((rng.randn(96, 40) * 0.05).astype(np.float32)))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y_ref, vjp = jax.vjp(lambda a: jax_int8_linear(a, wq, sw), jnp.asarray(x, jdt))
    (dx_ref,) = vjp(jnp.asarray(dy, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    y = int8_linear(tx, torch.from_numpy(np.asarray(wq).T.copy()), torch.from_numpy(np.array(sw)))
    y.backward(torch.from_numpy(dy).to(tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt
    for got, ref in ((y, y_ref), (tx.grad, dx_ref)):
        ref = np.asarray(ref.astype(jnp.float32))
        tol = 1e-6 if dtype == "float32" else 2.0**-7  # bf16: one unit in the last place of a value of size ~1
        np.testing.assert_allclose(got.detach().float().numpy(), ref, atol=tol * np.abs(ref).max(), rtol=0)


def _jax_frozen():
    module = JaxCogView4(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32, use_scan=False)
    flat = jax_params(module)
    keys = sorted(flat)
    # Values past both fp8 formats' range in the first attention's q kernel: they become NaN (e4m3fn) or inf (e5m2).
    key = next(k for k in keys if k.endswith("attn1_to_q.kernel"))
    flat[key] = flat[key].copy()
    flat[key][0, :4] = [500.0, -1000.0, 7e4, -465.0]
    params = unflatten(flat)
    _, frozen = split_params(params, jax_lora_mask(params))
    return flat, frozen


def _port_model(flat):
    model = CogView4Transformer2DModel(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=torch.float32)
    load_flax_params(model, flat)
    for name, param in model.named_parameters():
        param.requires_grad_(".lora_" in name)
    return model


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
            if v is not None and not k.endswith(("lora_a", "lora_b"))}


def test_int8_storage_on_cogview4_matches_jax():
    flat, frozen = _jax_frozen()
    ref = _flat(jax_int8_storage(frozen))
    model = apply_int8_storage(_port_model(flat))
    state = model.state_dict()
    quantized = {cogview4_key_map(k.replace("kernel_qscale", "kernel")) for k, v in ref.items()
                 if k.endswith("kernel_qscale")}
    assert quantized == {k for k, v in state.items() if v.dtype == torch.int8}
    assert 0 < len(quantized) < sum(k.endswith(".kernel") for k in ref)  # some skipped: embeddings, norms, proj_out
    for key, value in ref.items():
        if key.endswith("kernel_qscale"):
            name = cogview4_key_map(key.replace("kernel_qscale", "kernel"))
            np.testing.assert_array_equal(state[name].numpy().T, ref[key.replace("kernel_qscale", "kernel")])
            np.testing.assert_array_equal(state[name.replace(".weight", ".weight_qscale")].numpy(), value)
    assert count_int8_bytes(model) == sum(v.size for v in ref.values() if v.dtype == np.int8)


@pytest.mark.parametrize("storage", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_storage_on_cogview4_matches_jax(storage):
    flat, frozen = _jax_frozen()
    ref = _flat(jax_fp8_storage(frozen, storage_dtype=getattr(jnp, storage)))
    model = apply_layerwise_storage_dtype(_port_model(flat), getattr(torch, storage))
    state = model.state_dict()
    ref_fp8 = {cogview4_key_map(k): v for k, v in ref.items() if v.dtype == getattr(ml_dtypes, storage)}
    assert set(ref_fp8) == {k for k, v in state.items() if v.dtype == getattr(torch, storage)}
    for name, value in ref_fp8.items():  # bytes, so NaN and inf patterns count too
        np.testing.assert_array_equal(state[name].view(torch.uint8).numpy().T, value.view(np.uint8))
    assert count_fp8_bytes(model) == sum(v.size for v in ref_fp8.values())
    special = state[next(k for k in ref_fp8 if k.endswith("0.attn1.to_q.weight"))].float()[:4, 0]
    if storage == "float8_e4m3fn":  # past 464 ml_dtypes gives NaN (torch alone would saturate to 448)
        assert bool(torch.isnan(special).all())
    else:
        assert special[:2].tolist() == [512.0, -1024.0] and special[2].item() == float("inf")


def test_to_fp8_pins_jax_casts_past_the_range():
    x = np.asarray([448.0, 464.0, 465.0, -470.0, 1e6, 57344.0, 61439.0, 61440.0, -1e9, 0.1], np.float32)
    for name in ("float8_e4m3fn", "float8_e5m2"):
        got = to_fp8(torch.from_numpy(x), getattr(torch, name)).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, x.astype(getattr(ml_dtypes, name)).view(np.uint8), err_msg=name)
        # A NaN stays NaN (e5m2's NaN byte is 0x7F here, 0x7E in ml_dtypes: both NaN).
        assert bool(torch.isnan(to_fp8(torch.tensor([float("nan")]), getattr(torch, name)).float()).all())


def test_materialize_zeros_like_keeps_the_int8_layout():
    """The quantized layout's memory without its weights: every int8 weight's
    codes zeroed and its scales 1e-8 (JAX's sidecars), nothing else touched."""
    flat, _ = _jax_frozen()
    model = apply_int8_storage(_port_model(flat))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    materialize_zeros_like(model)
    for name, value in model.state_dict().items():
        if before[name].dtype == torch.int8:
            assert not value.any(), name
        elif name.endswith(".weight_qscale"):
            assert bool((value == 1e-8).all()), name
        else:
            assert torch.equal(value, before[name]), name
    assert count_int8_bytes(model) == sum(v.numel() for v in before.values() if v.dtype == torch.int8)

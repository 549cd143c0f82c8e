"""The `ring` and `ulysses` providers on one card against the JAX package's
outside a context-parallel region.

Outside such a region JAX's `ring` is `flash_attention` and its `ulysses` is
`_auto_attention` (`ops/attention.py:620-622`, :679-680); neither takes the
RoPE tables, so the JAX dispatcher rotates q and k before the call. The same
numpy inputs (self-attention with full-width tables, cross-attention with
kv_lens) through both dispatchers in fp32, JAX's flash kernel in interpret
mode: outputs within atol 2e-5, and under `ring` the gradients of q, k and v
through the port's K4 against `jax.grad` (atol 1e-4). On the CPU the port's
`ring` takes K4's plain versions; the dispatcher's rotation runs in torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.ops import attention_dispatch as jax_attention_dispatch
from finetrainers_tpu_torch.ops import attention_dispatch
from finetrainers_tpu_torch.ops import attention as attention_ops

torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(sq, skv, seed=0, n=2, h=64):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(1, s, n, h).astype(np.float32) for s in (sq, skv, skv))
    ang = rng.uniform(0, 2 * np.pi, (sq, n * h // 2))
    tables = tuple(np.repeat(f(ang), 2, -1).astype(np.float32) for f in (np.cos, np.sin))
    return q, k, v, tables


@pytest.mark.parametrize("provider", ["ring", "ulysses"])
@pytest.mark.parametrize("case", ["self_rope", "cross_kv_lens"])
def test_single_device_branch_matches_jax(provider, case):
    if case == "self_rope":
        q, k, v, tables = _inputs(40, 40)
        kv_lens = None
    else:
        q, k, v, _ = _inputs(40, 24, seed=1)
        tables, kv_lens = None, np.array([17], np.int32)
    ref = jax_attention_dispatch(*(jnp.asarray(x) for x in (q, k, v)), provider=provider,
                                 kv_lens=None if kv_lens is None else jnp.asarray(kv_lens),
                                 rope_freqs=None if tables is None else tuple(jnp.asarray(t) for t in tables))
    out = attention_dispatch(*(torch.from_numpy(x) for x in (q, k, v)), provider=provider,
                             kv_lens=None if kv_lens is None else torch.from_numpy(kv_lens),
                             rope_freqs=None if tables is None else tuple(torch.from_numpy(t) for t in tables))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_ring_gradients_match_jax(monkeypatch):
    q, k, v, tables = _inputs(32, 32, seed=2)
    w = np.random.RandomState(3).randn(*q.shape).astype(np.float32)
    flash_calls = []
    flash = attention_ops._flash
    monkeypatch.setattr(attention_ops, "_flash", lambda *a, **kw: flash_calls.append(kw) or flash(*a, **kw))

    def jax_loss(q, k, v):
        out = jax_attention_dispatch(q, k, v, provider="ring", rope_freqs=tuple(jnp.asarray(t) for t in tables))
        return jnp.sum(out * jnp.asarray(w))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention_dispatch(*leaves, provider="ring", rope_freqs=tuple(torch.from_numpy(t) for t in tables))
    (out * torch.from_numpy(w)).sum().backward()
    assert len(flash_calls) == 1 and "rope_freqs" not in flash_calls[0]  # rotated before K4, which takes no tables
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=1e-4, rtol=0)

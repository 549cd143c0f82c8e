"""The T5/UMT5 tower and `T5Handle` against JAX's `FlaxT5Handle` (transformers'
`FlaxT5EncoderModel`), on towers that transformers' torch classes write: a
relu T5, a gated-gelu T5 (v1.1) and a UMT5. Padded captions through one stub
tokenizer; the states agree within 1e-5 in fp32. On the UMT5 both packages
hold layer 0's relative-attention table for every layer, so both differ from
`UMT5EncoderModel`'s own states (ROADMAP.md section 3, finding 24)."""

import numpy as np
import pytest
import torch

from finetrainers_tpu.processors.text_encoders import FlaxT5Handle
from finetrainers_tpu_torch.models.text_encoders import T5Handle, handles

torch.set_num_threads(1)
TOL = 1e-5
CAPTIONS = ["a cat sits on a mat", "one two three four five six seven eight nine ten eleven twelve thirteen"]
MAX_LEN = 12
DIMS = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=16)


class StubTokenizer:
    """One id per word (3, 4, ...), then EOS (1), padded with 0 to max_length and truncated."""

    pad_token_id = 0

    def __call__(self, texts, padding=None, max_length=None, truncation=None, return_tensors=None, **kw):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            row = [(j * 7) % 60 + 3 for j in range(len(t.split()))][:max_length - 1] + [1]
            ids[i, :len(row)] = row
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def _write(root, kind):
    from transformers import T5Config, T5EncoderModel, UMT5Config, UMT5EncoderModel

    torch.manual_seed({"relu": 0, "gated": 1, "umt5": 2}[kind])
    if kind == "umt5":
        model = UMT5EncoderModel(UMT5Config(**DIMS, num_layers=3, feed_forward_proj="gated-gelu"))
    else:
        model = T5EncoderModel(T5Config(**DIMS, num_layers=2,
                                        feed_forward_proj="relu" if kind == "relu" else "gated-gelu"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    model.eval().save_pretrained(root / "text_encoder", safe_serialization=True)
    return model


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """{kind: (pipeline root, transformers' torch model)}."""
    return {kind: (root, _write(root, kind)) for kind in ("relu", "gated", "umt5")
            for root in [tmp_path_factory.mktemp(kind)]}


@pytest.mark.parametrize("kind", ["relu", "gated", "umt5"])
def test_handle_matches_flax_t5_handle(towers, kind, monkeypatch):
    root, source = towers[kind]
    warned = []
    monkeypatch.setattr(handles.logger, "warning", lambda msg: warned.append(msg))
    ours = T5Handle(str(root), dtype=torch.float32, device="cpu")
    ref = FlaxT5Handle(str(root))
    assert ours.tokenizer is None and ref.tokenizer is None  # no tokenizer file: set by the caller, as in JAX
    ours.tokenizer = ref.tokenizer = StubTokenizer()
    got, mask = ours.encode(CAPTIONS, max_sequence_length=MAX_LEN)
    want, want_mask = ref.encode(CAPTIONS, max_sequence_length=MAX_LEN)
    assert got.shape == want.shape == (2, MAX_LEN, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(mask, want_mask)
    assert mask.sum(1).tolist() == [7, MAX_LEN]  # padded and truncated
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    assert len([m for m in warned if "finding 24" in m]) == (1 if kind == "umt5" else 0)
    if kind != "relu":
        assert ours.module.encoder.block[0].layer[1].DenseReluDense.gated
    # transformers' torch tower on the same files: T5 agrees; UMT5 (one table per layer) does not.
    with torch.no_grad():
        own = source(input_ids=torch.from_numpy(StubTokenizer()(CAPTIONS, max_length=MAX_LEN)["input_ids"]),
                     attention_mask=torch.from_numpy(mask.astype(np.int64))).last_hidden_state.numpy()
    valid = mask.astype(bool)
    gap = np.abs(own[valid] - got[valid]).max()
    if kind == "umt5":
        assert gap > 1e-2 and np.abs(own[valid] - np.asarray(want)[valid]).max() > 1e-2
    else:
        assert gap < 1e-4


def test_path_resolution(towers, tmp_path):
    root = towers["relu"][0]
    assert T5Handle.resolve(str(root)) == str(root / "text_encoder")  # a pipeline root
    assert T5Handle.resolve(str(root / "text_encoder")) == str(root / "text_encoder")  # the tower's own directory
    (tmp_path / "text_encoder").mkdir()
    (tmp_path / "config.json").write_text("{}")
    assert T5Handle.resolve(str(tmp_path)) == str(tmp_path)  # a root with its own config.json stays
    assert T5Handle.resolve("google/t5-v1_1-xxl") == "google/t5-v1_1-xxl"  # a Hub id is not fetched
    with pytest.raises(OSError):
        T5Handle("google/t5-v1_1-xxl", device="cpu")
    handle = T5Handle(str(root / "text_encoder"), dtype=torch.float32, device="cpu")
    assert handle.config.num_layers == 2 and handle.config.feed_forward_proj == "relu"

"""Checkpoint and resume of the port's trainer (`checkpoint.Checkpointer`,
`SFTTrainer.prepare`/`train`), on a tiny Wan 2.1 model on the CPU.

The run is the Wan example's, scaled down: LoRA, `ops` remat, gradient
accumulation over 2 micro-steps, a checkpoint every 2 steps with the 2 newest
kept, 6 seeded batches, the draws from the trainer's own generator.

- An unbroken run of 6 micro-steps against a broken one: 3 micro-steps (the
  forced save at the end falls in the middle of an accumulation), then a
  fresh spec, model and trainer that resume "latest" and take the other 3.
  The LoRA factors, the AdamW moments and steps, the accumulator, the
  schedule's count, the generator state and the loss history are bit-equal.
- The limit keeps `finetrainers_step_4` and `_6`; "latest" is 6; every save
  exported its adapter to `lora_weights/<step>`.
- Resuming a named step restores that step's train state.
- A run in a directory an earlier run used rewrites the steps it reaches and
  removes the later ones, so "latest" and each export are its own.
- The checkpointer on its own: the cadence, `force`, an empty directory, and
  a step directory whose state file was never completed.
- A full-rank run exports the whole transformer instead of an adapter.
- A trainer that is dropped frees its model at once: nothing of the
  checkpointing refers back to it.
"""

import gc
import json
import weakref

import numpy as np
import pytest
import torch

from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.checkpoint import CHECKPOINT_PREFIX, Checkpointer
from finetrainers_tpu_torch.trainer import SFTTrainer
from finetrainers_tpu_torch.utils.serialization import safetensors_load_dict

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
            num_layers=2, ffn_dim=64, text_dim=32, freq_dim=16)
MOMENTS = (1, 8, 2, 8, 8)
TEXT_LEN = 16
STEPS = 6


def _batches():
    rng = np.random.RandomState(5)
    out = []
    for _ in range(STEPS):
        moments = torch.from_numpy(rng.randn(*MOMENTS).astype(np.float32))
        moments[:, MOMENTS[1] // 2:] = -1.0 + 0.5 * moments[:, MOMENTS[1] // 2:]
        conditions = {"encoder_hidden_states": torch.from_numpy(rng.randn(1, TEXT_LEN, 32).astype(np.float32)),
                      "encoder_attention_mask": torch.ones(1, TEXT_LEN, dtype=torch.int32)}
        latents = {"latents": moments, "latents_mean": torch.zeros(MOMENTS[1] // 2),
                   "latents_std": torch.ones(MOMENTS[1] // 2)}
        out.append((conditions, latents))
    return out


def _trainer(output_dir, **kw):
    spec = get_model_specification_cls("wan", "lora")(device="cpu", transformer_config=TINY,
                                                      transformer_dtype=torch.float32)
    args = BaseArgs(training_type="lora", rank=4, lora_alpha=8, seed=3, train_steps=STEPS, lr=1e-3,
                    lr_scheduler="linear", lr_warmup_steps=1, gradient_checkpointing=True,
                    gradient_checkpointing_type="ops", gradient_accumulation_steps=2, checkpointing_steps=2,
                    checkpointing_limit=2, output_dir=str(output_dir), **kw)
    trainer = SFTTrainer(args, spec)
    trainer.prepare()
    return trainer


def _assert_same_state(a, b):
    for name, param in a._trainable.items():
        assert torch.equal(param, b._trainable[name]), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["mini_step"] == sb["mini_step"] and sa["inner"]["count"] == sb["inner"]["count"]
    for x, y in zip(sa["acc_grads"], sb["acc_grads"]):
        assert torch.equal(x, y)
    moments_a, moments_b = sa["inner"]["inner"]["state"], sb["inner"]["inner"]["state"]
    assert moments_a.keys() == moments_b.keys() and len(moments_a) == len(a._trainable)
    for key in moments_a:
        for field in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments_a[key][field], moments_b[key][field]), (key, field)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.state.train_state.state_dict() == b.state.train_state.state_dict()


def test_resume_in_the_middle_of_an_accumulation_is_bit_equal(tmp_path):
    batches = _batches()
    unbroken = _trainer(tmp_path / "unbroken")
    unbroken.train(batches)
    assert unbroken.state.train_state.step == STEPS and unbroken.optimizer.count == STEPS // 2
    ckpt = unbroken.checkpointer
    assert ckpt.all_steps() == [4, 6] and ckpt.latest_step() == 6
    assert sorted(p.name for p in ckpt.output_dir.iterdir()) == [f"{CHECKPOINT_PREFIX}4", f"{CHECKPOINT_PREFIX}6"]
    exports = sorted(p.name for p in (tmp_path / "unbroken" / "lora_weights").iterdir())
    assert exports == ["000002", "000004", "000006"]

    first = _trainer(tmp_path / "broken")
    first.train(batches[:3])
    assert first.checkpointer.all_steps() == [2, 3] and first.optimizer.mini_step == 1
    del first
    resumed = _trainer(tmp_path / "broken", resume_from_checkpoint="latest")
    assert resumed.state.train_state.step == 3 and resumed.optimizer.mini_step == 1
    assert resumed.optimizer.count == 1
    resumed.train(batches[3:])
    assert resumed.checkpointer.all_steps() == [4, 6]
    _assert_same_state(unbroken, resumed)
    assert len(resumed.state.train_state.global_avg_losses) == STEPS
    assert all(np.isfinite(resumed.state.train_state.global_avg_losses))


def test_resume_a_named_step_into_a_fresh_trainer(tmp_path):
    batches = _batches()
    _trainer(tmp_path).train(batches[:4])
    resumed = _trainer(tmp_path, resume_from_checkpoint="4")
    assert resumed.state.train_state.step == 4 and resumed.optimizer.count == 2
    assert resumed.optimizer.mini_step == 0
    assert resumed.state.train_state.log_steps == [1, 2, 3, 4]
    fresh = _trainer(tmp_path / "elsewhere", resume_from_checkpoint="latest")  # nothing saved there yet
    assert fresh.state.train_state.step == 0 and fresh.optimizer.count == 0


@pytest.mark.parametrize("resume", ["4", None])
def test_a_run_rewrites_the_steps_an_earlier_run_left(tmp_path, resume):
    batches = _batches()
    _trainer(tmp_path).train(batches)  # leaves steps 4 and 6, exports 2, 4 and 6
    old = {step: Checkpointer(str(tmp_path / "checkpoints")).load(step)[1]["trainable"] for step in (4, 6)}
    new = _trainer(tmp_path, resume_from_checkpoint=resume)
    new.train(batches[::-1][:2])  # other data than the earlier run's, so other states
    step = new.state.train_state.step
    assert step == (6 if resume else 2)
    assert new.checkpointer.all_steps() == ([4, 6] if resume else [2]) and new.checkpointer.latest_step() == step
    saved = new.checkpointer.load(step)[1]["trainable"]
    exported = safetensors_load_dict(str(tmp_path / "lora_weights" / f"{step:06d}" / "pytorch_lora_weights.safetensors"))
    for name, param in new._trainable.items():
        assert torch.equal(saved[name], param.detach()) and torch.equal(exported["transformer." + name], param.detach())
    assert any(not torch.equal(saved[name], old[step if resume else 4][name]) for name in saved)


@pytest.mark.parametrize("limit", [None, 2])
def test_checkpointer_cadence_force_and_limit(tmp_path, limit):
    exported = []
    ckpt = Checkpointer(str(tmp_path), checkpointing_steps=3, checkpointing_limit=limit,
                        callback_fn=lambda state: exported.append(int(state["x"])))
    assert ckpt.latest_step() is None and ckpt.load() is None
    for step in range(1, 8):
        saved = ckpt.save(step, {"x": torch.tensor(step), "meta": {"step": step, "tag": "t"}})
        assert saved == (step % 3 == 0)
    assert ckpt.save(7, {"x": torch.tensor(7), "meta": {}}, force=True)
    assert ckpt.all_steps() == ([3, 6, 7] if limit is None else [6, 7]) and exported == [3, 6, 7]
    step, state = ckpt.load()
    assert step == 7 and int(state["x"]) == 7
    assert ckpt.load(6)[1]["meta"] == {"step": 6, "tag": "t"}
    assert ckpt.load(5) is None
    (tmp_path / f"{CHECKPOINT_PREFIX}9").mkdir()  # a save that never completed its state file
    assert ckpt.latest_step() == 7


def test_full_rank_run_exports_the_model(tmp_path):
    """A full-rank run's save exports the transformer in diffusers format:
    config.json with the class name, and every parameter in
    `model_weights/<step>/diffusion_pytorch_model.safetensors`."""
    spec = get_model_specification_cls("wan", "lora")(device="cpu", transformer_config=TINY,
                                                      transformer_dtype=torch.float32)
    trainer = SFTTrainer(BaseArgs(training_type="full-finetune", seed=3, train_steps=1, output_dir=str(tmp_path)),
                         spec)
    trainer.prepare()
    trainer.train(_batches()[:1])
    directory = tmp_path / "model_weights" / "000001"
    with open(directory / "config.json") as f:
        config = json.load(f)
    assert config["_class_name"] == "WanTransformer3DModel" and config["num_layers"] == TINY["num_layers"]
    state = safetensors_load_dict(str(directory / "diffusion_pytorch_model.safetensors"))
    params = dict(trainer.transformer.module.named_parameters())
    assert sorted(state) == sorted(params) and len(trainer._trainable) == len(params)
    for name, param in params.items():
        assert torch.equal(state[name], param.detach()), name


def test_dropped_trainer_is_freed_without_the_cycle_collector(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.train(_batches()[:2])
    refs = weakref.ref(trainer), weakref.ref(trainer.transformer.module)
    gc.disable()
    try:
        del trainer
        assert all(ref() is None for ref in refs)
    finally:
        gc.enable()

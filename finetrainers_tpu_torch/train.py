"""The command line of the port (the counterpart of the repository's
`train.py`): peek `--training_type`, parse the arguments, resolve the model
specification and run the SFT trainer, or for `control-lora` and
`control-full-finetune` the control trainer (JAX `train.py:53-62`, :91-94).

    python -m finetrainers_tpu_torch.train <the flags of an example's train.sh>

The models train on the card (`--device cuda`, the default) unless
`--device cpu` asks for the CPU. `main(argv)` returns the trainer after its
run; keyword arguments go to the model specification (e.g. a smaller
`transformer_config` or `vae_config`).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .args import CONTROL_TRAINING_TYPES, BaseArgs
from .config import TrainingType, get_model_specification_cls


def main(argv: Optional[List[str]] = None, **spec_kwargs):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = BaseArgs()
    if "--list_models" in argv:
        args.parse_args(argv)  # prints the registry and exits
    training_type = argv[argv.index("--training_type") + 1] if "--training_type" in argv else None
    if training_type not in [t.value for t in TrainingType]:
        raise ValueError(f"--training_type must be one of {[t.value for t in TrainingType]}, got {training_type!r}")
    args.parse_args(argv)

    spec_cls = get_model_specification_cls(args.model_name, args.training_type)
    spec = spec_cls(
        pretrained_model_name_or_path=args.pretrained_model_name_or_path,
        text_encoder_id=args.text_encoder_id,
        text_encoder_2_id=args.text_encoder_2_id,
        tokenizer_id=args.tokenizer_id,
        tokenizer_2_id=args.tokenizer_2_id,
        transformer_id=args.transformer_id,
        vae_id=args.vae_id,
        text_encoder_dtype=args.text_encoder_dtype,
        text_encoder_2_dtype=args.text_encoder_2_dtype,
        transformer_dtype=args.transformer_dtype,
        vae_dtype=args.vae_dtype,
        device=args.device,
        **spec_kwargs,
    )
    if args.training_type in CONTROL_TRAINING_TYPES:
        from .trainer.control_trainer import ControlTrainer as trainer_cls
    else:
        from .trainer import SFTTrainer as trainer_cls

    trainer = trainer_cls(args, spec)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()

from .sft_trainer import SFTTrainer

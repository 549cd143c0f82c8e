from .trainer import SFTTrainer

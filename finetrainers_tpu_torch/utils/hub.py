"""The model card of a run (port of `save_model_card` from
`finetrainers_tpu/utils/hub.py`; the port pushes nothing to the Hub)."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional


MODEL_CARD_TEMPLATE = """---
base_model: {base_model}
library_name: finetrainers-tpu
license: other
tags:
- text-to-{media}
- diffusers
- lora
- template:sd-lora
---

# {model_name} LoRA — trained with finetrainers-tpu (PyTorch port)

This is a fine-tune of [`{base_model}`]({base_model_url}) trained with the
PyTorch port of finetrainers-tpu (`finetrainers_tpu_torch`).

## Training details

{training_details}

## Usage

Load the LoRA weights with diffusers (`pipe.load_lora_weights(...)`) or with
`finetrainers_tpu_torch.lora.load_lora_weights`.

## Validation prompts

{validation_prompts}
"""


def save_model_card(output_dir: str, base_model: str, model_name: Optional[str] = None,
                    training_details: Optional[Dict[str, Any]] = None,
                    validation_prompts: Optional[List[str]] = None, media: str = "video") -> str:
    """Write `output_dir/README.md`; returns its path."""
    card = MODEL_CARD_TEMPLATE.format(
        base_model=base_model,
        base_model_url=f"https://huggingface.co/{base_model}",
        model_name=model_name or os.path.basename(output_dir.rstrip("/")),
        training_details="\n".join(f"- **{k}**: {v}" for k, v in (training_details or {}).items()) or "- n/a",
        validation_prompts="\n".join(f"- {p}" for p in (validation_prompts or [])) or "- n/a",
        media=media,
    )
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "README.md")
    with open(path, "w") as f:
        f.write(card)
    return path

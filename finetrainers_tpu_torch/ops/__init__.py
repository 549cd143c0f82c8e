from .attention import (
    AttentionProvider,
    attention_dispatch,
    attention_provider,
    get_active_provider,
    list_providers,
    pack_sequences,
)
from .flash_attention import flash_attention, flash_attention_reference, flash_forward


__all__ = [
    "AttentionProvider",
    "attention_dispatch",
    "attention_provider",
    "get_active_provider",
    "list_providers",
    "pack_sequences",
    "flash_attention",
    "flash_attention_reference",
    "flash_forward",
]

from .base_specification import FLUX_TRANSFORMER_CONFIG, FluxModelSpecification
from .pipeline import FluxPipeline
from .transformer import (
    FluxTransformer2DModel,
    flux_rope_angles,
    flux_rope_freqs,
    pack_flux_latents,
    prepare_latent_image_ids,
    rope_tables,
    unpack_flux_latents,
)
from .weights import flux_key_map, load_flax_params

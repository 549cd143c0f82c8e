from .base_specification import LTX_TRANSFORMER_CONFIG, LTXVideoModelSpecification
from .pipeline import LTXPipeline
from .transformer import LTXVideoTransformer3DModel, pack_latents, unpack_latents
from .weights import load_flax_params, ltx_key_map

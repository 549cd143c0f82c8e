from .base_specification import COGVIDEOX_2B_CONFIG, COGVIDEOX_5B_CONFIG, CogVideoXModelSpecification
from .pipeline import CogVideoXPipeline
from .transformer import CogVideoXTransformer3DModel, cogvideox_rope_tables, patchify, unpatchify
from .weights import cogvideox_key_map, load_flax_params

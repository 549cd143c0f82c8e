from .base_specification import COGVIEW4_TRANSFORMER_CONFIG, CogView4ModelSpecification
from .control_specification import CogView4ControlModelSpecification
from .pipeline import CogView4Pipeline
from .transformer import CogView4Transformer2DModel, cogview4_rope_tables, patchify, unpatchify
from .weights import cogview4_key_map, load_flax_params

from .base_specification import WAN_I2V_14B_CONFIG, WAN_T2V_1_3B_CONFIG, WanModelSpecification
from .pipeline import WanPipeline
from .transformer import WanTransformer3DModel, wan_rope_freqs
from .weights import load_flax_params, wan_key_map
from .control_specification import WanControlModelSpecification

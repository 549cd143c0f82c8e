from .base_specification import HUNYUAN_VIDEO_CONFIG, HunyuanVideoModelSpecification
from .pipeline import HunyuanVideoPipeline
from .transformer import HunyuanVideoTransformer3DModel, kv_lens_from_mask, patchify, unpatchify, video_ids
from .weights import hunyuan_key_map, load_flax_params

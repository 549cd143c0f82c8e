from .base_specification import (DummyModelSpecification, DummyTransformer, DummyTransformerBlock, DummyVAE,
                                  sample_posterior)
from .pipeline import DummyPipeline
from .weights import dummy_key_map, load_flax_params

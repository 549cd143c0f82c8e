from .base import ProcessorMixin
from .text import CaptionTextDropoutProcessor
from .text_encoders import CLIPPooledProcessor, HashEncoder, LlamaProcessor, T5Processor

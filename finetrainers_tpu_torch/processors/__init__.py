from .base import ProcessorMixin
from .control import CannyProcessor, CopyProcessor
from .text import CaptionTextDropoutProcessor
from .text_encoders import CLIPPooledProcessor, CogView4GLMProcessor, HashEncoder, LlamaProcessor, T5Processor

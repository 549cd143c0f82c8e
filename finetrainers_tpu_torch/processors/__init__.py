from .base import ProcessorMixin
from .text import CaptionTextDropoutProcessor
from .text_encoders import HashEncoder, T5Processor

from .modeling_utils import ModelHandle, ModelSpecification

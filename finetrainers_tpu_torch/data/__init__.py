from ._artifact import Artifact, ImageArtifact, VideoArtifact
from .dataloader import DPDataLoader
from .dataset import (
    ImageCaptionFilePairDataset,
    ImageFileCaptionFileListDataset,
    ImageFolderDataset,
    ImageWebDataset,
    IterableCombinedDataset,
    IterableDatasetPreprocessingWrapper,
    ValidationDataset,
    VideoCaptionFilePairDataset,
    VideoFileCaptionFileListDataset,
    VideoFolderDataset,
    VideoWebDataset,
    combine_datasets,
    initialize_dataset,
    wrap_iterable_dataset_for_preprocessing,
)
from .precomputation import (
    InMemoryDistributedDataPreprocessor,
    PrecomputedDistributedDataPreprocessor,
    initialize_preprocessor,
)
from .prefetch import DevicePrefetcher, to_device
from .sampler import ResolutionSampler

"""Environment knobs and data-stage constants of the port (copied from
`finetrainers_tpu/constants.py`)."""

import os


FINETRAINERS_LOG_LEVEL = os.environ.get("FINETRAINERS_LOG_LEVEL", "INFO")
# "auto": the hand-written flash kernel (K1) where it applies, plain math otherwise.
FINETRAINERS_ATTN_PROVIDER = os.environ.get("FINETRAINERS_ATTN_PROVIDER", "auto")
FINETRAINERS_ATTN_CHECKS = os.environ.get("FINETRAINERS_ATTN_CHECKS", "0") in ("1", "true", "TRUE", "True")
# The tracker's `timed` spans (timing/* metrics); "0" turns them off.
FINETRAINERS_ENABLE_TIMING = os.environ.get("FINETRAINERS_ENABLE_TIMING", "1") in ("1", "true", "TRUE", "True")

PRECOMPUTED_DIR_NAME = "finetrainers-precomputed-data"

SUPPORTED_IMAGE_FILE_EXTENSIONS = ["jpg", "jpeg", "png", "webp"]
SUPPORTED_VIDEO_FILE_EXTENSIONS = ["mp4", "mov", "webm", "avi", "gif"]

CAPTION_COLUMN_NAMES = [
    "caption", "captions", "short_caption", "long_caption", "prompt", "prompts",
    "short_prompt", "long_prompt", "description", "descriptions", "text", "texts",
    "alt_text", "alt_texts", "alt_caption", "alt_captions", "image_description",
    "image_descriptions", "video_description", "video_descriptions", "title", "titles",
]

# Caption, video and image list files of the file-list layout (`data/dataset.py`).
COMMON_CAPTION_FILES = ["prompt.txt", "prompts.txt", "caption.txt", "captions.txt"]
COMMON_VIDEO_FILES = ["video.txt", "videos.txt"]
COMMON_IMAGE_FILES = ["image.txt", "images.txt"]

# Prefixes that LLM captioners commonly prepend; stripped during preprocessing.
COMMON_LLM_START_PHRASES = (
    "The video",
    "In this video",
    "In this detailed video",
    "The image",
    "In this image",
    "In this detailed image",
    "Here is a",
    "Here's a",
    "This video",
    "This image",
    "This detailed video",
    "This detailed image",
    "In the video",
    "In the image",
    "A video of",
    "A video showing",
    "An image of",
    "An image showing",
    "The animated video",
    "The animated image",
    "The scene",
)

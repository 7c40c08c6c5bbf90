from .datasets import SyntheticTextDataset, TextDataset  # noqa: F401
from .loader import DataLoader  # noqa: F401
from .transforms import (  # noqa: F401
    bbox_crop, build_eval_transform, build_train_transform,
    multiscale_pyramid)

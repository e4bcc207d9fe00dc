from .compose import PIPELINES, Compose
from .formatting import Collect, DefaultFormatBundle, ImageToTensor
from .loading import LoadAnnotations, LoadImageFromFile, imread, imwrite_netpbm
from .test_aug import MultiScaleFlipAug
from .transforms import Normalize, Pad, RandomFlip, Resize, imrescale_size, imresize

__all__ = ["PIPELINES", "Compose", "Collect", "DefaultFormatBundle", "ImageToTensor",
           "LoadAnnotations", "LoadImageFromFile", "imread", "imwrite_netpbm", "MultiScaleFlipAug",
           "Normalize", "Pad", "RandomFlip", "Resize", "imrescale_size", "imresize"]

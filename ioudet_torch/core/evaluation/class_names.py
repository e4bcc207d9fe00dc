"""Dataset class-name tables (counterpart of
``ioudet/core/evaluation/class_names.py``)."""

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic_light", "fire_hydrant", "stop_sign",
    "parking_meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports_ball", "kite",
    "baseball_bat", "baseball_glove", "skateboard", "surfboard",
    "tennis_racket", "bottle", "wine_glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot_dog", "pizza", "donut", "cake", "chair", "couch", "potted_plant",
    "bed", "dining_table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell_phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy_bear",
    "hair_drier", "toothbrush",
)

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

WIDER_FACE_CLASSES = ("face",)

CITYSCAPES_CLASSES = ("person", "rider", "car", "truck", "bus", "train",
                      "motorcycle", "bicycle")

_ALIASES = {
    "coco": COCO_CLASSES,
    "voc": VOC_CLASSES,
    "pascal_voc": VOC_CLASSES,
    "wider_face": WIDER_FACE_CLASSES,
    "cityscapes": CITYSCAPES_CLASSES,
}


def coco_classes():
    return list(COCO_CLASSES)


def voc_classes():
    return list(VOC_CLASSES)


def get_classes(dataset: str):
    if dataset in _ALIASES:
        return list(_ALIASES[dataset])
    raise KeyError(f"unknown dataset {dataset}")

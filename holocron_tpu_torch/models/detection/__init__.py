from ._utils import detections_to_list, masked_nms, pad_targets, post_process
from .yolo import *  # noqa: F403
from .yolov2 import *  # noqa: F403
from .yolov4 import *  # noqa: F403

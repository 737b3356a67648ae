"""The nuScenes detection metric (NDS) and the conversion of detections and
GT into its boxes; the COCO-style 2D mAP."""
from .coco_map import evaluate_coco_map
from .format import detections_to_eval_boxes, gt_to_eval_boxes
from .nds import DETECTION_CLASSES, EvalBox, evaluate_nuscenes

__all__ = ["DETECTION_CLASSES", "EvalBox", "detections_to_eval_boxes", "evaluate_coco_map",
           "evaluate_nuscenes", "gt_to_eval_boxes"]

"""Training of the port (counterpart of lvv_tpu/train and the one-card part
of lvv_tpu/parallel): optimizer groups, the train step, checkpoints,
metrics and the Trainer; the detector's train step and optimizer."""
from .checkpoints import CheckpointManager
from .detector import (detector_loss, make_bucketed_detector_train_step,
                       make_detector_train_step, recall_stats)
from .metrics import (bleu4, caption_metrics, cider, extract_boxes,
                      extract_class, grounding_metrics, metrics_by_template)
from .optim import (GROUPS, ClipAdamW, MultiGroupAdamW, count_by_group,
                    detector_optimizer, group_labels, make_optimizer,
                    make_schedule, param_group, trainable_mask)
from .train_step import (TrainState, create_state, load_masters,
                         make_eval_step, make_train_step)
from .trainer import Trainer, build_model

__all__ = ["CheckpointManager", "bleu4", "caption_metrics", "cider",
           "extract_boxes", "extract_class", "grounding_metrics",
           "metrics_by_template", "GROUPS", "MultiGroupAdamW",
           "count_by_group", "group_labels", "make_optimizer",
           "make_schedule", "param_group", "trainable_mask", "TrainState",
           "create_state", "load_masters", "make_eval_step",
           "make_train_step", "Trainer", "build_model", "ClipAdamW",
           "detector_optimizer", "detector_loss",
           "make_detector_train_step", "make_bucketed_detector_train_step",
           "recall_stats"]

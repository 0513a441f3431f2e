"""Evaluation metrics — the port's own copy of ``mdn_sfm_tpu.metrics``.
Numpy on the host: they run on small eval outputs, not on the hot path."""

from __future__ import annotations

import numpy as np


def binary_image(x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Binarize a probability map."""
    return (x >= threshold).astype(x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32)


def get_quantitative_results(
    pred_mask: np.ndarray, gt_mask: np.ndarray
) -> tuple[float, float, float, float, float]:
    """accuracy / precision / recall / F1 / Dice of binary masks. With no
    positives a division by zero gives nan, silently, as in the reference."""
    pred_mask = np.asarray(pred_mask)
    gt_mask = np.asarray(gt_mask)
    tp = np.sum(np.logical_and(pred_mask == 1, gt_mask == 1))
    tn = np.sum(np.logical_and(pred_mask == 0, gt_mask == 0))
    fp = np.sum(np.logical_and(pred_mask == 1, gt_mask == 0))
    fn = np.sum(np.logical_and(pred_mask == 0, gt_mask == 1))

    with np.errstate(divide="ignore", invalid="ignore"):
        accuracy = (tp + tn) / (tp + tn + fp + fn)
        precision = np.float64(tp) / (tp + fp)
        recall = np.float64(tp) / (tp + fn)
        f1_score = 2 * precision * recall / (precision + recall)
        dice = 2.0 * tp / (2 * tp + fn + fp)

    return float(accuracy), float(precision), float(recall), float(f1_score), float(dice)


def compute_epe(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray) -> float:
    """Masked end-point error between flow fields (H, W, ≥2)."""
    epe = np.sqrt((gt[..., 0] - pred[..., 0]) ** 2 + (gt[..., 1] - pred[..., 1]) ** 2)
    return float(np.sum(epe * mask) / np.sum(mask))


def compute_pose_error(gt: np.ndarray, pred: np.ndarray) -> tuple[float, float]:
    """ATE (after a least-squares scale alignment) and RE over a pose
    snippet; ``gt``, ``pred``: (snippet_len, 3, 4) pose matrices."""
    snippet_length = gt.shape[0]
    scale_factor = np.sum(gt[:, :, -1] * pred[:, :, -1]) / np.sum(pred[:, :, -1] ** 2)
    ate = np.linalg.norm((gt[:, :, -1] - scale_factor * pred[:, :, -1]).reshape(-1))

    re = 0.0
    for gt_pose, pred_pose in zip(gt, pred):
        R = gt_pose[:, :3] @ np.linalg.inv(pred_pose[:, :3])
        s = np.linalg.norm([R[0, 1] - R[1, 0], R[1, 2] - R[2, 1], R[0, 2] - R[2, 0]])
        c = np.trace(R) - 1
        re += np.arctan2(s, c)

    return float(ate / snippet_length), float(re / snippet_length)

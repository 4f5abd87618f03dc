"""nuScenes detection evaluation core: mAP / TP errors / NDS.

A copy of ``stereoscene_tpu/core/nuscenes_eval.py`` (numpy only; the port
imports nothing of the JAX package).

Rebuild of the scoring used by the reference's custom evaluator
(ref: projects/mmdet3d_plugin/datasets/nuscnes_eval.py:507-751, which wraps
the nuScenes devkit's `accumulate`/`calc_ap`/`calc_tp` from
nuscenes.eval.detection.algo — unavailable in this environment, so the
algorithm is implemented here in numpy, bit-faithful to the devkit):

- per-class greedy matching of score-sorted predictions to ground truth by
  2D center distance at thresholds {0.5, 1, 2, 4} m
- 101-point interpolated precision/recall; AP = mean precision over
  recall > 10% after removing the 10% precision floor
- TP errors accumulated cumulatively over matches and averaged over the
  (min_recall, max_recall] interpolation span at the 2.0 m threshold:
  ATE (2D center distance), ASE (1 - aligned 3D IoU), AOE (yaw delta,
  period pi for barriers), AVE (velocity L2)
- NDS = (5 * mAP + sum_tp (1 - min(1, mTP))) / 10

Attribute error (AAE) is computed when boxes carry attribute names
(``with_attributes=True``): AAE = 1 - attribute classification accuracy over
matched TPs whose GT attribute is non-empty (devkit ``attr_acc`` — empty-GT
matches contribute NaN and are skipped, ref nuscnes_eval.py:661 and the
devkit's nan-aware cummean). With attributes the NDS denominator is the full
10 (5 TP metrics); without them AAE is excluded from both the TP list and
the denominator.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

DETECTION_CLASSES = (
    "car", "truck", "bus", "trailer", "construction_vehicle",
    "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
)
DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_REC_POINTS = 101
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err")
TP_METRICS_ATTR = TP_METRICS + ("attr_err",)


@dataclass
class DetBox:
    """One box: translation (x, y, z), size (w, l, h), yaw, velocity
    (vx, vy), detection_name; predictions carry a score."""

    sample_token: str
    translation: np.ndarray
    size: np.ndarray
    yaw: float
    velocity: np.ndarray
    detection_name: str
    score: float = -1.0
    attribute_name: str = ""


@dataclass
class MetricData:
    recall: np.ndarray
    precision: np.ndarray
    confidence: np.ndarray
    trans_err: np.ndarray
    scale_err: np.ndarray
    orient_err: np.ndarray
    vel_err: np.ndarray
    attr_err: np.ndarray = None

    @property
    def max_recall_ind(self) -> int:
        non_zero = np.nonzero(self.confidence)[0]
        return int(non_zero[-1]) if len(non_zero) else 0


def _no_predictions_md() -> MetricData:
    z = np.zeros(N_REC_POINTS)
    o = np.ones(N_REC_POINTS)
    return MetricData(recall=np.linspace(0, 1, N_REC_POINTS), precision=z,
                      confidence=z, trans_err=o, scale_err=o, orient_err=o,
                      vel_err=o, attr_err=o)


def center_distance(a: DetBox, b: DetBox) -> float:
    return float(np.linalg.norm(a.translation[:2] - b.translation[:2]))


def yaw_diff(a: DetBox, b: DetBox, period: float = 2 * np.pi) -> float:
    d = (a.yaw - b.yaw) % period
    return float(min(d, period - d))


def scale_iou(a: DetBox, b: DetBox) -> float:
    """3D IoU of the two boxes after aligning centers and orientation
    (devkit scale_iou)."""
    sa = np.maximum(a.size, 1e-6)
    sb = np.maximum(b.size, 1e-6)
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa)) + float(np.prod(sb)) - inter
    return inter / union


def velocity_l2(a: DetBox, b: DetBox) -> float:
    return float(np.linalg.norm(a.velocity[:2] - b.velocity[:2]))


def attr_acc(gt: DetBox, pred: DetBox) -> float:
    """Devkit attr_acc: NaN when the GT has no attribute (skipped in the
    nan-aware cumulative mean), else exact-match accuracy."""
    if not gt.attribute_name:
        return np.nan
    return float(gt.attribute_name == pred.attribute_name)


def _cummean(x: np.ndarray) -> np.ndarray:
    if len(x) == 0:
        return x
    return np.cumsum(x) / (np.arange(len(x)) + 1)


def accumulate(
    gt_boxes: Sequence[DetBox],
    pred_boxes: Sequence[DetBox],
    class_name: str,
    dist_th: float,
) -> MetricData:
    """Per-class PR curve + cumulative TP errors (devkit accumulate())."""
    gts = [g for g in gt_boxes if g.detection_name == class_name]
    npos = len(gts)
    preds = sorted(
        (p for p in pred_boxes if p.detection_name == class_name),
        key=lambda p: -p.score,
    )
    if npos == 0 or len(preds) == 0:
        return _no_predictions_md()

    gt_by_sample: Dict[str, List[DetBox]] = {}
    for g in gts:
        gt_by_sample.setdefault(g.sample_token, []).append(g)
    taken: Dict[str, set] = {tok: set() for tok in gt_by_sample}

    tp, fp, conf = [], [], []
    err = {k: [] for k in TP_METRICS_ATTR}
    period = np.pi if class_name == "barrier" else 2 * np.pi
    for p in preds:
        best_dist, best_idx = np.inf, None
        for i, g in enumerate(gt_by_sample.get(p.sample_token, [])):
            if i in taken.get(p.sample_token, set()):
                continue
            d = center_distance(p, g)
            if d < best_dist:
                best_dist, best_idx = d, i
        if best_idx is not None and best_dist < dist_th:
            taken[p.sample_token].add(best_idx)
            g = gt_by_sample[p.sample_token][best_idx]
            tp.append(1)
            fp.append(0)
            err["trans_err"].append(best_dist)
            err["scale_err"].append(1.0 - scale_iou(p, g))
            err["orient_err"].append(yaw_diff(p, g, period))
            err["vel_err"].append(velocity_l2(p, g))
            err["attr_err"].append(1.0 - attr_acc(g, p))
        else:
            tp.append(0)
            fp.append(1)
            # devkit appends no error for FPs (cumulative means over TPs
            # only, carried forward by interpolation below)
        conf.append(p.score)

    tp_c = np.cumsum(tp).astype(float)
    fp_c = np.cumsum(fp).astype(float)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / float(npos)
    conf = np.asarray(conf, float)

    rec_interp = np.linspace(0, 1, N_REC_POINTS)
    precision = np.interp(rec_interp, rec, prec, right=0)
    confidence = np.interp(rec_interp, rec, conf, right=0)

    out = {"recall": rec_interp, "precision": precision,
           "confidence": confidence}
    if sum(tp) == 0:
        for k in TP_METRICS_ATTR:
            out[k] = np.ones(N_REC_POINTS)
    else:
        # recall positions of the matches only (devkit: tp errors are
        # cumulative means sampled at the match recalls)
        match_rec = rec[np.asarray(tp, bool)]
        for k in TP_METRICS_ATTR:
            vals = np.asarray(err[k], float)
            keep = ~np.isnan(vals)  # devkit nan-aware cummean (attr_err)
            cm = _cummean(vals[keep])
            out[k] = np.interp(rec_interp, match_rec[keep], cm, right=1.0) \
                if len(cm) else np.ones(N_REC_POINTS)
    return MetricData(**out)


def calc_ap(md: MetricData, min_recall: float = MIN_RECALL,
            min_precision: float = MIN_PRECISION) -> float:
    prec = np.copy(md.precision)
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: MetricData, metric_name: str,
            min_recall: float = MIN_RECALL) -> float:
    first = round(100 * min_recall) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(getattr(md, metric_name)[first: last + 1]))


@dataclass
class DetectionMetrics:
    mean_ap: float = 0.0
    nd_score: float = 0.0
    class_aps: Dict[str, float] = field(default_factory=dict)
    tp_errors: Dict[str, float] = field(default_factory=dict)
    class_tps: Dict[str, Dict[str, float]] = field(default_factory=dict)


def evaluate_detections(
    gt_boxes: Sequence[DetBox],
    pred_boxes: Sequence[DetBox],
    classes: Sequence[str] = DETECTION_CLASSES,
    dist_thresholds: Sequence[float] = DIST_THRESHOLDS,
    dist_th_tp: float = DIST_TH_TP,
    with_attributes: bool = False,
) -> DetectionMetrics:
    """Full detection scoring -> mAP, per-class AP, mTP errors, NDS
    (devkit DetectionEval.evaluate + DetectionMetrics aggregation).
    ``with_attributes=True`` adds AAE to the TP metrics and scores NDS over
    the full 10-point denominator (requires boxes with attribute_name)."""
    tp_list = TP_METRICS_ATTR if with_attributes else TP_METRICS
    metrics = DetectionMetrics()
    ap_sum, ap_count = 0.0, 0
    for cls in classes:
        aps = []
        for th in dist_thresholds:
            md = accumulate(gt_boxes, pred_boxes, cls, th)
            aps.append(calc_ap(md))
        metrics.class_aps[cls] = float(np.mean(aps))
        ap_sum += sum(aps)
        ap_count += len(aps)

        md_tp = accumulate(gt_boxes, pred_boxes, cls, dist_th_tp)
        metrics.class_tps[cls] = {
            k: calc_tp(md_tp, k) for k in tp_list
        }
    metrics.mean_ap = ap_sum / max(ap_count, 1)
    for k in tp_list:
        metrics.tp_errors[k] = float(
            np.mean([metrics.class_tps[c][k] for c in classes])
        )
    tp_scores = [1.0 - min(1.0, metrics.tp_errors[k]) for k in tp_list]
    metrics.nd_score = (5.0 * metrics.mean_ap + sum(tp_scores)) / (
        5.0 + len(tp_list)
    )
    return metrics


def boxes_from_arrays(
    sample_tokens: Sequence[str],
    boxes: np.ndarray,      # [N, >=7] (cx, cy, cz, w, l, h, yaw[, vx, vy])
    labels: np.ndarray,     # [N] int
    scores: Optional[np.ndarray] = None,
    classes: Sequence[str] = DETECTION_CLASSES,
    attributes: Optional[Sequence[str]] = None,
) -> List[DetBox]:
    """Convenience converter from the decoder's array outputs."""
    out = []
    for i in range(len(labels)):
        vel = boxes[i, 7:9] if boxes.shape[1] >= 9 else np.zeros(2)
        out.append(DetBox(
            sample_token=sample_tokens[i],
            translation=np.asarray(boxes[i, :3], float),
            size=np.asarray(boxes[i, 3:6], float),
            yaw=float(boxes[i, 6]),
            velocity=np.asarray(vel, float),
            detection_name=classes[int(labels[i])],
            score=float(scores[i]) if scores is not None else -1.0,
            attribute_name=attributes[i] if attributes is not None else "",
        ))
    return out

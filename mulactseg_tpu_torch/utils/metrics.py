"""Streaming segmentation metrics: the port of mulactseg_tpu/utils/metrics.py.

A confusion matrix (rows GT class, columns prediction) accumulates per
step, on the predictions' device (`_after_step`) or on the host from a map
already fetched there (`_after_step_host`); seen/correct/positive are its
marginals, so IoU, precision and recall come from one state. The
per-class formulas are the reference's (utils/miou.py:57-96), including
the quirk that a class never seen in GT reports IoU 1.
"""

from __future__ import annotations

import numpy as np
import torch

from mulactseg_tpu_torch.parallel import mesh


def confusion_matrix(preds, targets, *, num_classes: int,
                     ignore_label: int) -> torch.Tensor:
    """(C, C) int64 confusion matrix on the predictions' device. A pixel
    counts iff its GT is a class in [0, C) other than ignore_label and its
    prediction is in [0, C) (the JAX one-hot einsum drops the others)."""
    C = num_classes
    p = torch.as_tensor(preds).reshape(-1).long()
    t = torch.as_tensor(targets).to(p.device).reshape(-1).long()
    m = (t != ignore_label) & (t >= 0) & (t < C) & (p >= 0) & (p < C)
    idx = torch.where(m, t * C + p, C * C)  # C * C: the dropped bin
    return torch.bincount(idx, minlength=C * C + 1)[:C * C].reshape(C, C)


class MeanIoU:
    """Streaming per-class IoU with the reference's API shape
    (_before_epoch/_after_step/_after_epoch, utils/miou.py:5-96)."""

    def __init__(self, num_classes: int, ignore_label: int,
                 output_tensor: str = "outputs",
                 target_tensor: str = "targets"):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.output_tensor = output_tensor
        self.target_tensor = target_tensor
        self._before_epoch()

    def _before_epoch(self):
        self.cm = None  # device confusion matrix, made at the first step
        self.cm_host = np.zeros((self.num_classes, self.num_classes),
                                np.int64)
        self.extra_positive = np.zeros(self.num_classes, np.float64)

    def _add(self, cm):
        self.cm = cm if self.cm is None else self.cm + cm.to(self.cm.device)

    def _after_step_host(self, preds, targets):
        """Numpy twin of confusion_matrix, for a prediction map already on
        the host (the plbl generator fetches every map to save it)."""
        C = self.num_classes
        p = np.asarray(preds).reshape(-1).astype(np.int64)
        t = np.asarray(targets).reshape(-1).astype(np.int64)
        m = (t != self.ignore_label) & (t >= 0) & (t < C) & (p >= 0) & (p < C)
        self.cm_host = self.cm_host + np.bincount(
            t[m] * C + p[m], minlength=C * C).reshape(C, C)

    def _after_step(self, output_dict):
        self._add(confusion_matrix(
            output_dict[self.output_tensor], output_dict[self.target_tensor],
            num_classes=self.num_classes, ignore_label=self.ignore_label))

    def _after_step_within_predregion(self, output_dict):
        """Accumulate only over pixels the prediction labelled
        (pred != ignore_label); GT-ignore pixels still count into the
        positive (prediction) marginal (utils/miou.py:40-55)."""
        C = self.num_classes
        preds = torch.as_tensor(output_dict[self.output_tensor]).long()
        targets = torch.as_tensor(output_dict[self.target_tensor]).to(
            preds.device).long()
        pred_valid = preds != self.ignore_label
        self._add(confusion_matrix(
            torch.where(pred_valid, preds, C + 1), targets, num_classes=C,
            ignore_label=self.ignore_label))
        # rows with GT == ignore vanish from the matrix: count their
        # predictions separately to keep the positive marginal right
        p = preds.reshape(-1)
        extra = (pred_valid & (targets == self.ignore_label)).reshape(-1) \
            & (p >= 0) & (p < C)
        self.extra_positive = self.extra_positive + torch.bincount(
            p[extra], minlength=C)[:C].cpu().numpy().astype(np.float64)

    def confusion(self) -> np.ndarray:
        """The (C, C) int64 confusion matrix counted so far."""
        cm = self.cm_host.copy()
        if self.cm is not None:
            cm += self.cm.cpu().numpy()
        return cm

    def all_reduce(self, device) -> None:
        """Under a process group, sum the confusion matrix and the extra
        positives over the ranks (collectives on `device`, the rank's),
        so that every rank's marginals count every rank's steps."""
        if not mesh.active():
            return
        self.cm = mesh.all_reduce_sum(
            torch.from_numpy(self.confusion()).to(device))
        self.cm_host = np.zeros_like(self.cm_host)
        self.extra_positive = mesh.all_reduce_sum(torch.from_numpy(
            self.extra_positive).to(device)).cpu().numpy()

    def _marginals(self):
        cm = self.cm_host.astype(np.float64)
        if self.cm is not None:
            cm = cm + self.cm.cpu().numpy()
        seen = cm.sum(1)
        positive = cm.sum(0) + self.extra_positive
        correct = np.diag(cm)
        return seen, correct, positive

    def _after_epoch(self, ignore_label_list=None):
        seen, correct, positive = self._marginals()
        ious = []
        for i in range(self.num_classes):
            if ignore_label_list is not None and i in ignore_label_list:
                continue
            if seen[i] == 0:
                ious.append(1.0)
            else:
                ious.append(correct[i] / (seen[i] + positive[i] - correct[i]))
        return [v * 100 for v in ious]

    def _after_epoch_ipr(self):
        seen, correct, positive = self._marginals()
        ious, precs, recs = [], [], []
        for i in range(self.num_classes):
            if seen[i] == 0:
                ious.append(1.0)
                precs.append(1.0)
                recs.append(1.0)
            else:
                ious.append(correct[i] / (seen[i] + positive[i] - correct[i]))
                precs.append(correct[i] / positive[i] if positive[i] else 0.0)
                recs.append(correct[i] / seen[i])
        return ([v * 100 for v in ious], [v * 100 for v in precs],
                [v * 100 for v in recs])


class IoUIgnore:
    """IoU of the model's "undefined" prediction (class index C) against
    GT-ignore regions (utils/miou_evalignore.py:8-62)."""

    def __init__(self, num_classes: int, ignore_label: int):
        self.num_classes = num_classes  # undefined channel index
        self.ignore_label = ignore_label
        self._before_epoch()

    def _before_epoch(self):
        self.seen = 0
        self.correct = 0
        self.positive = 0

    def _after_step(self, output_dict):
        preds = torch.as_tensor(output_dict["outputs"]).reshape(-1)
        targets = torch.as_tensor(output_dict["targets"]).to(
            preds.device).reshape(-1)
        is_ignore = targets == self.ignore_label
        is_pred = preds == self.num_classes
        self.seen += int(is_ignore.sum())
        self.positive += int(is_pred.sum())
        self.correct += int((is_ignore & is_pred).sum())

    def all_reduce(self, device) -> None:
        """Under a process group, sum the counts over the ranks."""
        if not mesh.active():
            return
        counts = mesh.all_reduce_sum(torch.tensor(
            [self.seen, self.positive, self.correct], dtype=torch.int64,
            device=device))
        self.seen, self.positive, self.correct = (int(v) for v in counts)

    def _after_epoch(self):
        if self.seen == 0:
            return 100.0
        denom = self.seen + self.positive - self.correct
        return (self.correct / denom) * 100 if denom else 0.0

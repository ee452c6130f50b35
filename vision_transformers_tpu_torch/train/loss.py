"""Classification losses (counterpart of ``vision_transformers_tpu/train/
loss.py``; reference: loss.py:6-86).

True KL divergence, as the reference's ``F.kl_div`` and the JAX package
(loss.py:45-49): it differs from cross-entropy by the target entropy, a
constant in the parameters, so logged losses compare across the three.
All math in float32.  The DINO loss, its teacher center and temperature
schedule are the JAX package's (loss.py:102-157; reference loss.py:89-151).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["label_smoothing_loss", "mix_loss", "cross_entropy_loss", "dino_loss",
           "update_center", "teacher_temperature_schedule"]


def _smooth_targets(labels: torch.Tensor, n_class: int, eps: float) -> torch.Tensor:
    """eps/n_class everywhere, 1 − eps + eps/n_class at the label."""
    off = eps / n_class
    on = 1.0 - eps + off
    return F.one_hot(labels.long(), n_class).float() * (on - off) + off


def _kl_div(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Σ_i t_i (log t_i − log p_i) per sample, with 0·log 0 = 0."""
    t = targets
    tlogt = torch.where(t > 0, t * torch.log(torch.clamp(t, min=1e-20)),
                        torch.zeros_like(t))
    return (tlogt - t * log_probs).sum(-1)


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def label_smoothing_loss(logits, labels, eps: float = 0.1, reduction: str = "mean"):
    """Label-smoothed KL loss (reference: loss.py:6-50)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _reduce(_kl_div(logp, _smooth_targets(labels, logits.shape[-1], eps)),
                   reduction)


def cross_entropy_loss(logits, labels, reduction: str = "mean"):
    """Plain CE (the reference's valid-loop criterion, train.py:155,352)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _reduce(loss, reduction)


def mix_loss(logits, target1, target2, ratio, eps: float = 0.0,
             reduction: str = "mean"):
    """Mixup/CutMix loss (reference: loss.py:53-86): KL against
    ``ratio · smooth(target1) + (1 − ratio) · smooth(target2)``."""
    n_class = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    r = torch.as_tensor(ratio, dtype=torch.float32, device=logits.device)[..., None]
    target = r * _smooth_targets(target1, n_class, eps) \
        + (1.0 - r) * _smooth_targets(target2, n_class, eps)
    return _reduce(_kl_div(logp, target), reduction)


# ---------------------------------------------------------------------------
# DINO (reference: loss.py:89-151)
# ---------------------------------------------------------------------------


def teacher_temperature_schedule(warmup_temp: float, temp: float,
                                 warmup_epochs: int, n_epoch: int) -> list:
    """Per-epoch teacher temperature (reference: loss.py:113-122): a linear
    warmup over ``warmup_epochs``, then ``temp``."""
    if warmup_epochs <= 1:
        warm = [warmup_temp] * warmup_epochs
    else:
        warm = [warmup_temp + (temp - warmup_temp) * i / (warmup_epochs - 1)
                for i in range(warmup_epochs)]
    return warm + [temp] * (n_epoch - warmup_epochs)


def dino_loss(student_out: torch.Tensor, teacher_out: torch.Tensor,
              center: torch.Tensor, teacher_temp: float, n_crop: int,
              student_temp: float = 0.1) -> torch.Tensor:
    """DINO cross-entropy over (teacher global, student crop) pairs
    (reference loss.py:124-142): the teacher's probabilities centred and
    sharpened, no gradient; every pair (i_q, v) with v ≠ i_q contributes
    mean_b(−Σ q · log_softmax(student_v)), and the loss is their mean.
    student_out [n_crop·B, K], teacher_out [2·B, K], center [1, K]."""
    chunks = (student_out.float() / student_temp).chunk(n_crop)
    q = torch.softmax((teacher_out.float() - center) / teacher_temp, dim=-1).detach()
    logps = [torch.log_softmax(c, dim=-1) for c in chunks]
    total, n_terms = 0.0, 0
    for i_q, tq in enumerate(q.chunk(2)):
        for v, logp in enumerate(logps):
            if v != i_q:
                total = total + (-tq * logp).sum(-1).mean()
                n_terms += 1
    return total / n_terms


def update_center(center: torch.Tensor, teacher_out: torch.Tensor,
                  momentum: float = 0.9) -> torch.Tensor:
    """EMA of the teacher's batch mean (reference: loss.py:144-151; one
    device, so no all-reduce)."""
    batch_center = teacher_out.detach().float().mean(0, keepdim=True)
    return center * momentum + batch_center * (1.0 - momentum)

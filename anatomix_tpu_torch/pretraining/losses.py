"""Supervised patch contrastive (SupPatchNCE) loss, in f32.

The port of `anatomix_tpu/pretraining/losses.py` (the reference's
`SupPatchNCELoss`): cosine-similarity Gram matrix over the 2P sampled patch
embeddings of the two views, temperature scaling, row-max stabilization,
self-contrast masking, positives = same segmentation label (both views
share the subject's labels, so the (P, P) same-label mask tiles to
(2P, 2P)), with optional rarity weighting (inverse class counts as anchor
weights) and the balanced denominator (a per-class log-weighted
logsumexp); `weighting_mode='sqrt'` softens both.
"""

from __future__ import annotations

import torch


def sup_patch_nce_loss(
    features: torch.Tensor,  # (2, P, C) projector outputs (unnormalized)
    labels: torch.Tensor,  # (P,) integer class of each sampled voxel
    *,
    temperature: float = 0.07,
    weigh_rarity: bool = False,
    balance_denominator: bool = False,
    weighting_mode: str = "raw",
) -> torch.Tensor:
    n_views, P, C = features.shape
    n = n_views * P
    feat = features.reshape(n, C).float()
    feat = feat / feat.norm(dim=-1, keepdim=True).clamp_min(1e-8)

    logits = (feat @ feat.t()) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()

    labels2 = labels.reshape(-1).repeat(n_views)  # (2P,)
    same_class = (labels2[:, None] == labels2[None, :]).float()
    class_counts = same_class.sum(dim=1)  # includes self, >= n_views

    logits_mask = 1.0 - torch.eye(n, device=feat.device)
    mask_pos = same_class * logits_mask
    neg_inf = torch.tensor(float("-inf"), device=feat.device)

    if balance_denominator:
        # weight each contrast item by the inverse size of its own class
        # (self excluded), so every class contributes equal repulsion mass
        n_per_class = class_counts[None, :] - same_class
        if weighting_mode == "sqrt":
            n_per_class = n_per_class.sqrt()
        log_w = torch.where(logits_mask > 0,
                            -n_per_class.clamp_min(1e-12).log(), neg_inf)
        log_denom = torch.logsumexp(logits + log_w, dim=1, keepdim=True)
    else:
        masked = torch.where(logits_mask > 0, logits, neg_inf)
        log_denom = torch.logsumexp(masked, dim=1, keepdim=True)

    log_prob = logits - log_denom
    mean_log_prob_pos = ((mask_pos * log_prob).sum(dim=1)
                         / mask_pos.sum(dim=1).clamp_min(1.0))
    loss = -mean_log_prob_pos

    if weigh_rarity:
        counts = (class_counts.sqrt() if weighting_mode == "sqrt"
                  else class_counts)
        w = 1.0 / counts
        return (w * loss).sum() / w.sum()
    return loss.mean()

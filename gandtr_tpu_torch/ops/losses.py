"""Metric-learning losses (counterpart of gandtr_tpu/ops/losses.py) over
(D, N) descriptor columns, the reference's layout."""
import torch


def contrastive_loss(x, label, num_tuples, margin=0.7, eps=1e-6):
    """Contrastive loss over tuple columns, sum reduction (the reference's
    cirtorch functional.py:141-157). x: (D, N), N = num_tuples * S columns;
    label: (N,), -1 the query, 1 a positive, 0 a negative. The query of each
    tuple is its first column. `eps` is added to the difference inside the
    distance, as the reference does, not to the norm."""
    D, N = x.shape
    S = N // num_tuples
    x = x.T.reshape(num_tuples, S, D)
    dif = x[:, :1, :] - x[:, 1:, :]
    lbl = label.reshape(num_tuples, S)[:, 1:].to(x.dtype)
    dist = torch.sqrt(((dif + eps) ** 2).sum(dim=-1))
    y = 0.5 * lbl * dist ** 2 \
        + 0.5 * (1 - lbl) * torch.clamp(margin - dist, min=0.0) ** 2
    return y.sum()

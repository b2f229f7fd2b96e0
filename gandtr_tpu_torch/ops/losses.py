"""Losses (counterpart of gandtr_tpu/ops/losses.py): the contrastive and
triplet losses over (D, N) descriptor columns, the reference's layout,
the GAN losses with the reference's inverted adversarial targets (real ->
0, fake -> 1, compound_losses.py:47-50), and CUT's PatchNCE
(compound_losses.py:113-173)."""
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


def triplet_loss(x, label, num_tuples, margin=0.1):
    """Triplet loss over tuple columns, sum reduction (the reference's
    cirtorch functional.py:160-173). x: (D, N); each tuple is (anchor,
    positive, S-2 negatives); `label` only fixes the layout."""
    D, N = x.shape
    S = N // num_tuples
    x = x.T.reshape(num_tuples, S, D)
    dist_pos = ((x[:, :1, :] - x[:, 1:2, :]) ** 2).sum(dim=-1)
    dist_neg = ((x[:, :1, :] - x[:, 2:, :]) ** 2).sum(dim=-1)
    return torch.clamp(dist_pos - dist_neg + margin, min=0.0).sum()


def l1_loss(x, target):
    """Mean absolute error. Its subgradient at a tie is 0, torch's: the
    HED^N-GAN student starts equal to its teacher, so the first step's
    differences are exactly 0 and must take no gradient (the JAX package
    routes ties explicitly; `torch.abs` gives 0 there itself)."""
    return torch.abs(x - target).mean()


def mse_loss(x, target):
    return ((x - target) ** 2).mean()


def adversarial_target(like, is_target_real):
    """The constant target map: 0.0 for "real", 1.0 for "fake"."""
    return torch.full_like(like, float(not is_target_real))


def discriminator_loss(output, is_target_real, criterion=mse_loss):
    """(total, partial) of `criterion` against the constant target map; a
    list of outputs (multiscale discriminators) sums, with each in
    `partial` under layer<k>, the last output as layer0."""
    if isinstance(output, (list, tuple)):
        partial, total = {}, 0.0
        for i, y in enumerate(output):
            key = "layer%d" % (len(output) - 1 - i)
            partial[key] = criterion(y, adversarial_target(y, is_target_real))
            total = total + partial[key]
        return total, partial
    return criterion(output, adversarial_target(output, is_target_real)), {}


def patch_nce_loss(feat_q, feat_k, batch_dim_for_bmm=1, temperature=0.07,
                   query_offset=None):
    """PatchNCE per patch, no reduction. feat_q, feat_k: (P, dim) sampled
    features of the same P positions; the key takes no gradient. Each
    query's positive is its own key, its negatives the other keys of its
    bmm batch (the diagonal there set to -10); cross entropy to class 0
    of the logits over `temperature`. Returns (P,).

    With `query_offset` (a data-parallel step), feat_k holds the keys of
    the whole global batch and feat_q the queries of rows [query_offset,
    query_offset + P_q) of it: each query takes its negatives from its bmm
    batch of the global keys. Returns (P_q,)."""
    dim = feat_q.shape[1]
    feat_k = feat_k.detach()
    if query_offset is not None:
        return _patch_nce_rows(feat_q, feat_k, batch_dim_for_bmm,
                               temperature, query_offset)
    l_pos = (feat_q * feat_k).sum(dim=1, keepdim=True)
    fq = feat_q.reshape(batch_dim_for_bmm, -1, dim)
    fk = feat_k.reshape(batch_dim_for_bmm, -1, dim)
    n = fq.shape[1]
    l_neg = torch.bmm(fq, fk.transpose(1, 2))
    diag = torch.eye(n, dtype=torch.bool, device=l_neg.device)[None]
    l_neg = l_neg.masked_fill(diag, -10.0).reshape(-1, n)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return -torch.log_softmax(logits, dim=1)[:, 0]


def _patch_nce_rows(feat_q, feat_k, batch_dim_for_bmm, temperature, offset):
    """patch_nce_loss for the queries of global rows [offset, offset +
    P_q) against the global keys: the logits of each query against all
    keys, then its own bmm batch's columns."""
    P = feat_k.shape[0]
    group = P // batch_dim_for_bmm
    rows = offset + torch.arange(feat_q.shape[0], device=feat_q.device)
    l_pos = (feat_q * feat_k[rows]).sum(dim=1, keepdim=True)
    cols = (rows // group * group)[:, None] + torch.arange(
        group, device=feat_q.device)[None]
    l_neg = torch.gather(feat_q @ feat_k.T, 1, cols)
    l_neg = l_neg.masked_fill(cols == rows[:, None], -10.0)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return -torch.log_softmax(logits, dim=1)[:, 0]


def multilayer_patch_nce_loss(feats_q, feats_k, batch_dim_for_bmm=1,
                              temperature=0.07, weight=1.0,
                              query_block=None):
    """(total, partial): each tap's mean PatchNCE times `weight`, under
    layer<i>, and their mean over the taps. With `query_block` r (a
    data-parallel step), each tap's keys are the global batch's and its
    queries block r of it (patch_nce_loss's `query_offset` r P_q)."""
    partial = {}
    for i, (fq, fk) in enumerate(zip(feats_q, feats_k)):
        offset = None if query_block is None else query_block * fq.shape[0]
        partial["layer%d" % i] = (patch_nce_loss(
            fq, fk, batch_dim_for_bmm, temperature, offset)
            * weight).mean()
    return sum(partial.values()) / len(partial), partial

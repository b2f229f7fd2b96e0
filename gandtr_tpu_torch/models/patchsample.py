"""PatchSampleF, CUT's feature sampler (counterpart of
gandtr_tpu/models/patchsample.py; the reference's p2p_networks.py:607-671,
`official_p2p_mlp`).

For each of the generator's feature taps (NHWC maps): the features at
sampled positions, through a 2-layer MLP (C -> nc -> ReLU -> nc) of its
own, L2-normalised. The query and key passes share the positions: the
key pass draws them, the query pass is given them back.

The MLPs are made once the taps' channel counts are known
(`create_mlp`, from the generator's taps on a sample input), and carry
the reference's names (`mlp_<i>.0`, `mlp_<i>.2`). Positions are drawn by
`torch.randperm` on the CPU from the `torch.Generator` passed in, never the
global one, so the card and the CPU draw the same ones; `patch_ids=`
gives them instead (a list of index arrays, one a tap).

`num_patches == 0` is the full-map mode: every position, normalised over
the spatial axis, as the reference's Normalize does there.
"""
import torch
from torch import nn


def _safe_norm(x, dim):
    """sqrt(sum(x**2)) with a finite gradient at an all-zero row; the same
    forward value as the reference's x.pow(2).sum().pow(.5) elsewhere."""
    s = (x * x).sum(dim=dim, keepdim=True)
    pos = s > 0
    return torch.where(pos, torch.where(pos, s, torch.ones_like(s)) ** 0.5,
                       torch.zeros_like(s))


class PatchSampleF(nn.Module):

    def __init__(self, nc=256):
        super().__init__()
        self.nc = int(nc)
        self.n_mlps = 0

    def create_mlp(self, channels):
        """One MLP per tap, for taps of `channels` channels."""
        for i, c in enumerate(channels):
            setattr(self, "mlp_%d" % i, nn.Sequential(
                nn.Linear(int(c), self.nc), nn.ReLU(),
                nn.Linear(self.nc, self.nc)))
        self.n_mlps = len(channels)
        return self

    def forward(self, feats, num_patches=64, patch_ids=None, generator=None):
        """feats: list of (B, H, W, C) maps. Returns (samples, ids): each
        sample (B * n, nc) normalised, n = min(num_patches, H * W), or
        (B, H, W, nc) in the full-map mode; ids the positions, one index
        tensor a tap on the maps' device."""
        if self.n_mlps != len(feats):
            raise ValueError("PatchSampleF has %d MLPs for %d taps (call "
                             "create_mlp first)" % (self.n_mlps, len(feats)))
        out_feats, out_ids = [], []
        for i, feat in enumerate(feats):
            B, H, W, C = feat.shape
            flat = feat.reshape(B, H * W, C)
            if num_patches > 0:
                if patch_ids is not None:
                    ids = torch.as_tensor(patch_ids[i], dtype=torch.long)
                else:
                    ids = torch.randperm(H * W, generator=generator)[
                        :min(num_patches, H * W)]
                ids = ids.to(feat.device, non_blocking=True)
                sample = flat.index_select(1, ids).reshape(-1, C)
            else:
                ids = torch.zeros(0, dtype=torch.long, device=feat.device)
                sample = flat.reshape(-1, C)
            sample = getattr(self, "mlp_%d" % i)(sample)
            if num_patches == 0:
                sample = sample.reshape(B, H * W, -1)
                sample = (sample / (_safe_norm(sample, 1) + 1e-7)) \
                    .reshape(B, H, W, -1)
            else:
                sample = sample / (_safe_norm(sample, -1) + 1e-7)
            out_feats.append(sample)
            out_ids.append(ids)
        return out_feats, out_ids

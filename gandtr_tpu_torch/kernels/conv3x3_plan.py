"""The tile plan of the 3x3 implicit-GEMM conv core that K2 and K3 share
(csrc/conv3x3_igemm.cuh: `Plan` and `geometry`), on the host.

A CTA computes a TH x TW-pixel tile of one image by BN output channels,
BN = 64 for C <= 64, else 128 (more channels take several channel tiles),
with the two consumer warpgroups' accumulators at 128 float32 registers a
thread:

    BN = 128: 8 x 32 pixels    BN = 64: 16 x 32

The K loop runs over 64-channel chunks of the input and the 9 taps of each.
K3's wrapper sizes its per-tile statistics buffer from `geometry`; the CPU
tests emulate the core's tiling from it. The library checks the tile count
it is given against its own plan.
"""
from collections import namedtuple

CONSUMERS = 2   # consumer warpgroups a CTA
KC = 64         # input channels a K chunk
TW = 32         # tile width in pixels

Plan = namedtuple("Plan", "bn th tw")
Geometry = namedtuple("Geometry", "tiles_y tiles_x co_tiles nchunks")


def plan(C):
    """The tile of the core's instance for C channels."""
    bn = 64 if C <= 64 else 128
    return Plan(bn, 64 * (256 // bn) * CONSUMERS // TW, TW)


def geometry(H, W, C):
    """Tiles of one image, output-channel tiles and K chunks."""
    p = plan(C)
    return Geometry(-(-H // p.th), -(-W // p.tw), -(-C // p.bn), -(-C // KC))

"""Operations and bytes of the port's hand-written kernels at a cell's
shapes, by hand from the shapes (the arithmetic of chip_smoke.py
`kernel_cases` and `phase_mrf_kernels`): each input byte read once and
each output byte written once.

  K1 block attention on [n, s, e] tokens (QK^T and PV over all heads):
     4 n s^2 e operations; q, k, v in and the output: 4 n s e elements.
  K5 ID-MRF on o, t [n, p, c]: the forward's cos product 2 n p^2 c, its
     inputs 2 n p c elements and its statistics n p (4 + 4 + 8 + 4 + 8)
     bytes (m, z, p*, K, q*); do and dt each 4 n p^2 c (the cos product
     again and the dcos product), inputs and output 3 n p c elements plus
     the same statistics.
"""

from __future__ import annotations

MRF_STAT_BYTES = 4 + 4 + 8 + 4 + 8
# ID-MRF taps: (VGG19 relu, its downsampling, channels)
MRF_LAYERS = (("relu3_1", 4, 256), ("relu4_1", 8, 512))


def attention_work(n: int, s: int, e: int, item: int) -> tuple:
    return 4.0 * n * s * s * e, 4.0 * n * s * e * item


def mrf_calls(batch: int, side: int, item: int) -> list:
    """(flops, bytes) of each K5 launch of one ID-MRF loss and its
    backward: forward, do, dt at relu3_1 and at relu4_1."""
    calls = []
    for _, down, c in MRF_LAYERS:
        n, p = batch, (side // down) ** 2
        stats = n * p * MRF_STAT_BYTES
        calls.append((2.0 * n * p * p * c, 2.0 * n * p * c * item + stats))
        calls += [(4.0 * n * p * p * c, 3.0 * n * p * c * item + stats)] * 2
    return calls

"""Device ms per step of the convolution group (cuDNN: the generator's,
VGG19's, the Ds' and SSIM's convolutions and their backward)."""

from benchmark.trace import group_s


def read(summary, work):
    s = group_s(summary, "convolution (cuDNN)")
    return 1e3 * s / summary["count"] if s > 0 else None

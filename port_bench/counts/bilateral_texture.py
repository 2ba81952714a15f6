"""Work of one bilateral texture filter call, from its parameters and the
frame's shape alone.  Operations per pixel and iteration, stage by stage:
the gradient 19 (3 channels × 6, a root); box blur and mRTV k² + 12k + 10;
the guide 4k + 20; the joint filter 8 a nonzero tap of its (2k − 1, k − 1)
window + 6.  Bytes: the input frame read once and the output written once;
no intermediate buffer is counted, so fusing stages leaves the count as it is."""

from port_bench.counts.bilateral import nonzero_taps


def stage_ops(ksize: int) -> dict[str, int]:
    """Operations per pixel of each stage of one iteration."""
    return {"gradient": 3 * 6 + 1,
            "blur_rtv": ksize * ksize + 12 * ksize + 10,
            "guide": 4 * ksize + 20,
            "joint_bilateral": 8 * nonzero_taps(2 * ksize - 1, float(ksize - 1)) + 6}


def work(kwargs: dict, height: int, width: int, channels: int) -> tuple[float, float]:
    """(operations, bytes) of one call."""
    pixels = height * width
    per_pixel = kwargs["nitr"] * sum(stage_ops(kwargs["ksize"]).values())
    return float(pixels * per_pixel), float(2 * pixels * channels)
